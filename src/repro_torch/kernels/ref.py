"""Plain PyTorch versions of the port's kernels (f32 accumulation).

The CPU path runs these, the tests hold them against ``repro.kernels.ref``
and the Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  On a CUDA device the main path never calls them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import split_engine
from repro_torch.kernels.pearsonr import pearson_r_from_sums, pearson_sums


def xty(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``XᵀY`` in f32.  (n, p), (n, q) → (p, q)."""
    return torch.matmul(x.T.float(), y.float())


def gram(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` in f32.  (n, p) → (p, p)."""
    return xty(x, x)


def xty_folds(x: torch.Tensor, y: torch.Tensor,
              bounds: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Per-fold ``out[f] = X[lo:hi]ᵀ Y[lo:hi]`` in f32.  → (k, p, q)."""
    return torch.stack([xty(x[lo:hi], y[lo:hi]) for lo, hi in bounds])


def xty_folds_masked(x: torch.Tensor, z: torch.Tensor,
                     onehot: torch.Tensor) -> torch.Tensor:
    """Per-slot masked ``out[s] = (x · onehot[:, s])ᵀ z`` in f32.

    The reference's XLA formula (``repro/core/foldstats.py:241-244``): the
    masked operand ``(s, m, p)`` is built, then contracted over rows.
    x: (m, p), z: (m, q), onehot: (m, s) → (s, p, q).
    """
    xw = x.float()[None] * onehot.float().T[:, :, None]
    return torch.einsum("smp,mq->spq", xw, z.float())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Dense-materialised attention, as the reference's oracle
    (``repro/kernels/ref.py:29``): scores, softcap, mask, softmax and the
    value product in f32.  q (BH, S, K) pre-scaled; k/v (BH, T, K) →
    (BH, S, K) in q's dtype.  The (S, T) scores of a few heads at a time
    are materialised (at most 2²⁸ elements, 1 GiB of f32)."""
    bh, S, _ = q.shape
    T = k.shape[1]
    dist = (torch.arange(S, device=q.device)[:, None]
            - torch.arange(T, device=q.device)[None, :])
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= dist >= 0
    if window is not None:
        mask &= dist < window
    out = torch.empty_like(q)
    step = max(1, (1 << 28) // (S * T))
    for lo in range(0, bh, step):
        hi = min(lo + step, bh)
        s = torch.einsum("hsk,htk->hst", q[lo:hi].float(), k[lo:hi].float())
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        p = torch.softmax(torch.where(mask[None], s, -1e30), dim=-1)
        out[lo:hi] = torch.einsum("hst,htk->hsk", p, v[lo:hi].float()
                                  ).to(q.dtype)
    return out


def bf16_split3(p: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 flash kernel's split of f32 probabilities into three bf16
    terms, each cut to its top 16 bits (bf16 rounded toward zero):
    ``p₁`` of ``p``, ``p₂`` of ``p − p₁``, ``p₃`` of ``p − p₁ − p₂``, the
    residuals taken in f32, where they are exact.  ``p₁ + p₂ + p₃ == p``
    exactly, since 3 × 8 significand bits cover f32's 24, unless ``p₃``
    would need bits below bf16's smallest subnormal, 2⁻¹³³ (p < 2⁻¹¹⁰);
    so each ``pᵢ·v`` for a bf16 ``v`` is exact in f32, and three bf16
    products give the f32 ``p·v``."""
    def top16(x: torch.Tensor) -> torch.Tensor:
        return (x.view(torch.int32) & -65536).view(torch.float32)

    p = p.float().contiguous()
    p1 = top16(p)
    r1 = p - p1
    p2 = top16(r1)
    p3 = top16(r1 - p2)
    # Each term's low 16 bits are zero, so these casts are exact.
    return (p1.to(torch.bfloat16), p2.to(torch.bfloat16),
            p3.to(torch.bfloat16))


def split_product(a: torch.Tensor, b: torch.Tensor, na: int,
                  nb: int) -> torch.Tensor:
    """The split-bf16 engine's arithmetic, plain: ``a`` (K, M) and ``b``
    (K, N), f32 values after their scale, are cut into ``na`` and ``nb``
    terms by ``bf16_split3``; each kept pair's product ``aᵢᵀ·bⱼ``
    (``split_engine.pairs``) is computed in f32, where each term product
    is exact, and the products are summed in f32 → (M, N).  For the tests
    and ``chip_smoke.py``; no main path calls it."""
    ta = bf16_split3(a)[:na]
    tb = bf16_split3(b)[:nb]
    out = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for i, j in split_engine.pairs(na, nb):
        out += torch.matmul(ta[i].float().T, tb[j].float())
    return out


def xty_folds_masked_split(x: torch.Tensor, z: torch.Tensor,
                           onehot: torch.Tensor) -> torch.Tensor:
    """``xty_folds_masked`` by the engine's arithmetic: the slots stacked
    as the columns of ``x·w_s`` (scaled in f32, as ``xty_folds_masked``),
    split by ``split_engine.masked_planes`` → (s, p, q) f32."""
    m, p = x.shape
    s = onehot.shape[1]
    na, nb = split_engine.masked_planes(x.dtype)
    xw = x.float()[None] * onehot.float().T[:, :, None]          # (s, m, p)
    a = xw.permute(1, 0, 2).reshape(m, s * p)
    return split_product(a, z.float(), na, nb).reshape(s, p, z.shape[1])


def xty_folds_split(x: torch.Tensor, y: torch.Tensor,
                    bounds: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``xty_folds`` by the engine's arithmetic: per fold, ``x[lo:hi]`` and
    ``y[lo:hi]`` split by ``split_engine.folds_planes`` → (k, p, q) f32; an
    empty fold is zero."""
    na, nb = split_engine.folds_planes(x.dtype)
    return torch.stack([split_product(x[lo:hi].float(), y[lo:hi].float(),
                                      na, nb) for lo, hi in bounds])


def split_ranges(n: int, rows: int) -> list[tuple[int, int]]:
    """The K ranges of ``xty``'s split-K: runs of ``rows`` rows (the last
    takes the rest) covering ``[0, n)``; ``[(0, n)]`` where ``rows`` is 0
    (``gram.row_splits``' one range)."""
    if rows <= 0 or rows >= n:
        return [(0, n)]
    return [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]


def xty_split(x: torch.Tensor, y: torch.Tensor, rows: int) -> torch.Tensor:
    """``xty`` by the engine's arithmetic: per K range of ``rows`` rows
    (``gram.row_splits``; 0 for one range), ``x[lo:hi]`` and ``y[lo:hi]``
    split by ``split_engine.folds_planes`` and their kept pairs' products
    summed (``xty_folds_split``), then the partials added in split order,
    as ``xty``'s sum kernel does → (p, q) f32."""
    parts = xty_folds_split(x, y, split_ranges(x.shape[0], rows))
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


def solve_lambda_grid_split(q: torch.Tensor, evals: torch.Tensor,
                            a: torch.Tensor,
                            lambdas: torch.Tensor) -> torch.Tensor:
    """``solve_lambda_grid`` by the engine's arithmetic: ``A`` scaled by
    the f32 reciprocals (as ``solve_lambda_grid``), the λ index folded
    into its columns, split by ``split_engine.solve_planes`` → (r, p, t)
    f32."""
    p, t = a.shape
    r = lambdas.shape[0]
    na, nb = split_engine.solve_planes(q.dtype)
    scale = 1.0 / (evals.float()[None, :] + lambdas.float()[:, None])
    scaled = a.float()[None, :, :] * scale[:, :, None]           # (r, p, t)
    b = scaled.permute(1, 0, 2).reshape(p, r * t)
    out = split_product(q.float().T, b, na, nb)                  # (p, r·t)
    return out.reshape(p, r, t).permute(1, 0, 2).contiguous()


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_kv: int,
              *, causal: bool = True, window: int | None = None,
              softcap: float | None = None) -> torch.Tensor:
    """Model layout, as the reference's ``mha_flash``: q (B, S, H, K),
    k/v (B, T, n_kv, K), query head h reads kv head h // (H / n_kv) →
    (B, S, H, K)."""
    b, s, h, kd = q.shape
    t = k.shape[1]
    g = h // n_kv
    k = torch.repeat_interleave(k, g, dim=2)
    v = torch.repeat_interleave(v, g, dim=2)
    qf = q.permute(0, 2, 1, 3).reshape(b * h, s, kd)
    kf = k.permute(0, 2, 1, 3).reshape(b * h, t, kd)
    vf = v.permute(0, 2, 1, 3).reshape(b * h, t, kd)
    out = flash_attention(qf, kf, vf, causal=causal, window=window,
                          softcap=softcap)
    return out.reshape(b, h, s, kd).permute(0, 2, 1, 3)


def ssd_intra(cb: torch.Tensor, la: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Mamba2 SSD within-chunk term, dense, as the reference's oracle
    (``repro/kernels/ref.py:62``):
    ``y[n,q,h,p] = Σ_{k≤q} exp(la[n,q,h] − la[n,k,h])·cb[n,q,k]·x[n,k,h,p]``.
    cb (N, Q, Q), la (N, Q, H), x (N, Q, H, P) → (N, Q, H, P) f32; the
    (N, Q, Q, H) decay is materialised."""
    cb, la, x = cb.float(), la.float(), x.float()
    q = cb.shape[1]
    diff = la[:, :, None, :] - la[:, None, :, :]        # (N,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=cb.device))[None, :, :, None]
    decay = torch.exp(torch.where(mask, diff, -torch.inf))
    return torch.einsum("nqkh,nkhp->nqhp", decay * cb[:, :, :, None], x)


def ssd_intra_split(cb: torch.Tensor, la: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """``ssd_intra`` by the tensor-core kernel's arithmetic: the masked
    ``L[n,q,k,h] = exp(la_q − la_k)·cb[q,k]`` in f32, as ``ssd_intra``
    forms it, and ``x`` are cut into bf16 terms by ``bf16_split3`` (three
    of ``L``; three of an f32 ``x``, one of a bf16 ``x``, which is exact),
    and the kept pairs' products (``split_engine.pairs``), each exact in
    f32, are summed in f32 → (N, Q, H, P).  For the tests and
    ``chip_smoke.py``; no main path calls it."""
    nx = 1 if x.dtype == torch.bfloat16 else 3
    cbf, la, xf = cb.float(), la.float(), x.float()
    q = cbf.shape[1]
    diff = la[:, :, None, :] - la[:, None, :, :]        # (N,Q,Q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=cb.device))[None, :, :, None]
    lmat = torch.exp(torch.where(mask, diff, -torch.inf)) * cbf[..., None]
    tl, tx = bf16_split3(lmat), bf16_split3(xf)[:nx]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, j in split_engine.pairs(3, nx):
        out += torch.einsum("nqkh,nkhp->nqhp", tl[i].float(), tx[j].float())
    return out


def solve_lambda_grid(q: torch.Tensor, evals: torch.Tensor, a: torch.Tensor,
                      lambdas: torch.Tensor) -> torch.Tensor:
    """``out[r] = Q · diag(1/(Λ+λ_r)) · A`` in f32, as the reference's oracle
    (``repro/kernels/ref.py:18``): the (r, p, t) rescaled operand is
    materialised, then contracted with ``Q``.  q (p, p) in any layout,
    evals (p,), a (p, t), lambdas (r,) → (r, p, t) float32."""
    scale = 1.0 / (evals.float()[None, :] + lambdas.float()[:, None])  # (r, p)
    scaled = a.float()[None, :, :] * scale[:, :, None]                 # (r,p,t)
    return torch.einsum("ik,rkt->rit", q.float(), scaled)


def pearson_r(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-target Pearson r by the kernel's single-pass raw-sums formula
    (``repro/kernels/pearsonr.py:44-52``): five f32 column sums, finalised
    with the true row count.  (n, t) × (n, t) → (t,) float32.  It cancels in
    f32 where a column's mean is large against its spread, as the Pallas
    kernel does; the centred formula is ``core.scoring.pearson_r``."""
    return pearson_r_from_sums(pearson_sums(y_true, y_pred), y_true.shape[0])
