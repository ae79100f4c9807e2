"""B-MOR — Batch Multi-Output Ridge, the paper's contribution (§2.3.5, Alg. 1).

Port of ``repro/core/bmor.py``.  The paper partitions the target matrix
``Y`` into ``c`` column batches, one per Dask compute node; each node runs
the SVD-mutualised RidgeCV on its batch, so λ is cross-validated *per
batch* (Algorithm 1 line 13).  Complexity: ``T_B-MOR = c⁻¹·T_W + T_M``
(Eq. 7).  Here the compute nodes are the ranks of a ``core.compat.Mesh``:
``Y``'s columns are split over ``target_axis``, and rows over
``data_axis`` too, where the factorisation works on the Gram ``G = XᵀX``
— a sum over row shards, so distribution costs one ``psum`` instead of a
distributed SVD.

Each function takes THIS rank's blocks (``encoding.sharding.ShardingPlan.
place``) and is a plain function of them: what the reference runs inside
``shard_map``, with ``jax.lax.psum`` as ``Mesh.psum``.  Every rank ends
with the same full result — ``weights`` (p, t), per-batch ``best_lambda``
(target_shards,) and ``cv_scores`` (target_shards, r) gathered over the
target axis — as the reference's single controller returns.

The products are f32 ``torch.matmul`` (TF32 stays off), as the reference
leaves them to XLA, except the fold partials (one ``xty_folds`` launch a
rank with the kernel tier, ``foldstats.partial_fold_stats``) and the dual
kernel ``K = XXᵀ`` (``ridge.xxt``: ``xty`` on the card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import foldstats, ridge
from repro_torch.core.compat import Axis, Mesh
from repro_torch.core.ridge import RidgeCVConfig


@dataclasses.dataclass
class BMORResult:
    weights: torch.Tensor       # (p, t) — every batch's columns, gathered
    best_lambda: torch.Tensor   # (target_shards,) — per-batch λ (Alg. 1 l.13)
    cv_scores: torch.Tensor     # (target_shards, r)


def _lambdas(cfg: RidgeCVConfig, device: torch.device) -> torch.Tensor:
    return torch.tensor(cfg.lambdas, dtype=torch.float32, device=device)


def _per_lambda_preds(B: torch.Tensor, evals: torch.Tensor,
                      lams: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``preds[r] = B · diag(1/(Λ+λ_r)) · A`` → (r, m, t), as one product
    of ``B`` with the λ-scaled copies of ``A`` side by side."""
    (m, p), (r, t) = B.shape, (lams.shape[0], A.shape[1])
    inv = 1.0 / (evals[None, :] + lams[:, None])                  # (r, p)
    scaled = (inv[:, :, None] * A[None]).permute(1, 0, 2).reshape(p, r * t)
    return torch.matmul(B, scaled).reshape(m, r, t).permute(1, 0, 2)


def _gather_result(mesh: Mesh, target_axis: str, W_l: torch.Tensor,
                   lam: torch.Tensor, cv: torch.Tensor) -> BMORResult:
    return BMORResult(
        weights=mesh.all_gather(W_l, target_axis, dim=1),
        best_lambda=mesh.all_gather(lam.reshape(1), target_axis),
        cv_scores=mesh.all_gather(cv[None], target_axis))


def bmor_fit(X: torch.Tensor, Y: torch.Tensor, mesh: Mesh,
             data_axis: Axis = "data", target_axis: str = "model",
             cfg: RidgeCVConfig = RidgeCVConfig()) -> BMORResult:
    """Distributed B-MOR fit.

    ``X`` (n_local, p) and ``Y`` (n_local, t_local) are this rank's blocks:
    rows ``[i·n_local, (i+1)·n_local)`` for its coordinate ``i`` along
    ``data_axis`` (a name or a tuple of names, row-major), and its batch of
    columns along ``target_axis``.  Per-fold partial statistics reduce in
    ONE ``psum`` of the stacked ``(k, p, p+t_local)`` ``[G|C]``; every
    training split derives by the Gram downdate ``G_tot − G_f``, and pays
    its own ``eigh`` (Algorithm 1's per-split factorisation).
    """
    n_local, p = X.shape
    n_total = n_local * mesh.size(data_axis)
    dev = X.device
    lams = _lambdas(cfg, dev)
    rows = (mesh.axis_index(data_axis) * n_local
            + torch.arange(n_local, device=dev))
    folds = foldstats.fold_of_rows(rows, n_total, cfg.n_folds)
    bounds = foldstats.local_fold_bounds(folds, cfg.n_folds)
    GC = foldstats.partial_fold_gc(X, Y, bounds, use_pallas=cfg.use_pallas)
    GC = mesh.psum(GC, data_axis)                         # (k, p, p+t_l)
    G_folds, C_folds = GC[:, :, :p], GC[:, :, p:]
    G_tot, C_tot = G_folds.sum(0), C_folds.sum(0)
    Xf, Yf = X.float(), Y.float()
    r = lams.shape[0]

    scores = []
    for f, (lo, hi) in enumerate(bounds):
        # Gram downdate: training statistics for this split.
        G_tr = G_tot - G_folds[f]
        G_tr.diagonal().add_(cfg.jitter)
        evals, Q = torch.linalg.eigh(G_tr)                  # per split
        del G_tr
        A = torch.matmul(Q.T, C_tot - C_folds[f])             # (p, t_l)
        # Only the fold's own rows of this window predict; the reference's
        # masked rows elsewhere add exact zeros.
        Yv = Yf[lo:hi]
        preds = _per_lambda_preds(torch.matmul(Xf[lo:hi], Q), evals, lams, A)
        part = torch.cat([((Yv[None] - preds) ** 2).sum((1, 2)),
                          torch.tensor([float(hi - lo)], device=dev),
                          Yv.sum(0)])
        part = mesh.psum(part, data_axis)     # ss_res (r,), n_val, Σy (t_l,)
        mu = part[r + 1:] / part[r]
        ss_tot = mesh.psum(((Yv - mu[None]) ** 2).sum().reshape(1),
                           data_axis)[0]
        scores.append(1.0 - part[:r] / torch.clamp(ss_tot, min=1e-12))
        del A, preds
    cv_scores = torch.stack(scores).mean(0)                   # (r,)
    best = torch.argmax(cv_scores)

    # Final refit on all rows with this batch's λ (Alg. 1 line 14).
    del G_folds, GC
    G_tot.diagonal().add_(cfg.jitter)
    evals, Q = torch.linalg.eigh(G_tot)
    W_l = ridge.solve(ridge.RidgeFactors(basis=Q, evals=evals, primal=True),
                      C_tot, lams[best])                      # (p, t_l)
    return _gather_result(mesh, target_axis, W_l, lams[best], cv_scores)


def bmor_fit_dual(X: torch.Tensor, Y: torch.Tensor, mesh: Mesh,
                  target_axis: str = "model",
                  cfg: RidgeCVConfig = RidgeCVConfig()) -> BMORResult:
    """B-MOR for the dual regime n < p (the paper's whole-brain-MOR
    workload: n = 1,000 ≪ p = 16,384).

    ``X`` (n, p) is every row (replicated: the n×n kernel ``K = XXᵀ`` is
    small exactly when the dual form is chosen, so no ``psum``); ``Y``
    (n, t_local) is this rank's batch of columns.  Every CV split slices
    its training block ``K[tr, tr]`` and pays one ``eigh`` of it.
    """
    n = X.shape[0]
    dev = X.device
    lams = _lambdas(cfg, dev)
    K = ridge.xxt(X, use_pallas=cfg.use_pallas)               # (n, n)
    Yf = Y.float()
    scores = []
    for lo, hi in foldstats.fold_bounds(n, cfg.n_folds):
        tr = torch.cat([torch.arange(lo), torch.arange(hi, n)]).to(dev)
        K_tr = K[tr][:, tr]
        K_tr.diagonal().add_(cfg.jitter)
        evals, P_ = torch.linalg.eigh(K_tr)
        del K_tr
        # α(λ) = P (Γ+λ)⁻¹ Pᵀ Y_tr;  preds = K_val,tr · α.
        z = torch.matmul(P_.T, Yf[tr])
        B_ = torch.matmul(K[lo:hi][:, tr], P_)                # (n_val, n_tr)
        preds = _per_lambda_preds(B_, evals, lams, z)
        Y_val = Yf[lo:hi]
        ss_res = ((Y_val[None] - preds) ** 2).sum((1, 2))
        ss_tot = ((Y_val - Y_val.mean(0, keepdim=True)) ** 2).sum()
        scores.append(1.0 - ss_res / torch.clamp(ss_tot, min=1e-12))
    cv_scores = torch.stack(scores).mean(0)
    best = torch.argmax(cv_scores)
    K.diagonal().add_(cfg.jitter)
    evals, P_ = torch.linalg.eigh(K)
    z = torch.matmul(P_.T, Yf)
    alpha = torch.matmul(P_, z / (evals + lams[best])[:, None])
    W_l = torch.matmul(X.float().T, alpha)                    # (p, t_l)
    return _gather_result(mesh, target_axis, W_l, lams[best], cv_scores)


__all__ = ["BMORResult", "bmor_fit", "bmor_fit_dual"]
