"""Device-routed entry points of the port's kernels.

Port of ``repro/kernels/ops.py``.  The route is the tensor's device: a CPU
tensor goes to the plain version (``kernels.ref``), a CUDA tensor to the
hand-written kernel (``kernels.gram``, ``kernels.ridge_solve``,
``kernels.pearsonr``, ``kernels.attention``, ``kernels.ssd``), which
launches or raises.

The model kernels (``mha_flash``, ``ssd_intra``) have no backward: their
outputs carry no autograd history.  So they refuse, on every device, an
operand that requires grad while grad mode is on, rather than drop its
gradient; the reference cannot differentiate through its Pallas kernels
either.  Training runs the models with the kernel switches off.

A fake tensor (``FakeTensorMode``: the dry run's) is refused on every
route: no kernel can run on it, and the plain version is not the kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import attention as _attention
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import pearsonr as _pearsonr
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ridge_solve as _ridge_solve
from repro_torch.kernels import ssd as _ssd


def _plain_route(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one (the
    kernel); raises for a fake tensor."""
    if isinstance(t, FakeTensor):
        raise RuntimeError(f"{name}: a fake tensor; the kernels do not run "
                           f"on fake tensors (the dry run keeps the kernel "
                           f"switches off)")
    return t.device.type == "cpu"


def kernel_tier_auto(device: torch.device | str) -> bool:
    """Whether ``use_pallas=None`` turns the kernel tier on: iff CUDA."""
    return torch.device(device).type == "cuda"


def xty(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """XᵀY, f32 accumulation.  (n, p), (n, q) → (p, q)."""
    if _plain_route(x, "xty"):
        return _ref.xty(x, y)
    return _gram.xty(x, y)


def gram(x: torch.Tensor) -> torch.Tensor:
    """XᵀX, f32 accumulation.  (n, p) → (p, p)."""
    if _plain_route(x, "gram"):
        return _ref.gram(x)
    return _gram.gram(x)


def xty_folds(x: torch.Tensor, y: torch.Tensor,
              bounds: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Per-fold XᵀY in one row pass.  (n, p), (n, q) → (k, p, q)."""
    if _plain_route(x, "xty_folds"):
        return _ref.xty_folds(x, y, bounds)
    return _gram.xty_folds(x, y, bounds)


def xty_folds_masked(x: torch.Tensor, z: torch.Tensor,
                     onehot: torch.Tensor) -> torch.Tensor:
    """Per-slot masked cross-Gram.  (m, p), (m, q), (m, s) → (s, p, q)."""
    if _plain_route(x, "xty_folds_masked"):
        return _ref.xty_folds_masked(x, z, onehot)
    return _gram.xty_folds_masked(x, z, onehot)


def solve_lambda_grid(q: torch.Tensor, evals: torch.Tensor, a: torch.Tensor,
                      lambdas: torch.Tensor) -> torch.Tensor:
    """Fused multi-λ eigenbasis solve.  (p,p), (p,), (p,t), (r,) → (r,p,t)."""
    if _plain_route(q, "solve_lambda_grid"):
        return _ref.solve_lambda_grid(q, evals, a, lambdas)
    return _ridge_solve.solve_lambda_grid(q, evals, a, lambdas)


def pearson_r(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-target Pearson correlation.  (n, t) × (n, t) → (t,)."""
    if _plain_route(y_true, "pearson_r"):
        return _ref.pearson_r(y_true, y_pred)
    return _pearsonr.pearson_r(y_true, y_pred)


def pearson_sums(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """The kernel's five running sums, plain.  (n, t) × 2 → (5, t)."""
    return _pearsonr.pearson_sums(y_true, y_pred)


def pearson_r_from_sums(sums, n_true):
    """Finalise r from accumulated sums (numpy or torch, dtype kept)."""
    return _pearsonr.pearson_r_from_sums(sums, n_true)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Streaming attention, (BH, S, K) layout, q pre-scaled → (BH, S, K)."""
    if _plain_route(q, "flash_attention"):
        return _ref.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
    return _attention.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap)


def _no_grad_through(name: str, *operands: torch.Tensor) -> None:
    """Raise if autograd would need a backward of kernel ``name``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(
            f"{name} has no backward: an operand requires grad under grad "
            f"mode, and its gradient would be lost; train with the kernel "
            f"switches off (flash_kernel=False, ssm.use_kernel=False)")


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_kv: int,
              *, causal: bool = True, window: int | None = None,
              softcap: float | None = None) -> torch.Tensor:
    """Model-layout attention: q (B,S,H,K), GQA k/v (B,T,N,K) → (B,S,H,K)."""
    _no_grad_through("mha_flash", q, k, v)
    if _plain_route(q, "mha_flash"):
        return _ref.mha_flash(q, k, v, n_kv, causal=causal, window=window,
                              softcap=softcap)
    return _attention.mha_flash(q, k, v, n_kv, causal=causal, window=window,
                                softcap=softcap)


def ssd_intra(cb: torch.Tensor, la: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Mamba2 SSD within-chunk term.  (N,Q,Q), (N,Q,H), (N,Q,H,P) → f32."""
    _no_grad_through("ssd_intra", cb, la, x)
    if _plain_route(x, "ssd_intra"):
        return _ref.ssd_intra(cb, la, x)
    return _ssd.ssd_intra(cb, la, x)
