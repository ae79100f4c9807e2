"""Checked launcher of the CUDA multi-λ eigenbasis solve
(``csrc/ridge_solve.cu``).

Port of ``repro/kernels/ridge_solve.py``: ``out[r] = Q·diag(1/(Λ+λ_r))·A``
for every λ of the grid in one counted launch, the rescale of ``A`` fused
into the product, on the split-bf16 tensor-core engine
(``kernels.split_engine`` sizes its scratch).  The wrapper takes CUDA
tensors only, checks them, allocates the f32 output, launches on the
current stream, raises on a launch error and counts the launch in
``LAUNCHES``.  ``Q`` is read in place through its strides:
``torch.linalg.eigh`` returns it column-major, and a contiguous copy
would move p² floats per call.  ``kernels.ops`` routes CPU tensors to the
plain version in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, split_engine

# Launches since the last ``reset_launches()``.
LAUNCHES: dict[str, int] = {"solve_lambda_grid": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q: torch.Tensor, evals: torch.Tensor, a: torch.Tensor,
           lambdas: torch.Tensor) -> None:
    ops = {"q": q, "evals": evals, "a": a, "lambdas": lambdas}
    desc = ", ".join(f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for n, t in ops.items()
                     if isinstance(t, torch.Tensor))
    for name, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
    if len({t.device for t in ops.values()}) != 1:
        raise ValueError(f"operands on different devices: {desc}")
    if q.dim() != 2 or q.shape[0] != q.shape[1]:
        raise ValueError(f"q must be square (p, p): {desc}")
    p = q.shape[0]
    if a.dim() != 2 or a.shape[0] != p or evals.shape != (p,) \
            or lambdas.dim() != 1:
        raise ValueError(f"want q (p, p), evals (p,), a (p, t), lambdas "
                         f"(r,): {desc}")
    if q.dtype != a.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q and a must share dtype float32 or bfloat16: "
                         f"{desc}")
    if evals.dtype != torch.float32 or lambdas.dtype != torch.float32:
        raise ValueError(f"evals and lambdas must be float32: {desc}")
    if min(q.stride()) < 0:
        raise ValueError(f"q has a negative stride {q.stride()}")
    for name in ("evals", "a", "lambdas"):
        if not ops[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous; pass "
                             f"{name}.contiguous()")
    if lambdas.shape[0] < 1:
        raise ValueError(f"the λ grid is empty: {desc}")


def solve_lambda_grid(q: torch.Tensor, evals: torch.Tensor, a: torch.Tensor,
                      lambdas: torch.Tensor) -> torch.Tensor:
    """All-λ eigenbasis solve, one counted launch.

    q: (p, p) eigenbasis in any layout (row- or column-major, read through
    its strides), evals: (p,) f32, a: (p, t) = Qᵀ(XᵀY) contiguous in q's
    dtype (float32 or bfloat16), lambdas: (r,) f32, all on one CUDA device
    → (r, p, t) float32.  The split passes write the bf16 terms of Q and of
    the scaled A, the λ index folded into A's columns
    (``split_engine.solve_planes``); one tensor-core product sums the kept
    term pairs.
    """
    _check(q, evals, a, lambdas)
    p, t, r = q.shape[0], a.shape[1], lambdas.shape[0]
    out = torch.empty((r, p, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    # The r × p reciprocals 1/(Λ_k + λ_r), written by the launch's first
    # kernel.
    scales = torch.empty((r, p), dtype=torch.float32, device=q.device)
    na, nb = split_engine.solve_planes(q.dtype)
    scratch_a = split_engine.scratch(p, p, na, split_engine.TILE_M, q.device)
    scratch_b = split_engine.scratch(r * t, p, nb,
                                     split_engine.tile_n(r * t), q.device)
    lib = _build.load()
    fn = (lib.repro_solve_lambda_grid_f32 if q.dtype == torch.float32
          else lib.repro_solve_lambda_grid_bf16)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), q.stride(0), q.stride(1), evals.data_ptr(),
                a.data_ptr(), lambdas.data_ptr(), scales.data_ptr(),
                scratch_a.data_ptr(), scratch_b.data_ptr(), out.data_ptr(),
                p, t, r,
                torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, "solve_lambda_grid",
                    f"q {tuple(q.shape)} strides {q.stride()}, a "
                    f"{tuple(a.shape)}, r={r}, {q.dtype}")
    LAUNCHES["solve_lambda_grid"] += 1
    return out
