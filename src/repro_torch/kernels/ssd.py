"""Checked launcher of the CUDA SSD within-chunk kernel (``csrc/ssd.cu``).

Port of ``repro/kernels/ssd.py``: ``ssd_intra`` computes the Mamba2
within-chunk term ``y[n,q,h,p] = Σ_{k≤q} exp(la[n,q,h] − la[n,k,h]) ·
cb[n,q,k] · x[n,k,h,p]`` (n_groups = 1 layout) in one launch, on the
tensor cores: the f32 decay-score matrix L and x are cut into exact bf16
terms and the kept term products summed in f32 (``ref.ssd_intra_split``
is the plain model of that arithmetic).  The wrapper
takes CUDA tensors only, checks them, allocates the f32 output, launches
on the current stream, raises on a launch error and counts the launch in
``LAUNCHES``.  ``kernels.ops`` routes CPU tensors to ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# The longest chunk the kernel takes (csrc/ssd.cu: a 64 × Q block of cb
# and eight heads' la in a block's shared memory).  The models' is 256.
MAX_CHUNK = 704

# Launches since the last ``reset_launches()``.
LAUNCHES: dict[str, int] = {"ssd_intra": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ssd_intra(cb: torch.Tensor, la: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """cb (N, Q, Q) chunk scores C_q·B_k, la (N, Q, H) cumulative log
    decay, x (N, Q, H, P) Δt-scaled inputs; CUDA, contiguous, float32 or
    bfloat16 alike → (N, Q, H, P) float32."""
    ops = {"cb": cb, "la": la, "x": x}
    desc = ", ".join(f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for n, t in ops.items() if isinstance(t, torch.Tensor))
    for name, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: {desc}")
    if len({t.device for t in ops.values()}) != 1:
        raise ValueError(f"operands on different devices: {desc}")
    if (len({t.dtype for t in ops.values()}) != 1
            or x.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"operands must share dtype float32 or bfloat16: "
                         f"{desc}")
    if x.dim() != 4 or cb.dim() != 3 or la.dim() != 3:
        raise ValueError(f"want cb (N, Q, Q), la (N, Q, H), x (N, Q, H, P): "
                         f"{desc}")
    n, q, h, p = x.shape
    if cb.shape != (n, q, q) or la.shape != (n, q, h):
        raise ValueError(f"want cb (N, Q, Q), la (N, Q, H), x (N, Q, H, P): "
                         f"{desc}")
    if q > MAX_CHUNK:
        raise ValueError(f"chunk length Q={q} > {MAX_CHUNK}: the kernel "
                         f"stages a 64 × Q block of cb in shared memory: "
                         f"{desc}")
    if n * -(-h // 8) * -(-q // 64) >= 2**31:
        raise ValueError(f"shape out of the kernel's grid range: {desc}")
    out = torch.empty((n, q, h, p), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    # Set by the kernel when x holds a NaN or ±Inf (csrc/ssd.cu).
    flag = torch.empty(1, dtype=torch.int32, device=x.device)
    lib = _build.load()
    fn = (lib.repro_ssd_intra_f32 if x.dtype == torch.float32
          else lib.repro_ssd_intra_bf16)
    with torch.cuda.device(x.device):
        rc = fn(cb.data_ptr(), la.data_ptr(), x.data_ptr(), out.data_ptr(),
                flag.data_ptr(), n, q, h, p, torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, "ssd_intra", f"{desc}")
    LAUNCHES["ssd_intra"] += 1
    return out
