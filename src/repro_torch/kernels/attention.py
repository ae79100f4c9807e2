"""Checked launcher of the CUDA attention kernel
(``csrc/flash_attention.cu``).

Port of ``repro/kernels/flash_attention.py``: ``flash_attention`` takes the
(BH, S, K) layout and ``mha_flash`` the model layout (B, S, H, K) with
grouped kv heads (B, T, n_kv, K), read in place (no expansion, no
transpose: the kernel takes strides).  q is pre-scaled.  bf16 operands go
to the tensor-core kernel (``wgmma``, P·V as three exact bf16 terms), f32
ones to the CUDA-core kernel: a choice by dtype, not a fallback.  Each
wrapper takes CUDA tensors only, checks them, allocates the output in q's
dtype, launches on the current stream, raises on a launch error and counts
the launch in ``LAUNCHES``.  ``kernels.ops`` routes CPU tensors to the
plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
_MAX_Q_TILES = 65535   # grid.y of the f32 kernel, 64 query rows each

# Launches since the last ``reset_launches()``.
LAUNCHES: dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_kv: int,
           window: int | None, softcap: float | None) -> None:
    ops = {"q": q, "k": k, "v": v}
    desc = ", ".join(f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for n, t in ops.items())
    for name, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D here, got {desc}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous "
                             f"(stride 1): {desc}")
    if len({t.device for t in ops.values()}) != 1:
        raise ValueError(f"operands on different devices: {desc}")
    if (len({t.dtype for t in ops.values()}) != 1
            or q.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"operands must share dtype float32 or bfloat16: "
                         f"{desc}")
    b, s, h, kd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n_kv \
            or k.shape[3] != kd:
        raise ValueError(f"k and v must be (B, T, n_kv={n_kv}, K) with q's "
                         f"B and K: {desc}")
    if n_kv < 1 or h % n_kv != 0:
        raise ValueError(f"{h} query heads are not a multiple of n_kv={n_kv}")
    if not 1 <= kd <= MAX_HEAD_DIM:
        raise ValueError(f"head dimension {kd}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    if s < 1 or k.shape[1] < 1 or -(-s // 64) > _MAX_Q_TILES \
            or k.shape[1] >= 2**31 or b * h >= 2**31:
        raise ValueError(f"sequence lengths out of the kernel's range: {desc}")
    if window is not None and window < 1:
        raise ValueError(f"window must be ≥ 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_kv: int,
            causal: bool, window: int | None,
            softcap: float | None) -> torch.Tensor:
    b, s, h, kd = q.shape
    t = k.shape[1]
    out = torch.empty((b, s, h, kd), dtype=q.dtype, device=q.device)
    lib = _build.load()
    fn = (lib.repro_flash_attention_f32 if q.dtype == torch.float32
          else lib.repro_flash_attention_bf16)
    # Host memory: the C side copies it into the launch's parameters.
    strides = (ctypes.c_longlong * 12)(*(st for x in (q, k, v, out)
                                         for st in x.stride()[:3]))
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, h, n_kv, s, t, kd, int(causal), window or 0,
                float(softcap or 0.0), torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, "flash_attention",
                    f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}, "
                    f"causal={causal}, window={window}, softcap={softcap}")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Streaming attention in one launch.  q (BH, S, K) pre-scaled, k/v
    (BH, T, K), CUDA, float32 or bfloat16 alike → (BH, S, K) in q's dtype,
    with f32 scores and accumulation."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{name} must be a 3-D (BH, S|T, K) tensor")
    _check(q[:, :, None], k[:, :, None], v[:, :, None], 1, window, softcap)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None], 1, causal,
                   window, softcap)[:, :, 0]


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_kv: int,
              *, causal: bool = True, window: int | None = None,
              softcap: float | None = None) -> torch.Tensor:
    """Model-layout streaming attention in one launch: q (B, S, H, K)
    pre-scaled, k/v (B, T, n_kv, K); query head h reads kv head
    h // (H / n_kv).  Any strides with a contiguous head dimension.
    → (B, S, H, K) contiguous, in q's dtype."""
    _check(q, k, v, n_kv, window, softcap)
    return _launch(q, k, v, n_kv, causal, window, softcap)
