"""Per-target Pearson r: the checked launcher of the CUDA kernel
(``csrc/pearsonr.cu``) and the raw-sums helpers.

Port of ``repro/kernels/pearsonr.py``.  ``pearson_r`` takes CUDA tensors
only, checks them, allocates the f32 output and the partial-sums
workspace, launches on the current stream, raises on a launch error and
counts the launch in ``LAUNCHES``; ``kernels.ops`` routes CPU tensors to
the plain version in ``kernels.ref``.  ``pearson_sums`` and
``pearson_r_from_sums`` are the plain reduction and finalise that a caller
accumulating sums across blocks uses (serving does).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

_THREADS = 256        # target columns per block of the kernel
_MIN_SPLIT_ROWS = 64  # fewest rows a split of the row axis sums
_MAX_SPLITS = 65535   # grid.y of the kernel

# Launches since the last ``reset_launches()``.
LAUNCHES: dict[str, int] = {"pearson_r": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pearson_sums(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """The kernel's five running sums ``[Σy, Σŷ, Σy², Σŷ², Σyŷ]`` per
    target as one plain reduction: (n, t) × (n, t) → (5, t) float32.

    Zero-padded rows add nothing to any sum, so a caller may sum over
    padded blocks and finalise with ``pearson_r_from_sums`` and the true
    row count.
    """
    yt, yp = y_true.float(), y_pred.float()
    return torch.stack([yt.sum(0), yp.sum(0), (yt * yt).sum(0),
                        (yp * yp).sum(0), (yt * yp).sum(0)])


def pearson_r_from_sums(sums, n_true):
    """Finalise per-target Pearson r from the five raw sums.

    The kernel's formula (``repro/kernels/pearsonr.py:44-52``):
    ``(nΣxy − ΣxΣy) / √((nΣx²−(Σx)²)(nΣy²−(Σy)²))``, variances clamped at
    0, denominator floored at 1e-12, ``n`` the true row count.
    Dtype-generic: a numpy array is finalised in numpy in its own dtype
    (float64 in → float64 out, for sums accumulated across many blocks
    without f32 cancellation), a tensor in torch.
    """
    sx, sy, sxx, syy, sxy = (sums[i] for i in range(5))
    if isinstance(sums, torch.Tensor):
        n, sqrt = float(n_true), torch.sqrt

        def floor(v, lo):
            return torch.clamp(v, min=lo)
    else:
        n, sqrt, floor = sums.dtype.type(n_true), np.sqrt, np.maximum
    num = n * sxy - sx * sy
    var_x = floor(n * sxx - sx * sx, 0.0)
    var_y = floor(n * syy - sy * sy, 0.0)
    return num / floor(sqrt(var_x * var_y), 1e-12)


def _splits(n: int, t: int, device: torch.device) -> int:
    """Row splits of one launch: enough blocks for ~4 per SM, none with
    fewer than ``_MIN_SPLIT_ROWS`` rows, every split non-empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    col_blocks = -(-t // _THREADS)
    want = max(1, -(-4 * sms // col_blocks))
    s = max(1, min(want, n // _MIN_SPLIT_ROWS, _MAX_SPLITS))
    # Splits of ceil(n / s) rows: shrink s until the last one is non-empty.
    return -(-n // -(-n // s)) if n > 0 else 1


def pearson_r(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-target Pearson r in one launch.  y_true, y_pred: (n, t), CUDA,
    contiguous, float32 or bfloat16 alike → (t,) float32."""
    ops = {"y_true": y_true, "y_pred": y_pred}
    for name, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major); pass "
                             f"{name}.contiguous()")
    desc = ", ".join(f"{k} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for k, t in ops.items())
    if y_true.shape != y_pred.shape or y_true.device != y_pred.device:
        raise ValueError(f"operands differ in shape or device: {desc}")
    if y_true.dtype != y_pred.dtype \
            or y_true.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operands must share dtype float32 or bfloat16: "
                         f"{desc}")
    n, t = y_true.shape
    out = torch.empty((t,), dtype=torch.float32, device=y_true.device)
    if t == 0:
        return out
    splits = _splits(n, t, y_true.device)
    partial = torch.empty((splits, 5, t), dtype=torch.float32,
                          device=y_true.device)
    lib = _build.load()
    fn = (lib.repro_pearson_r_f32 if y_true.dtype == torch.float32
          else lib.repro_pearson_r_bf16)
    with torch.cuda.device(y_true.device):
        rc = fn(y_true.data_ptr(), y_pred.data_ptr(), partial.data_ptr(),
                out.data_ptr(), n, t, splits, torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, "pearson_r", f"{desc}, {splits} row splits")
    LAUNCHES["pearson_r"] += 1
    return out
