"""Checked launchers of the CUDA cross-Gram kernel (``csrc/gram.cu``).

Port of ``repro/kernels/gram.py``: ``xty_folds`` (per-fold ``X_fᵀY_f``,
each fold one product of the split-bf16 tensor-core engine),
``xty_folds_masked`` (per-slot ``(X·w_s)ᵀZ``, the streamed chunk update, on
the same engine; both allocate the engine's scratch with
``kernels.split_engine``) and ``xty`` (``XᵀY`` on the CUDA-core row loop:
one row range, or, for an output too small to fill the card, ``row_splits``
row ranges plus an in-order sum of the partials).  Each wrapper takes CUDA tensors only, checks
them, allocates the f32 output, launches on the current stream, raises on
a launch error and counts the launch in ``LAUNCHES``.  The build happens
at the first launch, so this module imports on a host without ``nvcc``;
``kernels.ops`` routes CPU tensors to the plain versions in
``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build, split_engine

_TILE = 128          # output tile edge of the kernel (both axes)
_MAX_GRID_YZ = 65535
_MAX_FOLDS = 64      # the kernel takes the fold bounds by value (kMaxFolds)
_BLOCKS_PER_SM = 2   # __launch_bounds__(256, 2) of the fold kernel
_MIN_SPLIT_ROWS = 256

# Launches per kernel since the last ``reset_launches()``.
LAUNCHES: dict[str, int] = {"xty": 0, "xty_folds": 0,
                           "xty_folds_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_operands(x: torch.Tensor, y: torch.Tensor,
                    **more: torch.Tensor) -> None:
    """CUDA, 2-D, contiguous, one device and dtype (f32 or bf16), one row
    count: what every kernel here takes."""
    ops = {"x": x, "y": y, **more}
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
    if len({t.device for t in ops.values()}) != 1:
        raise ValueError(f"operands on different devices: {desc}")
    if (len({t.dtype for t in ops.values()}) != 1
            or x.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"operands must share dtype float32 or bfloat16: "
                         f"{desc}")
    if len({t.shape[0] for t in ops.values()}) != 1:
        raise ValueError(f"row counts differ: {desc}")


def _check_bounds(bounds: Sequence[tuple[int, int]], n: int
                  ) -> list[tuple[int, int]]:
    b = [(int(lo), int(hi)) for lo, hi in bounds]
    ok = (bool(b) and b[0][0] == 0 and b[-1][1] == n
          and all(lo <= hi for lo, hi in b)
          and all(b[i][1] == b[i + 1][0] for i in range(len(b) - 1)))
    if not ok:
        raise ValueError(f"bounds {b} must be contiguous, ordered ranges "
                         f"covering [0, {n})")
    if len(b) > _MAX_FOLDS:
        raise ValueError(f"{len(b)} folds: the kernel takes at most "
                         f"{_MAX_FOLDS}")
    return b


def row_splits(n: int, p: int, q: int, sms: int = 132
               ) -> list[tuple[int, int]]:
    """The row ranges ``xty`` cuts an (n, p) × (n, q) product into.

    One range ``[(0, n)]`` when the output's 128 × 128 tiles already number
    at least two per SM (the kernel's occupancy); otherwise S contiguous,
    near-equal ranges covering ``[0, n)`` with tiles · S ≥ 2 · sms, each at
    least 256 rows and S ≤ 64 (the kernel's fold limit).
    """
    tiles = -(-p // _TILE) * -(-q // _TILE)
    want = _BLOCKS_PER_SM * sms
    s = 1 if tiles >= want else -(-want // max(tiles, 1))
    s = max(1, min(s, n // _MIN_SPLIT_ROWS, _MAX_FOLDS))
    return [(i * n // s, (i + 1) * n // s) for i in range(s)]


def _launch(x: torch.Tensor, y: torch.Tensor,
            bounds: list[tuple[int, int]], name: str) -> torch.Tensor:
    """One launch of the row loop (``xty``'s kernel) over ``bounds`` →
    (k, p, q) f32; ``name`` labels an error only (the callers count their
    launches)."""
    p, q, k = x.shape[1], y.shape[1], len(bounds)
    out = torch.empty((k, p, q), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _check_grid(p)
    lib = _build.load()
    fn = (lib.repro_xty_rows_f32 if x.dtype == torch.float32
          else lib.repro_xty_rows_bf16)
    # Host memory: the C side copies it into the launch's parameters.
    flat = (ctypes.c_longlong * (2 * k))(*(v for b in bounds for v in b))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), flat, out.data_ptr(), p,
                q, k, torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, name, f"x {tuple(x.shape)}, y "
                    f"{tuple(y.shape)}, k={k}, {x.dtype}")
    return out


def _check_grid(p: int) -> None:
    if -(-p // _TILE) > _MAX_GRID_YZ:
        raise ValueError(f"p={p} exceeds the kernel's grid limit "
                         f"{_MAX_GRID_YZ * _TILE}")


def xty_folds(x: torch.Tensor, y: torch.Tensor,
              bounds: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Per-fold ``out[f] = X[lo:hi]ᵀ Y[lo:hi]``, one counted launch.

    ``bounds`` are contiguous row ranges covering ``[0, n)`` (as
    ``foldstats.fold_bounds`` makes them).  x: (n, p), y: (n, q), both CUDA,
    contiguous, float32 or bfloat16 alike → (k, p, q) float32.  Each fold
    runs on the split-bf16 tensor-core engine: the split passes write the
    bf16 terms of x[lo:hi] and y[lo:hi] (``split_engine.folds_planes``)
    into scratch sized for the largest fold and shared by all, then one
    product sums the kept term pairs into ``out[f]``; an empty fold is an
    exact zero slice.
    """
    _check_operands(x, y)
    b = _check_bounds(bounds, x.shape[0])
    p, q, k = x.shape[1], y.shape[1], len(b)
    out = torch.empty((k, p, q), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rows = max(hi - lo for lo, hi in b)
    na, nb = split_engine.folds_planes(x.dtype)
    scratch_a = split_engine.scratch(p, rows, na, split_engine.TILE_M,
                                     x.device)
    scratch_b = split_engine.scratch(q, rows, nb, split_engine.TILE_N,
                                     x.device)
    lib = _build.load()
    fn = (lib.repro_xty_folds_f32 if x.dtype == torch.float32
          else lib.repro_xty_folds_bf16)
    flat = (ctypes.c_longlong * (2 * k))(*(v for bd in b for v in bd))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), flat, scratch_a.data_ptr(),
                scratch_b.data_ptr(), out.data_ptr(), p, q, k,
                torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, "xty_folds", f"x {tuple(x.shape)}, y "
                    f"{tuple(y.shape)}, k={k}, {x.dtype}")
    LAUNCHES["xty_folds"] += 1
    return out


def xty(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``XᵀY`` in f32.  (n, p), (n, q) → (p, q).

    The one-fold launch where the output fills the card; else the fold
    kernel over ``row_splits`` and a second kernel that adds the partials
    in split order (no atomics: repeated calls are bitwise equal).  One
    call counts one launch.
    """
    _check_operands(x, y)
    n, p = x.shape
    q = y.shape[1]
    splits = row_splits(n, p, q, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    part = _launch(x, y, splits, "xty")
    if len(splits) > 1 and part.numel():
        out = torch.empty((p, q), dtype=torch.float32, device=x.device)
        lib = _build.load()
        with torch.cuda.device(x.device):
            rc = lib.repro_xty_split_sum(
                part.data_ptr(), out.data_ptr(), p * q, len(splits),
                torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
        _build.check_rc(lib, rc, "xty (sum of row splits)",
                        f"x {tuple(x.shape)}, y {tuple(y.shape)}, "
                        f"{len(splits)} splits")
        part = out[None]
    LAUNCHES["xty"] += 1
    return part[0]


def gram(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` (p, p) f32."""
    return xty(x, x)


def xty_folds_masked(x: torch.Tensor, z: torch.Tensor,
                     onehot: torch.Tensor) -> torch.Tensor:
    """Per-slot masked ``out[s] = (x · onehot[:, s])ᵀ z``, one counted launch.

    x: (m, p), z: (m, q), onehot: (m, s) slot weights (any values; the
    streamed fit passes each row's fold one-hot), all CUDA, contiguous,
    float32 or bfloat16 alike → (s, p, q) float32.  The weights scale x in
    f32; the split pass writes the bf16 terms of x·w and z into scratch
    (``split_engine.masked_planes``), then one tensor-core product sums the
    kept term pairs.
    """
    _check_operands(x, z, onehot=onehot)
    m, p = x.shape
    q, s = z.shape[1], onehot.shape[1]
    if not 1 <= s <= _MAX_GRID_YZ:
        raise ValueError(f"onehot has {s} slots: the kernel takes 1 to "
                         f"{_MAX_GRID_YZ}")
    out = torch.empty((s, p, q), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _check_grid(p)
    na, nb = split_engine.masked_planes(x.dtype)
    scratch_a = split_engine.scratch(s * p, m, na, split_engine.TILE_M,
                                     x.device)
    scratch_b = split_engine.scratch(q, m, nb, split_engine.TILE_N, x.device)
    lib = _build.load()
    fn = (lib.repro_xty_folds_masked_f32 if x.dtype == torch.float32
          else lib.repro_xty_folds_masked_bf16)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), z.data_ptr(), onehot.data_ptr(),
                scratch_a.data_ptr(), scratch_b.data_ptr(), out.data_ptr(),
                m, p, q, s, torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, "xty_folds_masked",
                    f"x {tuple(x.shape)}, z {tuple(z.shape)}, onehot "
                    f"{tuple(onehot.shape)}, {x.dtype}")
    LAUNCHES["xty_folds_masked"] += 1
    return out
