"""Checked launchers of the CUDA cross-Gram kernels (``csrc/gram.cu``).

Port of ``repro/kernels/gram.py``: ``xty`` (``XᵀY``; ``gram`` is
``xty(x, x)``), ``xty_folds`` (per-fold ``X_fᵀY_f``) and
``xty_folds_masked`` (per-slot ``(X·w_s)ᵀZ``, the streamed chunk update),
all on the split-bf16 tensor-core engine; they allocate the engine's
scratch with ``kernels.split_engine``.  ``xty`` cuts the rows of an output
too small to fill the card into ``row_splits`` K ranges, run together in
one product, and adds the partials in order.  Each wrapper takes CUDA
tensors only, checks them, allocates the f32 output, launches on the
current stream, raises on a launch error and counts the launch in
``LAUNCHES``.  The build happens at the first launch, so this module
imports on a host without ``nvcc``; ``kernels.ops`` routes CPU tensors to
the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build, split_engine

_MAX_GRID_YZ = 65535
_MAX_FOLDS = 64      # the folds' bounds go by value (kMaxFolds in gram.cu)
_MAX_SPLITS = 64     # kMaxSplits in gram.cu
# row_splits' time model, in the engine's stage times (one 32-row stage of
# one tile): a range has at least 8 stages (256 rows), and a block costs 4
# stages beside its own (filling the ring, storing its tile).
_MIN_SPLIT_STAGES = 8
_BLOCK_STAGES = 4

# Launches per kernel since the last ``reset_launches()``.
LAUNCHES: dict[str, int] = {"xty": 0, "xty_folds": 0,
                           "xty_folds_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_operands(x: torch.Tensor, y: torch.Tensor,
                    **more: torch.Tensor) -> None:
    """CUDA, 2-D, one device and dtype (f32 or bf16), one row count: what
    every kernel here takes."""
    ops = {"x": x, "y": y, **more}
    for name, t in ops.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
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


def _check_contiguous(**ops: torch.Tensor) -> None:
    """Row-major operands, for the kernels that read rows in place."""
    for name, t in ops.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major); pass "
                             f"{name}.contiguous()")


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


def row_splits(n: int, p: int, q: int, sms: int = 132) -> int:
    """Rows per K range ``xty`` cuts an (n, p) × (n, q) product into; 0 for
    one range (``ref.split_ranges`` lists the ranges).

    The engine runs one 256-thread block an SM (up to 255 registers each)
    per 128 × ``tile_n(q)`` output tile and K range.  An output of at
    least ``sms`` tiles fills the card as it is: one range.  Else the
    ranges are whole 32-row stages of one length (the last takes the
    rest), each at least 256 rows, at most 64 of them; of those, the count
    S with the least modelled time, ⌈tiles·S / sms⌉ waves of (stages a
    range + 4), fewer ranges on a tie (one range where there are too few
    rows).
    """
    tiles = -(-p // split_engine.TILE_M) * -(-q // split_engine.tile_n(q))
    stages = -(-n // split_engine.STAGE_K)
    if tiles >= sms:
        return 0

    def cost(per: int) -> int:
        waves = -(-tiles * -(-stages // per) // sms)
        return waves * (per + _BLOCK_STAGES)

    best = stages
    for per in range(stages - 1, _MIN_SPLIT_STAGES - 1, -1):
        if -(-stages // per) <= _MAX_SPLITS and cost(per) < cost(best):
            best = per
    return 0 if best == stages else best * split_engine.STAGE_K


def _check_grid(p: int) -> None:
    if -(-p // split_engine.TILE_M) > _MAX_GRID_YZ:
        raise ValueError(f"p={p} exceeds the kernel's grid limit "
                         f"{_MAX_GRID_YZ * split_engine.TILE_M}")


def xty(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``XᵀY`` in f32, one counted launch.  (n, p), (n, q) → (p, q).

    x and y: CUDA, 2-D, float32 or bfloat16 alike, in any layout: the split
    passes read them through their strides, so a transposed view (the dual
    ``XXᵀ``'s) costs no copy.  On the split-bf16 engine: the bf16 terms of
    x and y (``split_engine.folds_planes``; written once where y is x, as
    in ``gram``), then one tensor-core product of the kept term pairs.  An
    output with too few tiles to fill the card runs over ``row_splits`` K
    ranges at once into an (S, p, q) scratch, and a second kernel adds the
    partials in split order (no atomics: repeated calls are bitwise equal;
    ``ref.xty_split`` is the plain model).  The engine's non-finite rule
    holds: NaN where the plain version is NaN, non-finite (NaN) where it is
    ±Inf, finite entries within 1e-4·max|plain|.
    """
    _check_operands(x, y)
    n, p = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _xty_rows(x, y, row_splits(n, p, y.shape[1], sms))


def _xty_rows(x: torch.Tensor, y: torch.Tensor, rows: int) -> torch.Tensor:
    """``xty`` over K ranges of ``rows`` rows each (0: one range; whole
    32-row stages, at most 64 ranges, or the kernel refuses) → (p, q);
    checked operands."""
    n, p = x.shape
    q = y.shape[1]
    splits = -(-n // rows) if 0 < rows < n else 1
    out = torch.empty((p, q), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    same = (x.data_ptr() == y.data_ptr() and x.shape == y.shape
            and x.stride() == y.stride())
    na, nb = _xty_scratch_numel(n, p, q, x.dtype, same)
    scratch_a = torch.empty(na, dtype=torch.bfloat16, device=x.device)
    scratch_b = scratch_a if same else torch.empty(
        nb, dtype=torch.bfloat16, device=x.device)
    part = (torch.empty((splits, p, q), dtype=torch.float32,
                        device=x.device) if splits > 1 else out)
    lib = _build.load()
    fn = lib.repro_xty_f32 if x.dtype == torch.float32 else lib.repro_xty_bf16
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), x.stride(0), x.stride(1), y.data_ptr(),
                y.stride(0), y.stride(1), int(same), scratch_a.data_ptr(),
                scratch_b.data_ptr(), part.data_ptr(), out.data_ptr(), n, p,
                q, rows, torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
    _build.check_rc(lib, rc, "xty", f"x {tuple(x.shape)} strides "
                    f"{x.stride()}, y {tuple(y.shape)} strides {y.stride()}"
                    f", {splits} row ranges of {rows}, {x.dtype}")
    LAUNCHES["xty"] += 1
    return out


def _xty_scratch_numel(n: int, p: int, q: int, dtype: torch.dtype,
                       same: bool) -> tuple[int, int]:
    """bf16 elements of ``xty``'s scratch: the term planes of x and of y;
    where y is x, one split (rows padded for both tiles) and no second."""
    planes = split_engine.folds_planes(dtype)[0]
    if same:
        return split_engine.scratch_numel(
            p, n, planes, split_engine.shared_tile(q)), 0
    return (split_engine.scratch_numel(p, n, planes, split_engine.TILE_M),
            split_engine.scratch_numel(q, n, planes,
                                       split_engine.tile_n(q)))


def gram(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` (p, p) f32: ``xty(x, x)``, one split for both sides."""
    return xty(x, x)


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
    _check_contiguous(x=x, y=y)
    b = _check_bounds(bounds, x.shape[0])
    p, q, k = x.shape[1], y.shape[1], len(b)
    out = torch.empty((k, p, q), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rows = max(hi - lo for lo, hi in b)
    na, nb = split_engine.folds_planes(x.dtype)
    scratch_a = split_engine.scratch(p, rows, na, split_engine.TILE_M,
                                     x.device)
    scratch_b = split_engine.scratch(q, rows, nb, split_engine.tile_n(q),
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
    _check_contiguous(x=x, z=z, onehot=onehot)
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
    scratch_b = split_engine.scratch(q, m, nb, split_engine.tile_n(q),
                                     x.device)
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
