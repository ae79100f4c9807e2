"""Single-pass fold-aware Gram statistics (CV by downdating, not recompute).

Port of ``repro/core/foldstats.py``.  Every per-fold partial

    G_f = X_fᵀX_f        C_f = X_fᵀY_f        (plus first/second moments)

comes from one pass over the rows, and every training split derives by the
exact downdate ``G_train(f) = Σ_g G_g − G_f``; the full-data refit
statistics are the sums themselves.

In memory (``compute``), ``[G | C]`` for all folds is one launch of the
CUDA ``xty_folds`` kernel.  Streamed (``FoldStatsAccumulator``,
``compute_chunked``), the rows arrive chunk by chunk and only the
statistics stay resident: each chunk is padded to one fixed shape and
applied by ``_FixedShapeUpdate`` — a per-row slot one-hot marks each row's
fold, and ``[G | C]`` for every slot is one launch of the CUDA
``xty_folds_masked`` kernel.  The moment
statistics (``xsum``, ``ysum``, centred ``ysq``, ``count``) make validation
scores computable from the statistics alone
(``validation_scores_per_target``), which is what lets the CV'd solve run
without the rows (``ridge.ridge_cv_from_stats``).

The statistics are updated in place (``index_add_``): the (k, p, p) Gram
is the largest object of a streamed fit, and a functional update would
hold it twice.

Over several ranks (``core.compat.Mesh``), ``partial_fold_stats`` gives a
rank's per-fold partials of its row window (B-MOR, ``core.bmor``) and
``compute_sharded_chunked(mesh=)`` streams each rank's own window; the
stacked ``(k, p, ·)`` partials then reduce in one ``psum``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import as_tensor, host_view, resolve_device
from repro_torch.kernels import ops, ref


def fold_bounds(n: int, n_folds: int) -> list[tuple[int, int]]:
    """Contiguous k-fold boundaries.

    The first ``n % n_folds`` folds get the extra row, matching
    scikit-learn's ``KFold``.
    """
    if not 1 <= n_folds <= n:
        raise ValueError(f"need 1 <= n_folds <= n, got n_folds={n_folds}, "
                         f"n={n}")
    sizes = [n // n_folds + (1 if i < n % n_folds else 0)
             for i in range(n_folds)]
    bounds, start = [], 0
    for s in sizes:
        bounds.append((start, start + s))
        start += s
    return bounds


def fold_of_rows(row_ids: torch.Tensor, n_total: int,
                 n_folds: int) -> torch.Tensor:
    """Contiguous fold id of each global row (the split of
    ``fold_bounds``), for a rank whose slice of the global rows is known
    only at run time (its mesh coordinate)."""
    base, rem = divmod(n_total, n_folds)
    # Rows [0, (base+1)*rem) live in folds of size base+1; the rest size base.
    big = (base + 1) * rem
    fold_big = row_ids // max(base + 1, 1)
    fold_small = rem + (row_ids - big) // max(base, 1)
    return torch.where(row_ids < big, fold_big, fold_small).to(torch.int32)


def local_fold_bounds(fold_ids: torch.Tensor, n_folds: int
                      ) -> list[tuple[int, int]]:
    """The local row runs ``[(lo, hi), ...]`` of folds ``0..k-1`` in a
    rank's window, empty ``(lo, lo)`` for a fold the window misses.

    A rank's window is contiguous and so is each fold, so the ids are
    non-decreasing and each fold is one run; other ids raise."""
    f = fold_ids.detach().to("cpu", torch.int64)
    if f.numel() and (bool((f[1:] < f[:-1]).any()) or int(f.min()) < 0
                      or int(f.max()) >= n_folds):
        raise ValueError(f"fold ids must be non-decreasing in [0, {n_folds})"
                         f": each fold one contiguous run of the window")
    bounds, lo = [], 0
    for c in torch.bincount(f, minlength=n_folds).tolist():
        bounds.append((lo, lo + c))
        lo += c
    return bounds


def partial_fold_gc(X: torch.Tensor, Y: torch.Tensor,
                     bounds: Sequence[tuple[int, int]], *,
                     use_pallas: bool = False) -> torch.Tensor:
    """Stacked per-fold ``X_fᵀ[X_f | Y_f]`` of the local runs ``bounds``
    → (k, p, p+t) f32: ONE ``xty_folds`` launch with ``use_pallas``, the
    plain ``ref.xty_folds`` otherwise."""
    dt = torch.promote_types(X.dtype, Y.dtype)
    Xd = X.to(dt).contiguous()
    Z = torch.cat([Xd, Y.to(dt)], dim=1)
    if use_pallas:
        return ops.xty_folds(Xd, Z, bounds)
    return ref.xty_folds(Xd, Z, bounds)


def partial_fold_stats(X: torch.Tensor, Y: torch.Tensor,
                       fold_ids: torch.Tensor, n_folds: int, *,
                       use_pallas: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-fold ``{G_f, C_f}`` of a rank's rows, ``fold_ids`` the global
    fold of each local row (``fold_of_rows``) → ``(G (k, p, p),
    C (k, p, t))``.

    The reference masks the rows per fold inside ``shard_map`` (fold
    membership is traced there), paying k full products.  Here the
    window's fold runs are found on the host (``local_fold_bounds``) and
    all k partials are one ``xty_folds`` over ``X_lᵀ[X_l | Y_l]``; a fold
    the window misses is exact zeros.
    """
    GC = partial_fold_gc(X, Y, local_fold_bounds(fold_ids, n_folds),
                          use_pallas=use_pallas)
    p = X.shape[1]
    return GC[:, :, :p], GC[:, :, p:]


@dataclasses.dataclass
class FoldStats:
    """Per-fold sufficient statistics of a supervised row stream, all f32."""

    G: torch.Tensor        # (k, p, p)  per-fold XᵀX
    C: torch.Tensor        # (k, p, t)  per-fold XᵀY
    xsum: torch.Tensor     # (k, p)     per-fold Σ x
    ysum: torch.Tensor     # (k, t)     per-fold Σ y
    # Per-fold CENTRED second moment Σ (y − ȳ_f)², not the raw Σ y², which
    # cancels catastrophically in f32 for targets with large means.
    ysq: torch.Tensor      # (k, t)     per-fold Σ (y − ȳ_f)²
    count: torch.Tensor    # (k,)       per-fold row count

    @property
    def n_folds(self) -> int:
        return self.G.shape[0]

    @property
    def G_total(self) -> torch.Tensor:
        """Full-data Gram — the sums over folds ARE the refit statistics."""
        return self.G.sum(0)

    @property
    def C_total(self) -> torch.Tensor:
        return self.C.sum(0)

    def train(self, f: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Downdated training statistics ``(G_tr, C_tr)`` for split ``f``:
        ``G_total − G_f`` equals ``X_trᵀX_tr`` in exact arithmetic."""
        return self.G_total - self.G[f], self.C_total - self.C[f]


def compute(X: torch.Tensor, Y: torch.Tensor, n_folds: int, *,
            use_pallas: bool = False) -> FoldStats:
    """All per-fold statistics in one pass over the rows.

    With ``use_pallas`` (the kernel tier) the fold tiles come from one
    ``kernels.ops.xty_folds`` call on ``Xᵀ[X | Y]``: a single sweep of the
    rows for ``G`` and ``C`` together; without it the same products come
    from the plain ``kernels.ref.xty_folds``.
    """
    n, p = X.shape
    bounds = fold_bounds(n, n_folds)
    if use_pallas:
        dt = torch.promote_types(X.dtype, Y.dtype)
        Xd = X.to(dt).contiguous()
        Z = torch.cat([Xd, Y.to(dt)], dim=1)
        GC = ops.xty_folds(Xd, Z, bounds)
        del Z
        G, C = GC[:, :, :p], GC[:, :, p:]
    else:
        G = ref.xty_folds(X, X, bounds)
        C = ref.xty_folds(X, Y, bounds)
    Xf = X.float()
    Yf = Y.float()
    xsum = torch.stack([Xf[lo:hi].sum(0) for lo, hi in bounds])
    ysum = torch.stack([Yf[lo:hi].sum(0) for lo, hi in bounds])
    ysq = torch.stack([
        ((Yf[lo:hi] - Yf[lo:hi].mean(0)) ** 2).sum(0) for lo, hi in bounds])
    count = torch.tensor([hi - lo for lo, hi in bounds], dtype=torch.float32,
                         device=X.device)
    return FoldStats(G=G, C=C, xsum=xsum, ysum=ysum, ysq=ysq, count=count)


def _zero_stats(k: int, p: int, t: int, device: torch.device) -> FoldStats:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return FoldStats(G=z(k, p, p), C=z(k, p, t), xsum=z(k, p), ysum=z(k, t),
                     ysq=z(k, t), count=z(k))


class _FixedShapeUpdate:
    """The one chunk update of the streaming accumulation.

    Every chunk — fold-aligned or not, full or ragged — arrives as the same
    fixed shape: ``(chunk_rows, p)`` rows plus a per-row slot one-hot
    ``(chunk_rows, s_max)`` (zero rows are padding) and the fold index of
    each slot.  ``[G | C]`` for every slot is one masked cross-Gram
    (``xty_folds_masked``), scattered into the folds with ``index_add_``:
    unused slots map to fold 0 with all-zero contributions, and
    ``index_add_`` sums duplicate indices where ``G[slot_fold] += GC``
    would keep only the last.

    PyTorch runs eagerly, so nothing is compiled; ``compiles`` (an
    ``obs.CompileCounter``) is marked once per distinct fixed-shape
    signature ``(chunk_rows, p, q, s, dtype, use_pallas)`` the update sees
    — 1 for a fresh stream, 0 for a repeat — which is the number the
    reference's traces would be.  Under ``REPRO_OBS_STRICT=1`` a new
    signature inside an ``expect`` window raises before the update runs.
    """

    def __init__(self) -> None:
        self.compiles = obs.CompileCounter("foldstats.chunk_update")
        self._seen: set[tuple] = set()

    @property
    def compile_count(self) -> int:
        return self.compiles.count

    def __call__(self, stats: FoldStats, X: torch.Tensor, Y: torch.Tensor,
                 onehot: torch.Tensor, slot_fold: torch.Tensor, *,
                 use_pallas: bool = False) -> FoldStats:
        sig = (X.shape[0], X.shape[1], Y.shape[1], onehot.shape[1], X.dtype,
               Y.dtype, use_pallas)
        if sig not in self._seen:
            self.compiles.mark()
            self._seen.add(sig)
        p = X.shape[1]
        dt = torch.promote_types(X.dtype, Y.dtype)
        Xd = X.to(dt).contiguous()
        # One fused Xᵀ[X | Y] per slot.
        Z = torch.cat([Xd, Y.to(dt)], dim=1)
        w = onehot                                          # (m, s) f32 0/1
        if use_pallas:
            GC = ops.xty_folds_masked(Xd, Z, w.to(dt).contiguous())
        else:
            GC = ref.xty_folds_masked(Xd, Z, w.to(dt))
        del Z
        Xf, Yf = X.float(), Y.float()
        cnt = w.sum(0)                                      # (s,)
        xsum = torch.matmul(w.T, Xf)
        ysum = torch.matmul(w.T, Yf)
        # Chan et al. pairwise combination of the centred second moment:
        # M2_{a∪b} = M2_a + M2_b + (μ_a − μ_b)²·n_a n_b/(n_a+n_b) — exact,
        # and free of the Σy² − mȳ² cancellation.  An empty slot has
        # cnt = 0, so every one of its additions is exactly 0.
        mu_b = ysum / cnt.clamp(min=1.0)[:, None]
        d = Yf[None, :, :] - mu_b[:, None, :]               # (s, m, t)
        m2 = torch.einsum("ms,smt->st", w, d * d)
        del d
        n_a = stats.count[slot_fold]                        # (s,)
        mu_a = stats.ysum[slot_fold] / n_a.clamp(min=1.0)[:, None]
        both = ((n_a > 0) & (cnt > 0))[:, None]
        delta2 = torch.where(both, (mu_a - mu_b) ** 2, 0.0)
        ysq_add = m2 + delta2 * (n_a * cnt
                                 / (n_a + cnt).clamp(min=1.0))[:, None]
        stats.G.index_add_(0, slot_fold, GC[:, :, :p])
        stats.C.index_add_(0, slot_fold, GC[:, :, p:])
        stats.xsum.index_add_(0, slot_fold, xsum)
        stats.ysum.index_add_(0, slot_fold, ysum)
        stats.ysq.index_add_(0, slot_fold, ysq_add)
        stats.count.index_add_(0, slot_fold, cnt)
        return stats


# Module-level singleton: shards and repeated streams share one signature
# record, as the reference's streams share one jit cache.
_FIXED_UPDATE = _FixedShapeUpdate()


def chunk_update_compile_count() -> int:
    """Distinct fixed-shape signatures the chunk update has seen
    (monotonic, process-wide).  Take a delta around a stream: 1 for a
    fresh ``(chunk_rows, p, q, s, dtype, use_pallas)`` signature, 0 for a
    repeat, regardless of fold alignment or ragged tails.  (Alias over
    ``chunk_update_compiles().count``.)"""
    return _FIXED_UPDATE.compiles.count


def chunk_update_compiles() -> "obs.CompileCounter":
    """The chunk update's :class:`repro_torch.obs.CompileCounter` — open an
    ``expect(at_most=...)`` window around a stream to arm the recompile
    sentinel (raises at the new signature under ``REPRO_OBS_STRICT=1``)."""
    return _FIXED_UPDATE.compiles


class FoldStatsAccumulator:
    """Streaming builder of ``FoldStats`` from ordered row chunks.

    Rows arrive as host arrays (numpy, read-only chunks included) or
    tensors; each chunk is moved to ``device`` once, split or zero-padded
    to the fixed ``chunk_rows`` shape, and applied through
    ``_FixedShapeUpdate`` — fold boundaries, ragged tails and chunk/fold
    misalignment change only the mask.  Rows must arrive in global row
    order; ``finalize`` checks that exactly the owned row window was seen.

    ``chunk_rows`` pins the fixed shape up front (what the store-streaming
    callers do, so every shard shares one signature); omitted, it is taken
    from the first chunk.  ``row_start``/``row_stop`` restrict the
    accumulator to a window of the global rows (one shard's); fold
    membership always derives from the GLOBAL ``(n_total, n_folds)`` split,
    and ``combine`` merges the per-shard partials.  ``device`` holds the
    statistics (CUDA unless ``device="cpu"``).
    """

    def __init__(self, n_total: int, n_folds: int, *, row_start: int = 0,
                 row_stop: int | None = None,
                 chunk_rows: int | None = None,
                 use_pallas: bool = False,
                 device: torch.device | str | None = None):
        self.n_total = n_total
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        self.bounds = fold_bounds(n_total, n_folds)
        self.row_start = row_start
        self.row_stop = n_total if row_stop is None else row_stop
        if not 0 <= self.row_start < self.row_stop <= n_total:
            raise ValueError(
                f"need 0 <= row_start < row_stop <= n_total, got "
                f"[{row_start}, {row_stop}) with n_total={n_total}")
        if chunk_rows is not None and chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self._offset = self.row_start
        self._stats: FoldStats | None = None
        self._fixed_rows = (None if chunk_rows is None
                            else min(chunk_rows, n_total))

    def _init_stats(self, p: int, t: int) -> FoldStats:
        """Zero statistics for ``p`` features and ``t`` targets on the
        accumulator's device — the seam a subclass that accumulates another
        statistic (the whole-brain column blocks) overrides with ``_apply``."""
        return _zero_stats(len(self.bounds), p, t, self.device)

    def _max_slots(self) -> int:
        """Folds a ``_fixed_rows`` window can intersect: it fully contains
        every fold but its two ends, each of size ≥ ``min_fold``."""
        min_fold = min(hi - lo for lo, hi in self.bounds)
        return min(len(self.bounds),
                   max(1, (self._fixed_rows - 2) // min_fold + 2))

    def _slot_mask(self, m: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(onehot (fixed, s_max) f32, slot_fold (s_max,) int64) on the
        device for the ``m`` valid rows at the current offset."""
        s_max = self._max_slots()
        onehot = np.zeros((self._fixed_rows, s_max), np.float32)
        slot_fold = np.zeros((s_max,), np.int64)
        s = 0
        for f, (lo, hi) in enumerate(self.bounds):
            seg_lo = max(lo, self._offset) - self._offset
            seg_hi = min(hi, self._offset + m) - self._offset
            if seg_lo >= seg_hi:
                continue
            if s >= s_max:
                raise RuntimeError("slot bound violated (fold split bug)")
            onehot[seg_lo:seg_hi, s] = 1.0
            slot_fold[s] = f
            s += 1
        return (as_tensor(onehot, self.device),
                as_tensor(slot_fold, self.device))

    def _apply(self, Xs: torch.Tensor, Ys: torch.Tensor,
               onehot: torch.Tensor, slot_fold: torch.Tensor) -> None:
        """Apply one fixed-shape padded chunk to the running statistics.

        The single overridable seam of the streaming machinery: a subclass
        that accumulates a different statistic from the same masked chunks
        (the whole-brain column blocks) replaces only this.
        """
        self._stats = _FIXED_UPDATE(self._stats, Xs, Ys, onehot, slot_fold,
                                    use_pallas=self.use_pallas)

    def update(self, X_chunk, Y_chunk) -> None:
        m = X_chunk.shape[0]
        if self._offset + m > self.row_stop:
            raise ValueError(
                f"chunk of {m} rows at offset {self._offset} overruns "
                f"row_stop={self.row_stop}")
        X = as_tensor(X_chunk, self.device)
        Y = as_tensor(Y_chunk, self.device)
        if self._stats is None:
            self._stats = self._init_stats(X.shape[1], Y.shape[1])
        if self._fixed_rows is None:
            self._fixed_rows = m
        fixed = self._fixed_rows
        lo = 0
        while lo < m:                       # oversized batches: split
            hi = min(lo + fixed, m)
            Xs, Ys = X[lo:hi], Y[lo:hi]
            if hi - lo < fixed:             # ragged: zero-pad to the shape
                Xs = torch.cat([Xs, Xs.new_zeros(fixed - (hi - lo),
                                                 Xs.shape[1])])
                Ys = torch.cat([Ys, Ys.new_zeros(fixed - (hi - lo),
                                                 Ys.shape[1])])
            onehot, slot_fold = self._slot_mask(hi - lo)
            self._apply(Xs.contiguous(), Ys.contiguous(), onehot, slot_fold)
            self._offset += hi - lo
            lo = hi
        # Fence before returning: the host→device copy of a pinned chunk
        # is asynchronous, and a prefetched source recycles its staging
        # buffer as soon as the next chunk is requested.  Chunk updates
        # are sequentially dependent, so no pipelining is lost, and the
        # reader thread still overlaps the next read with this compute.
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def finalize(self) -> FoldStats:
        if self._stats is None or self._offset != self.row_stop:
            raise ValueError(
                f"saw rows [{self.row_start}, {self._offset}), expected the "
                f"full window [{self.row_start}, {self.row_stop})")
        return self._stats


def compute_chunked(chunks: Iterable, n_total: int, n_folds: int, *,
                    chunk_rows: int | None = None,
                    use_pallas: bool = False,
                    device: torch.device | str | None = None) -> FoldStats:
    """One-call streaming accumulation over ``(X_chunk, Y_chunk)`` batches.

    ``chunk_rows`` pins the fixed shape of the masked update up front;
    omitted, it is inferred from the first chunk.  ``use_pallas`` routes
    the heavy ``[G | C]`` contribution through the CUDA
    ``xty_folds_masked`` kernel.  Iterators with a ``close`` method (the
    prefetching store reader) are closed on every exit path.
    """
    acc = FoldStatsAccumulator(n_total, n_folds, chunk_rows=chunk_rows,
                               use_pallas=use_pallas, device=device)
    # Recompile sentinel: one fixed shape → at most one new signature for
    # the whole stream (zero when the signature is already known).  Each
    # span closes after ``update``'s stream fence, so it measures compute.
    with _FIXED_UPDATE.compiles.expect(at_most=1):
        try:
            for X_chunk, Y_chunk in chunks:
                with obs.span("fit.foldstats.chunk_update",
                              rows=int(X_chunk.shape[0])):
                    acc.update(X_chunk, Y_chunk)
        finally:
            if hasattr(chunks, "close"):
                chunks.close()
    return acc.finalize()


def _combine_pair(a: FoldStats, b: FoldStats) -> FoldStats:
    """Chan et al. pairwise combination of two per-fold partials.

    ``G``/``C``/``xsum``/``ysum``/``count`` are plain sums over disjoint row
    sets; the centred second moment needs the pairwise update
    ``M2_{a∪b} = M2_a + M2_b + (μ_a − μ_b)²·n_a n_b/(n_a+n_b)`` per fold.
    """
    n_a = a.count[:, None]                                   # (k, 1)
    n_b = b.count[:, None]
    mu_a = a.ysum / n_a.clamp(min=1.0)
    mu_b = b.ysum / n_b.clamp(min=1.0)
    both = (n_a > 0) & (n_b > 0)
    delta2 = torch.where(both, (mu_a - mu_b) ** 2, 0.0)
    ysq = a.ysq + b.ysq + delta2 * n_a * n_b / (n_a + n_b).clamp(min=1.0)
    return FoldStats(G=a.G + b.G, C=a.C + b.C, xsum=a.xsum + b.xsum,
                     ysum=a.ysum + b.ysum, ysq=ysq, count=a.count + b.count)


def combine(parts: Sequence[FoldStats]) -> FoldStats:
    """Merge per-shard partial ``FoldStats`` into the global statistics.

    Pairwise (tree) reduction: exact for the summed statistics and applies
    the Chan update to the centred moments at every merge, so the result is
    invariant (to f32 rounding) under how the rows were split into shards.
    """
    if not parts:
        raise ValueError("combine() needs at least one partial FoldStats")
    parts = list(parts)
    while len(parts) > 1:
        merged = [_combine_pair(parts[i], parts[i + 1])
                  for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            merged.append(parts[-1])
        parts = merged
    return parts[0]


def shard_row_ranges(n_total: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous near-equal row windows, one per shard (same size policy
    as ``fold_bounds``; shard windows may cut folds anywhere)."""
    if not 1 <= n_shards <= n_total:
        raise ValueError(f"need 1 <= n_shards <= n_total, got "
                         f"n_shards={n_shards}, n={n_total}")
    return fold_bounds(n_total, n_shards)


def compute_sharded_chunked(shard_streams: Sequence[Iterable], n_total: int,
                            n_folds: int, *, mesh=None,
                            data_axis: str = "data",
                            chunk_rows: int | None = None,
                            use_pallas: bool = False,
                            device: torch.device | str | None = None
                            ) -> FoldStats:
    """Sharded out-of-core accumulation along ``data_axis``.

    ``shard_streams[s]`` yields shard ``s``'s row chunks, covering exactly
    the window ``shard_row_ranges(n_total, len(shard_streams))[s]`` in
    global row order.  Each shard accumulates its own partial
    ``FoldStats``.  Without a ``mesh`` this process consumes every stream
    in turn and the partials merge with ``combine``.  With a ``mesh``
    (``core.compat``), each rank consumes only its own stream,
    ``shard_streams[mesh.axis_index(data_axis)]``, and closes the others
    unopened; then

    * the stacked ``(k, p, p+t)`` ``[G | C]`` reduce in ONE ``psum`` over
      ``data_axis``, and
    * the small moment statistics are gathered and merged with
      ``combine`` in shard order (the centred second moment needs the Chan
      update, which a sum cannot express),

    so every rank ends with the same global statistics.  ``chunk_rows``
    pins the fixed shape of the masked update, so every stream shares one
    signature.
    """
    ranges = shard_row_ranges(n_total, len(shard_streams))
    mine = range(len(shard_streams))
    if mesh is not None:
        if mesh.size(data_axis) != len(shard_streams):
            for stream in shard_streams:
                if hasattr(stream, "close"):
                    stream.close()
            raise ValueError(
                f"mesh axis {data_axis!r} has {mesh.size(data_axis)} shards "
                f"but {len(shard_streams)} shard streams were accumulated")
        mine = [mesh.axis_index(data_axis)]
        for s, stream in enumerate(shard_streams):
            if s not in mine and hasattr(stream, "close"):
                stream.close()
    parts: list[FoldStats] = []
    # Sentinel window: with chunk_rows pinned every shard shares ONE
    # signature; left to infer, ragged shard windows may pin different
    # first-chunk shapes — allow one per shard this process consumes.
    with _FIXED_UPDATE.compiles.expect(
            at_most=1 if chunk_rows else len(mine)):
        for s in mine:
            (lo, hi), stream = ranges[s], shard_streams[s]
            acc = FoldStatsAccumulator(n_total, n_folds, row_start=lo,
                                       row_stop=hi, chunk_rows=chunk_rows,
                                       use_pallas=use_pallas, device=device)
            with obs.span("fit.foldstats.shard", shard=s, row_lo=lo,
                          row_hi=hi):
                try:
                    for X_chunk, Y_chunk in stream:
                        acc.update(X_chunk, Y_chunk)
                finally:
                    if hasattr(stream, "close"):
                        stream.close()
            parts.append(acc.finalize())
    if mesh is None or len(shard_streams) == 1:
        return combine(parts)
    own = parts[0]
    p, t, k = own.G.shape[1], own.C.shape[2], own.n_folds
    GC = torch.cat([own.G, own.C], dim=-1)
    own.G = own.C = None                    # GC alone holds the partials
    GC = mesh.psum(GC, data_axis)
    small = torch.cat([own.xsum.reshape(-1), own.ysum.reshape(-1),
                       own.ysq.reshape(-1), own.count])
    gathered = mesh.all_gather(small, data_axis).reshape(
        len(shard_streams), -1)
    empty = GC[:, :0, :0]
    shards = []
    for row in gathered:
        xs, ys, yq, cnt = torch.split(row, [k * p, k * t, k * t, k])
        shards.append(FoldStats(G=empty, C=empty, xsum=xs.reshape(k, p),
                                ysum=ys.reshape(k, t), ysq=yq.reshape(k, t),
                                count=cnt))
    merged = combine(shards)
    return dataclasses.replace(merged, G=GC[..., :p], C=GC[..., p:])


class ColumnMoments:
    """Streaming per-column mean/variance over row chunks (Chan/Welford).

    The first pass of the two-pass streaming standardization
    (``pipeline.fit_chunked``): accumulates ``(count, mean, M2)`` per
    column in float64 on ``device`` (CUDA unless ``device="cpu"``), one
    read of the rows and O(columns) residency.
    """

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = resolve_device(device)
        self.count = 0.0
        self.mean: torch.Tensor | None = None
        self.m2: torch.Tensor | None = None

    def update(self, A) -> None:
        # Moved in its own dtype (no float64 → float32 demotion), widened
        # to float64 on the device.
        t = A if isinstance(A, torch.Tensor) else host_view(np.asarray(A))
        A = t.to(self.device, non_blocking=self.device.type == "cuda").double()
        n_b = float(A.shape[0])
        if n_b:
            mu_b = A.mean(0)
            m2_b = ((A - mu_b) ** 2).sum(0)
            if self.mean is None:
                self.count, self.mean, self.m2 = n_b, mu_b, m2_b
            else:
                n_a = self.count
                delta = mu_b - self.mean
                tot = n_a + n_b
                self.mean = self.mean + delta * (n_b / tot)
                self.m2 = self.m2 + m2_b + delta ** 2 * (n_a * n_b / tot)
                self.count = tot
        # The chunk may come from a recycled pinned buffer (see
        # FoldStatsAccumulator.update).
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def std(self, eps: float = 1e-6) -> torch.Tensor:
        if self.mean is None:
            raise ValueError("ColumnMoments.std(): no rows seen")
        return torch.sqrt(self.m2 / self.count) + eps


def eigenbasis_x_terms(xsum_f: torch.Tensor, G_f: torch.Tensor,
                       m: torch.Tensor, Q: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The X-only half of split ``f``'s validation scores in the eigenbasis
    ``Q``: ``u = xsum_fᵀQ`` and the centred ``Ĝ_c = QᵀG_fQ − uuᵀ/m``.

    They depend on no target, so a caller that scores many target blocks
    against one ``Q`` (the whole-brain tier) computes them once per fold.
    """
    u = torch.matmul(xsum_f, Q)                                     # (p,)
    Ghat_c = torch.matmul(Q.T, torch.matmul(G_f, Q))
    Ghat_c -= u[:, None] * u[None, :] / m
    return u, Ghat_c


def validation_scores_from_terms(
        C_f: torch.Tensor, ysum_f: torch.Tensor, ysq_f: torch.Tensor,
        m: torch.Tensor, Q: torch.Tensor, evals: torch.Tensor,
        C_tr: torch.Tensor, lambdas: torch.Tensor, scoring: str,
        u: torch.Tensor, Ghat_c: torch.Tensor) -> torch.Tensor:
    """``validation_scores_per_target`` from the fold's target statistics
    (``C_f``, ``ysum_f``, ``ysq_f``, row count ``m``) and its X-only terms
    (``eigenbasis_x_terms``), shape ``(r, t)``."""
    # Coefficients in the eigenbasis, per λ: Z_r = (Λ+λ_r)⁻¹ QᵀC_tr.
    A = torch.matmul(Q.T, C_tr)                                     # (p, t)
    Z = A[None] / (evals[None, :, None] + lambdas[:, None, None])   # (r, p, t)
    mu = (ysum_f / m)[None]                                         # (1, t) ȳ
    m2 = ysq_f[None]                                                # Σ(y−ȳ)²
    # The fold's validation statistics rotated into the eigenbasis, centred.
    Chat_c = torch.matmul(Q.T, C_f) - u[:, None] * mu
    s_hat = torch.einsum("p,rpt->rt", u, Z)                         # Σŷ
    c_xy = (Chat_c[None] * Z).sum(1)                                # Σ(y−ȳ)ŷ
    # Σ(ŷ−ŷ̄)² = diag(Z_rᵀ Ĝ_c Z_r): one (r, p, t) product, never an
    # (r, p, p) one.
    c_p2 = (Z * torch.matmul(Ghat_c, Z)).sum(1)
    if scoring == "r2":
        # Σ(y−ŷ)² = Σ(y−ȳ)² − 2Σ(y−ȳ)(ŷ−ŷ̄) + Σ(ŷ−ŷ̄)² + m(ŷ̄−ȳ)².
        mean_term = m * (s_hat / m - mu) ** 2
        ss_res = m2 - 2.0 * c_xy + c_p2 + mean_term
        return 1.0 - ss_res / (m2 + 1e-12)
    den = torch.sqrt(torch.clamp(m2 * c_p2, min=0.0)) + 1e-12
    return c_xy / den


def validation_scores_per_target(
        stats: FoldStats, f: int, Q: torch.Tensor, evals: torch.Tensor,
        C_tr: torch.Tensor, lambdas: torch.Tensor, scoring: str
        ) -> torch.Tensor:
    """Per-λ, per-TARGET validation score of split ``f``, shape ``(r, t)``.

    With ``W_r = Q (Λ+λ_r)⁻¹ QᵀC_tr``, the held-out error needs only the
    fold's own statistics — no validation rows:

        Σŷ   = xsum_fᵀ W_r          Σŷ²  = diag(W_rᵀ G_f W_r)
        Σyŷ  = diag(C_fᵀ W_r)       ȳ, Σ(y−ȳ)², m  from the moment stats.

    Everything stays in the eigenbasis and in centred form (see the
    reference's docstring for the precision argument); ``"r2"`` and ``"r"``
    match ``ridge._score`` in exact arithmetic.
    """
    m = stats.count[f]
    u, Ghat_c = eigenbasis_x_terms(stats.xsum[f], stats.G[f], m, Q)
    return validation_scores_from_terms(
        stats.C[f], stats.ysum[f], stats.ysq[f], m, Q, evals, C_tr, lambdas,
        scoring, u, Ghat_c)


def validation_scores_from_stats(
        stats: FoldStats, f: int, Q: torch.Tensor, evals: torch.Tensor,
        C_tr: torch.Tensor, lambdas: torch.Tensor, scoring: str
        ) -> torch.Tensor:
    """Per-λ validation score of split ``f`` from sufficient statistics —
    the mean over targets of ``validation_scores_per_target``, ``(r,)``."""
    return validation_scores_per_target(stats, f, Q, evals, C_tr, lambdas,
                                        scoring).mean(1)
