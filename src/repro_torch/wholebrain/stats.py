"""Column-blocked fold statistics — the target-axis streaming tier.

Port of ``repro/wholebrain/stats.py``.  The row-streaming tier
(``foldstats.FoldStatsAccumulator``) bounds memory in ``n`` but still holds
the full ``(k, p, t)`` cross-covariance ``C`` — at the paper's whole-brain
scale (Table 1: t = 264,805 targets, p = 16,384) that one tensor is 92 GB.
This module blocks the TARGET axis the same way the row tier blocks rows:

* the shared statistics (``G`` (k, p, p), ``xsum``, ``count``) depend only
  on ``X`` and are accumulated once, by the row tier's fixed-shape masked
  update fed zero-width ``Y`` chunks;
* the per-target statistics (``C`` (k, p, t_block), ``ysum``, ``ysq``) are
  accumulated per column block by ``ColumnBlockAccumulator`` — one pass
  over the rows per block, touching only that block's ``Y`` column window.

Every block runs at one fixed padded width ``t_pad`` (the ragged last block
is zero-padded and sliced after), so all blocks present one shape to the
update, as the row tier's chunks do.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import foldstats
from repro_torch.kernels import ops, ref


def column_blocks(t: int, t_block: int) -> list[tuple[int, int]]:
    """Contiguous target-column windows of width ``t_block`` (ragged tail).

    ``t_block >= 2`` unless it covers everything: the reference refuses
    width 1, whose GEMMs lower to gemv with another reduction order.
    """
    if t < 1:
        raise ValueError(f"need t >= 1, got t={t}")
    if t_block < 2 and t_block < t:
        raise ValueError(
            f"t_block must be >= 2 (width-1 GEMMs are gemv and break the "
            f"bitwise column-slice identity), got t_block={t_block}")
    t_block = min(t_block, t)
    return [(lo, min(lo + t_block, t)) for lo in range(0, t, t_block)]


@dataclasses.dataclass
class ColumnBlockStats:
    """Per-fold sufficient statistics of ONE target-column window: the
    target-dependent half of ``foldstats.FoldStats``, all f32."""

    C: torch.Tensor        # (k, p, t_pad)  per-fold XᵀY over the window
    ysum: torch.Tensor     # (k, t_pad)     per-fold Σ y
    ysq: torch.Tensor      # (k, t_pad)     per-fold centred Σ (y − ȳ_f)²
    count: torch.Tensor    # (k,)           per-fold row count

    @property
    def C_total(self) -> torch.Tensor:
        return self.C.sum(0)


class _ColumnBlockUpdate:
    """The one chunk update of the per-block accumulation.

    The target-block mirror of ``foldstats._FixedShapeUpdate``: the same
    masked slot layout and Chan centred-moment merge, without the
    ``G``/``xsum`` terms, which are shared across blocks.  ``C`` for every
    slot is one ``xty_folds_masked`` launch on the block's ``Y`` columns
    (the CUDA kernel on the kernel tier, ``kernels.ref`` otherwise),
    scattered into the folds with ``index_add_``.

    ``compile_count`` counts the distinct fixed-shape signatures
    ``(chunk_rows, p, t_pad, s, dtype, use_pallas)`` seen — PyTorch runs
    eagerly, so this is the number of traces the reference's one jitted
    update would make.  (The reference also exposes an
    ``obs.CompileCounter`` with a raising ``expect``; the port has none
    until ROADMAP queue 1 item 10.)
    """

    def __init__(self) -> None:
        self._seen: set[tuple] = set()

    @property
    def compile_count(self) -> int:
        return len(self._seen)

    def __call__(self, stats: ColumnBlockStats, X: torch.Tensor,
                 Y: torch.Tensor, onehot: torch.Tensor,
                 slot_fold: torch.Tensor, *,
                 use_pallas: bool = False) -> ColumnBlockStats:
        self._seen.add((X.shape[0], X.shape[1], Y.shape[1], onehot.shape[1],
                        X.dtype, Y.dtype, use_pallas))
        dt = torch.promote_types(X.dtype, Y.dtype)
        w = onehot                                          # (m, s) f32 0/1
        if use_pallas:
            Cb = ops.xty_folds_masked(X.to(dt).contiguous(),
                                      Y.to(dt).contiguous(),
                                      w.to(dt).contiguous())  # (s, p, t_pad)
        else:
            Cb = ref.xty_folds_masked(X.to(dt), Y.to(dt), w.to(dt))
        Yf = Y.float()
        cnt = w.sum(0)                                      # (s,)
        ysum = torch.matmul(w.T, Yf)
        # Chan pairwise combination, as the row tier's: every term is
        # per-column, so the block is a column slice of the full width.
        mu_b = ysum / cnt.clamp(min=1.0)[:, None]
        d = Yf[None, :, :] - mu_b[:, None, :]               # (s, m, t_pad)
        m2 = torch.einsum("ms,smt->st", w, d * d)
        del d
        n_a = stats.count[slot_fold]                        # (s,)
        mu_a = stats.ysum[slot_fold] / n_a.clamp(min=1.0)[:, None]
        both = ((n_a > 0) & (cnt > 0))[:, None]
        delta2 = torch.where(both, (mu_a - mu_b) ** 2, 0.0)
        ysq_add = m2 + delta2 * (n_a * cnt
                                 / (n_a + cnt).clamp(min=1.0))[:, None]
        stats.C.index_add_(0, slot_fold, Cb)
        stats.ysum.index_add_(0, slot_fold, ysum)
        stats.ysq.index_add_(0, slot_fold, ysq_add)
        stats.count.index_add_(0, slot_fold, cnt)
        return stats


# Module-level singleton: every block of every stream shares one signature
# record, as the reference's blocks share one jit cache.
_COLBLOCK_UPDATE = _ColumnBlockUpdate()


def colblock_update_compile_count() -> int:
    """Distinct fixed-shape signatures the column-block update has seen
    (monotonic, process-wide).  Take a delta around a blocked fit: 1 for a
    fresh ``(chunk_rows, p, t_pad, s, dtype, use_pallas)`` signature
    however many blocks stream, 0 for a repeat.  The reference's
    ``colblock_update_compiles()`` counter object comes with ROADMAP
    queue 1 item 10; the port has the count only."""
    return _COLBLOCK_UPDATE.compile_count


class ColumnBlockAccumulator(foldstats.FoldStatsAccumulator):
    """Streaming accumulator of ``ColumnBlockStats`` for one column window.

    Reuses the row tier's machinery — chunk splitting, zero-row padding,
    slot masks, offsets, the finalize contract — and replaces only the
    statistic (the ``_init_stats``/``_apply`` seams): incoming ``Y`` chunks
    carry the block's real columns and are zero-padded on the column axis
    to the fixed ``t_pad``.  Padded columns accumulate exact zeros and are
    sliced away by the solver.  ``device`` holds the statistics (CUDA
    unless ``device="cpu"``).
    """

    def __init__(self, n_total: int, n_folds: int, t_pad: int, *,
                 row_start: int = 0, row_stop: int | None = None,
                 chunk_rows: int | None = None,
                 use_pallas: bool = False,
                 device: torch.device | str | None = None):
        if t_pad < 1:
            raise ValueError(f"t_pad must be >= 1, got {t_pad}")
        super().__init__(n_total, n_folds, row_start=row_start,
                         row_stop=row_stop, chunk_rows=chunk_rows,
                         use_pallas=use_pallas, device=device)
        self.t_pad = t_pad

    def _init_stats(self, p: int, t: int) -> ColumnBlockStats:
        if t > self.t_pad:
            raise ValueError(f"chunk has {t} target columns but the fixed "
                             f"block width is t_pad={self.t_pad}")
        k = len(self.bounds)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)
        return ColumnBlockStats(C=z(k, p, self.t_pad), ysum=z(k, self.t_pad),
                                ysq=z(k, self.t_pad), count=z(k))

    def _apply(self, Xs: torch.Tensor, Ys: torch.Tensor,
               onehot: torch.Tensor, slot_fold: torch.Tensor) -> None:
        if Ys.shape[1] < self.t_pad:        # ragged block: zero-pad columns
            Yp = Ys.new_zeros(Ys.shape[0], self.t_pad)
            Yp[:, :Ys.shape[1]] = Ys
            Ys = Yp
        self._stats = _COLBLOCK_UPDATE(self._stats, Xs, Ys, onehot,
                                       slot_fold, use_pallas=self.use_pallas)


__all__ = ["ColumnBlockAccumulator", "ColumnBlockStats", "column_blocks",
           "colblock_update_compile_count"]
