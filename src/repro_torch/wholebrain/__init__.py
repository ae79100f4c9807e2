"""Target-axis streaming tier: whole-brain fits on one card.

Port of ``repro/wholebrain``.  Composes with the row-streaming tier
(``data.store`` + ``core.foldstats``) along the other axis: rows stream in
chunks, targets stream in column blocks, and device memory is
``O(p² + r·p·t_block)`` — independent of both ``n`` and ``t``.

* ``stats`` — ``ColumnBlockAccumulator``: per-block ``(k, p, t_block)``
  statistics from column windows of the store, one ``xty_folds_masked``
  launch per chunk, one fixed shape for all blocks.
* ``solver`` — ``fit_wholebrain``: column-blocked CV ridge reusing the
  ``k+1`` eigendecompositions across every block.
* ``artifact`` — ``BundleWriter``: weight shards appended as blocks
  finish, one atomic ``bundle.json`` commit.

``BrainEncoder.fit(store=...)`` routes here when dispatch decides the
target axis breaks ``device_memory_budget`` (method ``"colblocked"``).
"""
from repro_torch.wholebrain.artifact import BundleWriter
from repro_torch.wholebrain.solver import WholebrainResult, fit_wholebrain
from repro_torch.wholebrain.stats import (
    ColumnBlockAccumulator, ColumnBlockStats, colblock_update_compile_count,
    column_blocks,
)

__all__ = [
    "BundleWriter",
    "ColumnBlockAccumulator",
    "ColumnBlockStats",
    "WholebrainResult",
    "colblock_update_compile_count",
    "column_blocks",
    "fit_wholebrain",
]
