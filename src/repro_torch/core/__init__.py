"""Low-level solver layer of the port: the paper's multi-target ridge.

  ridge.RidgeCVConfig / ridge.ridge_cv   — mutualised single-shard RidgeCV
  foldstats.compute / FoldStatsAccumulator — single-pass fold statistics
                                           (downdating CV, out-of-core)
  ridge.ridge_cv_from_stats              — CV'd solve from streamed stats
  ridge.ridge_cv_reference               — seed per-fold CV (the baseline)
  scoring.pearson_r                      — encoding performance metric
  complexity                             — analytic cost model (paper §3)
"""
from repro_torch.core import complexity, foldstats, ridge, scoring  # noqa: F401
from repro_torch.core.foldstats import (  # noqa: F401
    FoldStats, FoldStatsAccumulator,
)
from repro_torch.core.ridge import (  # noqa: F401
    PAPER_LAMBDA_GRID, RidgeCVConfig, RidgeCVResult, ridge_cv,
    ridge_cv_from_stats,
)
