"""Low-level solver layer of the port: the paper's multi-target ridge.

  ridge.RidgeCVConfig / ridge.ridge_cv   — mutualised single-shard RidgeCV
  foldstats.compute / FoldStatsAccumulator — single-pass fold statistics
                                           (downdating CV, out-of-core)
  ridge.ridge_cv_from_stats              — CV'd solve from streamed stats
  ridge.ridge_cv_reference               — seed per-fold CV (the baseline)
  scoring.pearson_r                      — encoding performance metric
  mor.mor_fit / mor.mor_fit_taskwise     — MOR baseline, one RidgeCV per
                                           target (§2.3.4)
  bmor.bmor_fit / bmor.bmor_fit_dual     — B-MOR over a mesh of ranks
                                           (Alg. 1, Eq. 7)
  mor.mor_fit_distributed                — MOR over a mesh of ranks
  compat.make_mesh / compat.Mesh         — torch.distributed mesh, psum,
                                           gather (the shard_map shims)
  banded.banded_ridge_cv                 — per-band λ (paper ref [13])
  complexity                             — analytic cost model (paper §3)
"""
from repro_torch.core import (  # noqa: F401
    banded, bmor, compat, complexity, foldstats, mor, ridge, scoring,
)
from repro_torch.core.foldstats import (  # noqa: F401
    FoldStats, FoldStatsAccumulator,
)
from repro_torch.core.ridge import (  # noqa: F401
    PAPER_LAMBDA_GRID, RidgeCVConfig, RidgeCVResult, ridge_cv,
    ridge_cv_from_stats,
)
