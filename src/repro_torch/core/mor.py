"""MOR — MultiOutput ridge baseline (paper §2.3.4, Fig. 8).

Port of ``repro/core/mor.py``: scikit-learn's ``MultiOutputRegressor``
semantics, one *independent* RidgeCV per target, so the feature-side
factorisation is recomputed for every target and λ is chosen per target.
This is the baseline whose overhead (``t · T_M`` in paper Eq. 6) the paper
shows to be impractical against the mutualised fit; it is kept without
mutualisation on purpose.

With the kernel tier on (``cfg.use_pallas``) each target's fit launches the
cross-Gram kernels of ``ridge.ridge_cv``: on the dual path ``xty`` for
``XXᵀ`` and for ``Xᵀα``, so a MOR fit makes about ``2·t`` launches.
``mor_fit_distributed`` splits the targets over the ranks of a mesh
(``core.compat``), each rank fitting its own columns.
"""
from __future__ import annotations

import torch

from repro_torch.core import ridge
from repro_torch.core.compat import Mesh


def _fit_one(X: torch.Tensor, Y: torch.Tensor, i: int,
             cfg: ridge.RidgeCVConfig) -> torch.Tensor:
    """Target ``i`` alone: a RidgeCV on the (n, 1) column."""
    return ridge.ridge_cv(X, Y[:, i:i + 1].contiguous(), cfg).weights[:, 0]


def mor_fit(X: torch.Tensor, Y: torch.Tensor,
            cfg: ridge.RidgeCVConfig = ridge.RidgeCVConfig()) -> torch.Tensor:
    """Fit t independent single-target RidgeCVs.  Returns weights (p, t).

    λ is selected *per target* (scikit-learn MultiOutput semantics), unlike
    the shared-λ mutualised path.  In the reference this is one XLA
    program whose compiler hoists the loop-invariant factorisation out of
    the per-target ``lax.map``; eager PyTorch hoists nothing, so here
    ``mor_fit`` pays the full ``t·T_M`` exactly as ``mor_fit_taskwise``
    does, and the two return the same bits.
    """
    W = torch.empty((X.shape[1], Y.shape[1]), dtype=torch.float32,
                    device=X.device)
    for i in range(Y.shape[1]):
        W[:, i] = _fit_one(X, Y, i, cfg)
    return W


def mor_fit_taskwise(X: torch.Tensor, Y: torch.Tensor,
                     cfg: ridge.RidgeCVConfig = ridge.RidgeCVConfig()
                     ) -> torch.Tensor:
    """Faithful scikit-learn/Dask MOR: one isolated fit per target, the
    factorisation recomputed t times — the ``t·T_M`` overhead of paper
    Eq. 6 physically paid (see ``mor_fit``: in eager PyTorch both pay it).
    """
    return torch.stack([_fit_one(X, Y, i, cfg)
                        for i in range(Y.shape[1])], dim=1)


def mor_fit_distributed(X: torch.Tensor, Y: torch.Tensor, mesh: Mesh,
                        axis: str = "model",
                        cfg: ridge.RidgeCVConfig = ridge.RidgeCVConfig()
                        ) -> torch.Tensor:
    """MOR parallelised over the ranks along ``axis`` (the Dask-distributed
    analog).  ``X`` (n, p) is every row; ``Y`` (n, t_local) is this rank's
    block of targets, fitted one RidgeCV per target (``mor_fit``).  → the
    full (p, t) weights, gathered on every rank.  Critical-path cost:
    c⁻¹·(T_W + t·T_M), paper Eq. 6."""
    return mesh.all_gather(mor_fit(X, Y, cfg), axis, dim=1)


__all__ = ["mor_fit", "mor_fit_distributed", "mor_fit_taskwise"]
