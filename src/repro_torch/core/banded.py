"""Banded ridge regression — feature-space selection (la Tour et al. 2022,
the paper's ref [13]).

Port of ``repro/core/banded.py``.  Several feature *spaces* (bands) are
concatenated and each band b gets its own λ_b:

    W* = argmin ‖Y − Σ_b X_b W_b‖² + Σ_b λ_b ‖W_b‖².

The Tikhonov substitution ``X̃ = X·diag(1/√λ_f)`` (λ_f constant within a
band) reduces one candidate to standard ridge at λ = 1, ``W =
diag(1/√λ_f)·W̃``: one factorisation per candidate and CV fold, the
candidates drawn by random search.  The Gram, ``XᵀY`` and the projections
are plain f32 ``torch.matmul`` (the reference leaves them to XLA; no
kernel of its own), so they follow the caller's TF32 switch, which the
port keeps off.  The candidates come from a ``torch.Generator`` and differ
from the reference's ``jax.random`` draw for the same seed; pass
``candidates=`` to fit a given draw.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.foldstats import fold_bounds


@dataclasses.dataclass(frozen=True)
class BandedConfig:
    bands: tuple[int, ...]                 # feature count per band (sum = p)
    n_candidates: int = 16                 # sampled band-weight vectors
    log_lambda_range: tuple[float, float] = (-2.0, 4.0)
    n_folds: int = 3
    jitter: float = 1e-6


def _feature_lambdas(band_lams: torch.Tensor, bands: Sequence[int]
                     ) -> torch.Tensor:
    """Expand per-band λ to per-feature λ.  band_lams: (B,) → (p,)."""
    return torch.cat([band_lams[i].expand(n) for i, n in enumerate(bands)])


def _gram(Xs: torch.Tensor) -> torch.Tensor:
    """``X̃ᵀX̃`` in f32 (its own function so a caller can time it)."""
    return torch.matmul(Xs.T, Xs)


def solve_banded(X: torch.Tensor, Y: torch.Tensor, band_lams: torch.Tensor,
                 bands: Sequence[int], jitter: float = 1e-6) -> torch.Tensor:
    """Closed-form banded ridge for one candidate.  → W (p, t)."""
    band_lams = torch.as_tensor(band_lams, dtype=torch.float32,
                                device=X.device)
    lam_f = _feature_lambdas(band_lams, bands)
    scale = 1.0 / torch.sqrt(lam_f)
    Xs = X * scale[None, :]
    G = _gram(Xs)
    # The jitter lands on the fresh Gram's diagonal: the same sums as
    # adding jitter·I, without a p×p identity.
    G.diagonal().add_(jitter)
    evals, Q = torch.linalg.eigh(G)
    del G
    XtY = torch.matmul(Xs.T, Y.float())
    del Xs
    z = torch.matmul(Q.T, XtY)
    z = z / (evals + 1.0)[:, None]
    W_tilde = torch.matmul(Q, z)
    return W_tilde * scale[:, None]


@dataclasses.dataclass
class BandedResult:
    weights: torch.Tensor          # (p, t)
    band_lambdas: torch.Tensor     # (B,) winning candidate
    cv_scores: torch.Tensor        # (n_candidates,)
    candidates: torch.Tensor       # (n_candidates, B)


def draw_candidates(generator: torch.Generator, cfg: BandedConfig
                    ) -> torch.Tensor:
    """``n_candidates`` band-λ vectors, log-uniform over
    ``cfg.log_lambda_range``, drawn on the generator's device."""
    lo, hi = cfg.log_lambda_range
    u = torch.rand((cfg.n_candidates, len(cfg.bands)), generator=generator,
                   device=generator.device)
    return 10.0 ** torch.clamp(u * (hi - lo) + lo, min=lo)


def banded_ridge_cv(generator: torch.Generator | None, X: torch.Tensor,
                    Y: torch.Tensor, cfg: BandedConfig, *,
                    candidates: torch.Tensor | None = None) -> BandedResult:
    """Random-search banded RidgeCV (one factorisation per candidate/fold).

    The candidates come from ``generator`` (``draw_candidates``), or, given
    ``candidates`` (shape ``(n_candidates, B)``), are taken as they are.
    Folds are the contiguous ``fold_bounds`` of the reference; each is
    scored by its validation R² over all targets.
    """
    n, p = X.shape
    if sum(cfg.bands) != p:
        raise ValueError(f"bands {cfg.bands} sum to {sum(cfg.bands)} but X "
                         f"has {p} features")
    if candidates is None:
        if generator is None:
            raise ValueError("banded_ridge_cv needs a generator or "
                             "candidates=")
        candidates = draw_candidates(generator, cfg)
    cands = torch.as_tensor(candidates, dtype=torch.float32).to(X.device)
    if cands.ndim != 2 or cands.shape[1] != len(cfg.bands):
        raise ValueError(f"candidates of shape {tuple(cands.shape)}; want "
                         f"(n_candidates, {len(cfg.bands)})")
    bounds = fold_bounds(n, cfg.n_folds)
    cv = []
    for band_lams in cands:
        scores = []
        for lo, hi in bounds:
            X_val, Y_val = X[lo:hi], Y[lo:hi].float()
            X_tr = torch.cat([X[:lo], X[hi:]])
            Y_tr = torch.cat([Y[:lo], Y[hi:]])
            W = solve_banded(X_tr, Y_tr, band_lams, cfg.bands, cfg.jitter)
            del X_tr, Y_tr
            pred = torch.matmul(X_val.float(), W)
            ss_res = ((Y_val - pred) ** 2).sum()
            mu = Y_val.mean(0, keepdim=True)
            ss_tot = ((Y_val - mu) ** 2).sum()
            scores.append(1.0 - ss_res / torch.clamp(ss_tot, min=1e-12))
        cv.append(torch.stack(scores).mean())
    cv = torch.stack(cv)
    best = torch.argmax(cv)
    W = solve_banded(X, Y, cands[best], cfg.bands, cfg.jitter)
    return BandedResult(weights=W, band_lambdas=cands[best], cv_scores=cv,
                        candidates=cands)


__all__ = ["BandedConfig", "BandedResult", "banded_ridge_cv",
           "draw_candidates", "solve_banded"]
