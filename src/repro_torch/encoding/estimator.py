"""``BrainEncoder`` — the scikit-learn-style facade over the ridge solver.

Port of ``repro/encoding/estimator.py`` for the in-memory single-device
path: ``fit(X, Y)`` resolves the plan through ``encoding.dispatch`` and runs
``core.ridge.ridge_cv``; ``predict``/``score``/``evaluate`` follow.  The
encoder runs on CUDA unless constructed with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import ridge, scoring
from repro_torch.device import as_tensor, resolve_device
from repro_torch.encoding.config import EncoderConfig
from repro_torch.encoding.dispatch import DispatchDecision, resolve

_SOLVER_LABELS = {
    "ridge": "RidgeCV", "mor": "MOR", "bmor": "B-MOR",
    "bmor_dual": "dual B-MOR", "banded": "banded RidgeCV",
}


@dataclasses.dataclass
class EncodingReport:
    """Fit result: weights, selected λ and CV curve (one batch: ``(1,)`` and
    ``(1, r)``), the swept grid, and the dispatch decision."""

    weights: torch.Tensor | None       # (p, t)
    best_lambda: np.ndarray            # (n_batches,)
    cv_scores: np.ndarray              # (n_batches, r) CV curve per batch
    lambdas: tuple[float, ...]
    decision: DispatchDecision
    band_lambdas: np.ndarray | None = None

    @property
    def solver_label(self) -> str:
        return _SOLVER_LABELS[self.decision.solver]

    def to_dict(self) -> dict:
        """Everything but the weight matrix, JSON-serialisable, in the
        reference's schema."""
        return {
            "decision": dataclasses.asdict(self.decision),
            "best_lambda": np.asarray(self.best_lambda).tolist(),
            "cv_scores": np.asarray(self.cv_scores).tolist(),
            "lambdas": list(self.lambdas),
            "band_lambdas": (None if self.band_lambdas is None
                             else np.asarray(self.band_lambdas).tolist()),
            "weights_shape": (None if self.weights is None
                              else list(self.weights.shape)),
            "weights_dtype": (None if self.weights is None
                              else str(self.weights.dtype).removeprefix(
                                  "torch.")),
            "solver_label": self.solver_label,
        }

    def to_json(self) -> str:
        import json
        return json.dumps(self.to_dict(), indent=2) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "EncodingReport":
        """Rebuild the provenance half of a report (``weights`` is None)."""
        band = d.get("band_lambdas")
        return cls(
            weights=None,
            best_lambda=np.asarray(d["best_lambda"], np.float64),
            cv_scores=np.asarray(d["cv_scores"], np.float64),
            lambdas=tuple(d["lambdas"]),
            decision=DispatchDecision(**d["decision"]),
            band_lambdas=None if band is None else np.asarray(band))

    @classmethod
    def from_json(cls, s: str) -> "EncodingReport":
        import json
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass
class EvaluationReport:
    """Held-out evaluation in the paper's metrics (§4.1–4.2)."""

    pearson_r: np.ndarray              # (t,) per-target test correlation
    r2: np.ndarray                     # (t,)
    null_r: np.ndarray                 # (n_perms, t) shuffled-stimulus control
    mean_r: float
    null_abs_r: float

    @property
    def significant(self) -> bool:
        """Aligned encoding clears the null floor (paper §4.2 criterion)."""
        return self.mean_r > 5.0 * self.null_abs_r


class BrainEncoder:
    """Multi-target brain-encoding ridge with automatic solver dispatch.

    >>> enc = BrainEncoder()                      # CUDA, kernel tier on
    >>> enc.fit(X_train, Y_train)                 # numpy arrays or tensors
    >>> r = enc.score(X_test, Y_test)             # per-target Pearson r
    >>> BrainEncoder(device="cpu", n_folds=3)     # plain versions on the CPU

    Keyword overrides are ``EncoderConfig`` fields.  Attributes set by
    ``fit``: ``report_`` (an ``EncodingReport``), ``weights_``.
    """

    def __init__(self, config: EncoderConfig | None = None,
                 device: torch.device | str | None = None, **overrides: Any):
        base = config or EncoderConfig()
        self.config = (dataclasses.replace(base, **overrides)
                       if overrides else base)
        self.device = resolve_device(device)
        self.config.resolve_use_pallas(self.device)      # fail early
        self.report_: EncodingReport | None = None
        # Set by pipeline.standardize/fit: the fitted per-column μ/σ.
        self.standardizer_ = None

    def fit(self, X, Y) -> "BrainEncoder":
        """Fit from in-memory arrays (numpy or tensors), moved to the
        encoder's device."""
        X = as_tensor(X, self.device)
        Y = as_tensor(Y, self.device)
        n, p = X.shape
        t = Y.shape[1]
        decision = resolve(self.config, n, p, t, 1, device=self.device)
        self.report_ = self._fit_ridge(X, Y, decision)
        return self

    @property
    def weights_(self) -> torch.Tensor:
        if self.report_ is None:
            raise RuntimeError("call fit() first")
        return self.report_.weights

    def predict(self, X) -> torch.Tensor:
        return ridge.predict(as_tensor(X, self.device), self.weights_)

    def score(self, X, Y) -> np.ndarray:
        """Per-target Pearson r on held-out data (the paper's metric)."""
        Y = as_tensor(Y, self.device)
        return scoring.pearson_r(Y, self.predict(X)).cpu().numpy()

    def evaluate(self, X, Y, *, n_perms: int = 10,
                 generator: torch.Generator | None = None
                 ) -> EvaluationReport:
        """Pearson r + R² + the §4.2 null-permutation control.

        The permutations come from ``generator`` (a CPU generator; default
        seeded with ``config.seed + 1``)."""
        X = as_tensor(X, self.device)
        Y = as_tensor(Y, self.device)
        preds = self.predict(X)
        r = scoring.pearson_r(Y, preds).cpu().numpy()
        r2 = scoring.r2_score(Y, preds).cpu().numpy()
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.seed + 1)
        null = scoring.null_permutation_scores(
            generator, X, Y, self.weights_, n_perms=n_perms).cpu().numpy()
        return EvaluationReport(
            pearson_r=r, r2=r2, null_r=null, mean_r=float(r.mean()),
            null_abs_r=float(np.abs(null).mean()))

    def _fit_ridge(self, X, Y, decision: DispatchDecision) -> EncodingReport:
        res = ridge.ridge_cv(X, Y, self.config.ridge_cv_config(
            decision.method, device=self.device))
        return EncodingReport(
            weights=res.weights,
            best_lambda=res.best_lambda.cpu().numpy()[None],
            cv_scores=res.cv_scores.cpu().numpy()[None, :],
            lambdas=self.config.lambdas, decision=decision)
