"""Composable encoding pipeline: detrend → split → standardize → fit → eval.

Port of ``repro/encoding/pipeline.py`` for in-memory data.  Each stage is a
plain ``PipelineState → PipelineState`` callable; ``run(X, Y, config)``
reproduces the paper's §2 preprocessing and §4 evaluation end to end on the
given device (CUDA unless ``device="cpu"``).  ``run_stages`` records each
stage's wall time in ``state.stage_seconds`` (synchronising a CUDA device
at each stage boundary).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch

from repro_torch.core import scoring
from repro_torch.data import fmri
from repro_torch.device import as_tensor, resolve_device
from repro_torch.encoding.config import EncoderConfig
from repro_torch.encoding.estimator import (BrainEncoder, EncodingReport,
                                            EvaluationReport)


@dataclasses.dataclass
class Standardizer:
    """Fitted per-column standardization (μ/σ of the *training* rows).
    ``None`` halves mean that side was never standardized."""

    mu_x: torch.Tensor | None = None          # (p,)
    sd_x: torch.Tensor | None = None          # (p,)
    mu_y: torch.Tensor | None = None          # (t,)
    sd_y: torch.Tensor | None = None          # (t,)

    def apply_x(self, X):
        return X if self.mu_x is None else (X - self.mu_x) / self.sd_x

    def apply_y(self, Y):
        return Y if self.mu_y is None else (Y - self.mu_y) / self.sd_y

    def unapply_y(self, Y_pred):
        """Map standardized-space predictions back to raw target units."""
        return Y_pred if self.mu_y is None else Y_pred * self.sd_y + self.mu_y


@dataclasses.dataclass
class PipelineState:
    """Everything flowing between stages."""

    X: torch.Tensor | None
    Y: torch.Tensor | None
    X_test: torch.Tensor | None = None
    Y_test: torch.Tensor | None = None
    standardizer: Standardizer | None = None
    encoder: BrainEncoder | None = None
    report: EncodingReport | None = None
    evaluation: EvaluationReport | None = None
    stage_seconds: dict[str, float] = dataclasses.field(default_factory=dict)


Stage = Callable[[PipelineState], PipelineState]


def detrend(tr_seconds: float = 1.49, cutoff_hz: float = 0.01) -> Stage:
    """Regress slow scanner drifts out of Y (paper §2.1.4)."""
    def detrend_stage(s: PipelineState) -> PipelineState:
        s.Y = fmri.detrend(s.Y, tr_seconds=tr_seconds, cutoff_hz=cutoff_hz)
        return s
    return detrend_stage


def _moments(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # Population σ (ddof 0), as jnp.std.
    return A.mean(0), A.std(0, correction=0) + 1e-6


def standardize(features: bool = True, targets: bool = True) -> Stage:
    """Column-wise zero-mean / unit-variance from the rows currently in
    ``state.X``/``state.Y`` (the training rows when ``split`` ran first),
    applied to the held-out rows as well."""
    def standardize_stage(s: PipelineState) -> PipelineState:
        std = Standardizer()
        if features:
            std.mu_x, std.sd_x = _moments(s.X)
            s.X = std.apply_x(s.X)
            if s.X_test is not None:
                s.X_test = std.apply_x(s.X_test)
        if targets:
            std.mu_y, std.sd_y = _moments(s.Y)
            s.Y = std.apply_y(s.Y)
            if s.Y_test is not None:
                s.Y_test = std.apply_y(s.Y_test)
        s.standardizer = std
        return s
    return standardize_stage


def split(test_frac: float = 0.1, seed: int = 0) -> Stage:
    """Paper §2.2.4: random 90/10 train/test split (CPU generator seeded
    with ``seed``)."""
    def split_stage(s: PipelineState) -> PipelineState:
        tr, te = scoring.train_test_split_indices(
            torch.Generator().manual_seed(seed), s.X.shape[0], test_frac)
        tr, te = tr.to(s.X.device), te.to(s.X.device)
        s.X_test, s.Y_test = s.X[te], s.Y[te]
        s.X, s.Y = s.X[tr], s.Y[tr]
        return s
    return split_stage


def fit(config: EncoderConfig | None = None, *,
        device: torch.device | str | None = None, **overrides) -> Stage:
    """Fit a ``BrainEncoder`` on the (training) X/Y in the state."""
    def fit_stage(s: PipelineState) -> PipelineState:
        s.encoder = BrainEncoder(config, device=device, **overrides).fit(
            s.X, s.Y)
        s.encoder.standardizer_ = s.standardizer
        s.report = s.encoder.report_
        return s
    return fit_stage


def evaluate(n_perms: int = 10, seed: int = 1,
             on_train: bool = False) -> Stage:
    """Held-out Pearson r / R² + null-permutation control (§4.1–4.2).

    Refuses to silently report in-sample numbers: without a ``split`` stage
    pass ``on_train=True``.
    """
    def evaluate_stage(s: PipelineState) -> PipelineState:
        if s.encoder is None:
            raise ValueError("evaluate() needs a fit() stage first")
        if s.X_test is None and not on_train:
            raise ValueError(
                "evaluate(): no split stage ran, so only training rows are "
                "available; add pipeline.split(...) or opt in to in-sample "
                "metrics with evaluate(on_train=True)")
        X_ev = s.X_test if s.X_test is not None else s.X
        Y_ev = s.Y_test if s.Y_test is not None else s.Y
        s.evaluation = s.encoder.evaluate(
            X_ev, Y_ev, n_perms=n_perms,
            generator=torch.Generator().manual_seed(seed))
        return s
    return evaluate_stage


def run_stages(X, Y, stages: Sequence[Stage], *,
               device: torch.device | str | None = None) -> PipelineState:
    dev = resolve_device(device)
    state = PipelineState(X=as_tensor(X, dev), Y=as_tensor(Y, dev))
    for stage in stages:
        t0 = time.perf_counter()
        state = stage(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        name = stage.__name__.removesuffix("_stage")
        state.stage_seconds[name] = (state.stage_seconds.get(name, 0.0)
                                     + time.perf_counter() - t0)
    return state


def default_stages(config: EncoderConfig | None = None, *,
                   device: torch.device | str | None = None,
                   detrend_targets: bool = True, test_frac: float = 0.1,
                   n_perms: int = 10, seed: int = 0) -> list[Stage]:
    """The paper's end-to-end recipe as a stage list (editable by callers)."""
    stages: list[Stage] = []
    if detrend_targets:
        stages.append(detrend())
    # split BEFORE standardize: μ/σ come from training rows only.
    stages += [split(test_frac=test_frac, seed=seed), standardize(),
               fit(config, device=device),
               evaluate(n_perms=n_perms, seed=seed + 1)]
    return stages


def run(X, Y, config: EncoderConfig | None = None, *,
        device: torch.device | str | None = None, **kwargs) -> PipelineState:
    """One-call pipeline: ``run(X, Y, EncoderConfig(...), device=...)``."""
    return run_stages(X, Y, default_stages(config, device=device, **kwargs),
                      device=device)
