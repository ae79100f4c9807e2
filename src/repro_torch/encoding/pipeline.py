"""Composable encoding pipeline: detrend → split → standardize → fit → eval.

Port of ``repro/encoding/pipeline.py``.  Each stage is a plain
``PipelineState → PipelineState`` callable; ``run(X, Y, config)``
reproduces the paper's §2 preprocessing and §4 evaluation end to end on the
given device (CUDA unless ``device="cpu"``).  Out of core,
``run_store(store, config)`` streams a ``RunStore`` through the two-pass
standardize + fold-statistics fit (``fit_chunked``) without materialising
the rows.  ``run_stages`` and ``run_store`` record each stage's wall time
in ``state.stage_seconds`` (synchronising a CUDA device at each stage
boundary); ``fit_chunked`` adds its passes as ``fit_chunked.moments``,
``fit_chunked.stats`` and ``fit_chunked.solve``.
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
    # Out-of-core source (a RunStore) instead of materialised X/Y: stages
    # that need the rows stream them chunk by chunk.
    store: "object | None" = None
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


def streaming_moments(chunks, *, device: torch.device | str | None = None
                      ) -> tuple[torch.Tensor, ...]:
    """First streaming pass: per-column μ/σ of X and Y over the chunks.

    Returns ``(mu_x, sd_x, mu_y, sd_y)`` as float32 tensors on ``device``,
    accumulated in float64 (``foldstats.ColumnMoments``), so the streamed
    fit standardizes like ``standardize()`` does on materialised rows.
    A closable source is closed on every exit path.
    """
    from repro_torch.core.foldstats import ColumnMoments

    mx, my = ColumnMoments(device), ColumnMoments(device)
    try:
        for X_c, Y_c in chunks:
            mx.update(X_c)
            my.update(Y_c)
    finally:
        if hasattr(chunks, "close"):
            chunks.close()
    return (mx.mean.float(), mx.std().float(), my.mean.float(),
            my.std().float())


def _on_device(src, device: torch.device, std: Standardizer | None,
               marks: dict):
    """Chunks of ``src`` as tensors on ``device``, standardized by ``std``;
    ``marks["stats_end"]`` is stamped when ``src`` is exhausted (every
    chunk update has then returned, fenced).  Closes ``src`` on every exit
    path."""
    try:
        for X_c, Y_c in src:
            X = as_tensor(X_c, device)
            Y = as_tensor(Y_c, device)
            if std is not None:
                X, Y = std.apply_x(X.float()), std.apply_y(Y.float())
            yield X, Y
        marks["stats_end"] = time.perf_counter()
    finally:
        if hasattr(src, "close"):
            src.close()


def fit_chunked(config: EncoderConfig | None = None, *,
                chunk_rows: int = 1024, standardize: bool | None = None,
                device: torch.device | str | None = None,
                **overrides) -> Stage:
    """Out-of-core fit stage: stream the training rows in ``chunk_rows``
    batches through ``BrainEncoder.fit_chunks``.

    Sources, in priority order: ``state.store`` (a ``RunStore`` — rows are
    memory-mapped and streamed, ``(n, p)`` is never materialised) or the
    in-memory ``state.X``/``state.Y`` (sliced lazily, standardize-free by
    default so it matches a plain ``fit()`` on the same rows).

    ``standardize`` defaults to True for a store source.  When on, the
    stage makes two streaming passes: a ``ColumnMoments`` pass for the
    per-column μ/σ of X and Y, then the fold-statistics pass over the
    chunks standardized on the device.  Both passes over a store are
    background-prefetched when ``config.prefetch`` is on (into pinned
    buffers on CUDA).
    """
    def fit_chunked_stage(s: PipelineState) -> PipelineState:
        encoder = BrainEncoder(config, device=device, **overrides)
        dev = encoder.device
        if s.store is not None:
            encoder._check_store_folds(s.store)
            n = s.store.shape[0]
            cfg = encoder.config
            make_chunks = lambda: s.store.iter_chunks(       # noqa: E731
                chunk_rows, prefetch=cfg.prefetch,
                prefetch_depth=cfg.prefetch_depth,
                pin_memory=dev.type == "cuda")
        else:
            if s.X is None:
                raise ValueError("fit_chunked needs state.store or state.X")
            n = s.X.shape[0]
            make_chunks = lambda: (                                # noqa: E731
                (s.X[lo:lo + chunk_rows], s.Y[lo:lo + chunk_rows])
                for lo in range(0, n, chunk_rows))
        do_std = standardize if standardize is not None \
            else s.store is not None

        def stamp(name: str, since: float) -> float:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            s.stage_seconds[f"fit_chunked.{name}"] = now - since
            return now

        t0 = time.perf_counter()
        if do_std:
            mu_x, sd_x, mu_y, sd_y = streaming_moments(make_chunks(),
                                                       device=dev)
            s.standardizer = Standardizer(mu_x=mu_x, sd_x=sd_x,
                                          mu_y=mu_y, sd_y=sd_y)
            t0 = stamp("moments", t0)
        source = make_chunks()
        marks: dict[str, float] = {}
        s.encoder = encoder.fit_chunks(
            _on_device(source, dev, s.standardizer if do_std else None,
                       marks),
            n_total=n, chunk_rows=chunk_rows)
        s.stage_seconds["fit_chunked.stats"] = marks["stats_end"] - t0
        stamp("solve", marks["stats_end"])
        # The device generator hides the prefetcher from fit_chunks; fold
        # the fit pass's overlap telemetry back into stream_stats_.
        src_stats = getattr(source, "stats", None)
        if src_stats is not None:
            s.encoder.stream_stats_.update(
                chunks=src_stats.chunks, bytes_staged=src_stats.bytes_staged,
                read_stall_s=src_stats.read_stall_s,
                compute_stall_s=src_stats.compute_stall_s)
        s.encoder.standardizer_ = s.standardizer
        s.report = s.encoder.report_
        return s
    return fit_chunked_stage


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
    return _run(PipelineState(X=as_tensor(X, dev), Y=as_tensor(Y, dev)),
                stages, dev)


def _run(state: PipelineState, stages: Sequence[Stage],
         dev: torch.device) -> PipelineState:
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


def run_store(store, config: EncoderConfig | None = None, *,
              chunk_rows: int = 8192, standardize: bool = True,
              device: torch.device | str | None = None,
              **overrides) -> PipelineState:
    """One-call out-of-core pipeline: stream a ``RunStore`` through the
    two-pass standardize + fold-statistics fit without materialising rows.

    Held-out evaluation needs rows that fit in memory: evaluate a separate
    test set with ``state.encoder.evaluate`` after applying
    ``state.standardizer``.
    """
    dev = resolve_device(device)
    return _run(PipelineState(X=None, Y=None, store=store),
                [fit_chunked(config, chunk_rows=chunk_rows,
                             standardize=standardize, device=dev,
                             **overrides)], dev)
