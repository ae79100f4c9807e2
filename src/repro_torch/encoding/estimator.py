"""``BrainEncoder`` — the scikit-learn-style facade over the ridge solver.

Port of ``repro/encoding/estimator.py``: ``fit(X, Y)`` resolves the plan
through ``encoding.dispatch`` and runs the chosen solver —
``core.ridge.ridge_cv``, B-MOR or dual B-MOR (``core.bmor``) over the
ranks of ``torch.distributed``, the per-target MOR baseline
(``core.mor``) or banded ridge (``core.banded``); ``fit(store=)`` and
``fit_chunks`` stream the rows of a ``RunStore`` (or any ordered chunk
source) through ``foldstats.FoldStatsAccumulator`` — each rank its own
row window when the plan has several data shards — and solve from the
statistics alone (``ridge.ridge_cv_from_stats``), or — when even the
``(k, p, t)`` statistics break the budget — block the targets through
``wholebrain.fit_wholebrain``; ``predict``/``score``/``evaluate`` follow, and
``save``/``load`` persist the fitted encoder as an ``EncoderBundle``.
The encoder runs on CUDA unless constructed with ``device="cpu"``.

Over several ranks (``python -m torch.distributed.run``, then
``core.compat.init_from_env``), every rank calls ``fit`` with the same
host arrays; dispatch sees ``compat.device_count()`` devices, the plan
hands each rank its block (``encoding.sharding.ShardingPlan``), and every
rank ends with the same full ``weights_``, per-batch ``best_lambda`` and
``cv_scores``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import banded, bmor, compat, foldstats, mor, ridge, \
    scoring
from repro_torch.device import as_tensor, resolve_device
from repro_torch.encoding.config import EncoderConfig
from repro_torch.encoding.dispatch import DispatchDecision, resolve
from repro_torch.encoding.sharding import ShardingPlan

_SOLVER_LABELS = {
    "ridge": "RidgeCV", "mor": "MOR", "bmor": "B-MOR",
    "bmor_dual": "dual B-MOR", "banded": "banded RidgeCV",
}


@dataclasses.dataclass
class EncodingReport:
    """Fit result: weights, selected λ and CV curve (one entry per target
    batch: ``(1,)`` and ``(1, r)`` for one shard, ``(target_shards,)`` and
    ``(target_shards, r)`` for B-MOR), the swept grid, and the dispatch
    decision.  MOR selects λ
    per target inside its fits (``best_lambda`` empty, ``cv_scores``
    ``(0, r)``); banded ridge reports its CV curve over the candidates and
    the winning ``band_lambdas`` (``best_lambda`` and ``lambdas`` empty)."""

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
    ``fit``: ``report_`` (an ``EncodingReport``), ``weights_``, and after a
    streamed fit ``stream_stats_`` (chunks, bytes staged, reader/compute
    stall seconds, signatures seen by the chunk update).
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
        # Set by the streamed fit paths: overlap telemetry of the chunk
        # pipeline.  None for in-memory fits.
        self.stream_stats_: dict | None = None
        # (mesh, target axis) of a target-sharded load: report_.weights is
        # then this rank's column block.  None otherwise.
        self.target_shard_: tuple | None = None

    def fit(self, X=None, Y=None, *, store=None,
            chunk_rows: int | None = None) -> "BrainEncoder":
        """Fit from in-memory arrays, or out-of-core from a ``RunStore``.

        ``fit(X, Y)`` takes numpy arrays or tensors, moved to the encoder's
        device.  ``fit(store=run_store)`` resolves dispatch on the store's
        ``(n, p, t)``: when the resident-set estimate exceeds
        ``config.device_memory_budget`` the decision pins
        ``method="chunked"`` and the rows stream from the memory-mapped
        shards — ``(n, p)`` is never materialised — or ``"colblocked"``
        when the target axis must be blocked too; otherwise the store is
        loaded once and routed through the ordinary dispatch.

        The fit runs under a ``fit`` root span (children ``fit.dispatch``,
        then ``fit.solve``, or the streamed paths' ``fit.stats`` /
        ``fit.finalize`` / ``fit.eigh`` / ``fit.solve``, or
        ``fit.wholebrain``).
        """
        with obs.span("fit", mode="store" if store is not None
                      else "arrays"):
            if store is not None:
                if X is not None or Y is not None:
                    raise ValueError("pass either (X, Y) or store=, not both")
                self._check_store_folds(store)
                n, p, t = store.shape
                with obs.span("fit.dispatch", n=n, p=p, t=t):
                    decision = resolve(self.config, n, p, t,
                                       compat.device_count(),
                                       device=self.device)
                if decision.method == "colblocked":
                    return self._fit_store_colblocked(store, decision,
                                                      chunk_rows)
                if decision.method == "chunked":
                    return self._fit_store_chunked(store, decision,
                                                   chunk_rows)
                X, Y = store.load()
            if X is None or Y is None:
                raise ValueError("fit() needs (X, Y) arrays or store=")
            n, p = X.shape
            t = Y.shape[1]
            with obs.span("fit.dispatch", n=n, p=p, t=t):
                decision = resolve(self.config, n, p, t,
                                   compat.device_count(), device=self.device)
            # The sharded plans move only this rank's block to the device.
            if decision.solver not in ("bmor", "bmor_dual") and not (
                    decision.solver == "mor" and decision.target_shards > 1):
                X = as_tensor(X, self.device)
                Y = as_tensor(Y, self.device)
            fitter = getattr(self, f"_fit_{decision.solver}")
            # No synchronise of its own: on the primal path the span ends
            # just after its last leaf, ``fit.primal.solve``, which forces
            # the card's work while a tracer is installed; on the other
            # solvers it may close on the enqueue.
            with obs.span("fit.solve", solver=decision.solver):
                self.report_ = fitter(X, Y, decision)
            return self

    def fit_chunks(self, chunks, n_total: int | None = None,
                   chunk_rows: int | None = None) -> "BrainEncoder":
        """Out-of-core fit from ordered ``(X_chunk, Y_chunk)`` row batches.

        The chunks (numpy arrays or tensors) stream through a
        ``foldstats.FoldStatsAccumulator`` — only the ``(k, p, p+t)``
        sufficient statistics live on the device — and the CV'd solve runs
        on them alone (``ridge.ridge_cv_from_stats``).  Primal/eigh,
        single shard.  Chunks must arrive in global row order; the fold
        split matches ``fit`` on the concatenated rows.

        ``chunks`` may also be a ``RunStore``: it is streamed with
        ``config.chunk_rows`` (background-prefetched into pinned buffers
        when ``config.prefetch`` and the encoder is on CUDA) and
        ``n_total`` is taken from its manifest.
        """
        self._check_chunkable()
        # A source that exposes PrefetchStats (a ChunkPrefetcher handed in
        # directly) contributes its overlap telemetry to stream_stats_.
        stream = chunks if hasattr(chunks, "stats") else None
        if hasattr(chunks, "iter_chunks"):            # RunStore duck-type
            self._check_store_folds(chunks)
            n_total = chunks.shape[0]
            chunk_rows = chunk_rows or self.config.chunk_rows
            chunks = stream = chunks.iter_chunks(
                chunk_rows, prefetch=self.config.prefetch,
                prefetch_depth=self.config.prefetch_depth,
                pin_memory=self.device.type == "cuda")
        if n_total is None:
            raise ValueError("fit_chunks needs n_total for iterator sources")
        with obs.span("fit", mode="chunks"):
            compiles0 = foldstats.chunk_update_compile_count()
            with obs.span("fit.stats", n=n_total):
                stats = foldstats.compute_chunked(
                    chunks, n_total, self.config.n_folds,
                    chunk_rows=chunk_rows,
                    use_pallas=self.config.resolve_use_pallas(self.device),
                    device=self.device)
            self._record_stream_stats(
                [stream] if stream is not None else [], compiles0)
            return self._fit_from_stats(stats, n_total)

    def _check_store_folds(self, store) -> None:
        """The manifest's fold split is part of the store's data contract:
        a config that disagrees with it is an error, not a silently
        different CV."""
        k = getattr(store, "n_folds", None)
        if k is not None and k != self.config.n_folds:
            raise ValueError(
                f"store manifest records n_folds={k} but the encoder is "
                f"configured with n_folds={self.config.n_folds} — match "
                f"EncoderConfig.n_folds to the store (or re-create the "
                f"store with the intended split)")

    def _check_chunkable(self) -> None:
        if self.config.solver not in ("auto", "ridge"):
            raise ValueError(
                f"fit_chunks supports only the single-shard ridge solver; "
                f"solver={self.config.solver!r} is pinned — use fit() for "
                f"B-MOR/MOR/banded semantics")
        if self.config.method == "dual" or self.config.bands is not None:
            raise ValueError(
                "fit_chunks is primal/eigh only (streamed row statistics "
                "cannot build the dual kernel or per-band refits)")

    def _fit_from_stats(self, stats: foldstats.FoldStats, n_total: int,
                        decision: DispatchDecision | None = None
                        ) -> "BrainEncoder":
        """CV'd solve from accumulated fold statistics alone."""
        p, t = stats.G.shape[1], stats.C.shape[2]
        # Statistics-based CV scores lose f32 precision roughly
        # quadratically in |ȳ|/σ_y; refuse clearly pathological
        # un-standardized targets instead of returning corrupted scores.
        # The host pulls below wait for the accumulation's queued tail, so
        # under tracing this span is where the streamed compute drains.
        with obs.span("fit.finalize", n=n_total, t=t):
            mu = stats.ysum.sum(0).cpu().numpy() / n_total
            var = stats.ysq.sum(0).cpu().numpy() / max(n_total - 1, 1)
            ratio = float(np.max(np.abs(mu) / np.sqrt(var + 1e-12)))
        if ratio > 1e3:
            raise ValueError(
                f"fit_chunks: target mean/std ratio {ratio:.0f} is too "
                f"large for statistics-based CV scoring in float32 — "
                f"standardize the targets first (pipeline.standardize)")
        cfg = dataclasses.replace(self.config, solver="ridge", method="eigh")
        if decision is None:
            decision = resolve(cfg, n_total, p, t, compat.device_count(),
                               device=self.device)
        res = ridge.ridge_cv_from_stats(
            stats, cfg.ridge_cv_config("eigh", device=self.device))
        self.report_ = EncodingReport(
            weights=res.weights,
            best_lambda=res.best_lambda.cpu().numpy()[None],
            cv_scores=res.cv_scores.cpu().numpy()[None, :],
            lambdas=self.config.lambdas, decision=decision)
        return self

    def _fit_store_chunked(self, store, decision: DispatchDecision,
                           chunk_rows: int | None) -> "BrainEncoder":
        """Streamed fit: the row windows shard over ``decision.data_shards``
        ranks, each rank streaming its own window (background-prefetched
        when ``config.prefetch``, into pinned buffers on CUDA) through the
        fixed-shape chunk update; one ``psum`` combines the stacked
        ``[G|C]`` partials (``foldstats.compute_sharded_chunked``)."""
        self._check_chunkable()
        n_total = store.shape[0]
        chunk_rows = chunk_rows or self.config.chunk_rows
        n_shards = max(1, min(decision.data_shards, compat.device_count(),
                              n_total))
        mesh = None
        if n_shards > 1:
            mesh = compat.make_mesh((n_shards,), (self.config.data_axis,),
                                    device=self.device)
        streams = [
            store.iter_chunks(chunk_rows, row_range=(lo, hi),
                              prefetch=self.config.prefetch,
                              prefetch_depth=self.config.prefetch_depth,
                              pin_memory=self.device.type == "cuda")
            for lo, hi in foldstats.shard_row_ranges(n_total, n_shards)]
        compiles0 = foldstats.chunk_update_compile_count()
        with obs.span("fit.stats", n=n_total, shards=n_shards,
                      chunk_rows=chunk_rows):
            stats = foldstats.compute_sharded_chunked(
                streams, n_total, self.config.n_folds, mesh=mesh,
                data_axis=self.config.data_axis, chunk_rows=chunk_rows,
                use_pallas=decision.use_pallas, device=self.device)
        self._record_stream_stats(streams, compiles0)
        return self._fit_from_stats(stats, n_total, decision)

    def _fit_store_colblocked(self, store, decision: DispatchDecision,
                              chunk_rows: int | None) -> "BrainEncoder":
        """Target-axis streamed fit (``wholebrain.fit_wholebrain``): shared
        Gram pass + per-block ``(k, p, t_block)`` statistics,
        eigendecompositions reused across blocks, one λ for all targets.

        This route assembles the host ``(p, t)`` weight matrix and moves it
        to the encoder's device for ``report_``; at whole-brain scale a
        caller that only needs the bundle drives ``fit_wholebrain``
        directly with a ``BundleWriter``, so the shards stream to disk.
        """
        self._check_chunkable()
        from repro_torch.wholebrain.solver import fit_wholebrain

        res = fit_wholebrain(store, self.config,
                             t_block=decision.target_block,
                             chunk_rows=chunk_rows, device=self.device)
        self.report_ = EncodingReport(
            weights=torch.from_numpy(res.weights).to(self.device),
            best_lambda=res.best_lambda,
            cv_scores=res.cv_scores, lambdas=self.config.lambdas,
            decision=decision)
        self.stream_stats_ = {"schema": obs.SCHEMA_VERSION, "kind": "stream",
                              "prefetch": bool(self.config.prefetch),
                              **res.telemetry,
                              "compile_count":
                                  res.telemetry["colblock_compile_delta"]}
        return self

    def _record_stream_stats(self, streams, compiles_before: int) -> None:
        """Aggregate per-stream prefetch telemetry into ``stream_stats_``
        (the reference's flat snapshot schema)."""
        agg = {"schema": obs.SCHEMA_VERSION, "kind": "stream",
               "prefetch": bool(self.config.prefetch), "chunks": 0,
               "bytes_staged": 0, "read_stall_s": 0.0,
               "compute_stall_s": 0.0,
               "use_pallas": self.config.resolve_use_pallas(self.device),
               "compile_count": (foldstats.chunk_update_compile_count()
                                 - compiles_before)}
        for stream in streams:
            st = getattr(stream, "stats", None)
            if st is None:
                continue
            d = st.to_dict()
            for key in ("chunks", "bytes_staged", "read_stall_s",
                        "compute_stall_s"):
                agg[key] += d[key]
        self.stream_stats_ = agg

    @property
    def weights_(self) -> torch.Tensor:
        """The (p, t) weight matrix.  On an encoder loaded target-sharded
        (``load(target_shards=c)``) each rank holds only its column block,
        and this gathers the full matrix: every rank must ask."""
        if self.report_ is None:
            raise RuntimeError("call fit() first")
        if self.target_shard_ is not None:
            mesh, axis = self.target_shard_
            return mesh.all_gather(self.report_.weights, axis, dim=1)
        return self.report_.weights

    def save(self, bundle_dir: str, *, overwrite: bool = False,
             weight_shards: int | None = None,
             weight_dtype: str | None = None,
             provenance: dict | None = None) -> str:
        """Persist the fitted encoder as an ``EncoderBundle`` directory.

        The weight matrix (column-sharded ``.npy`` leaves, bf16 stored as
        u16 bit patterns), the selected λ / CV provenance, the
        ``EncoderConfig``, the dispatch decision and the fitted
        ``Standardizer`` land on disk in the reference's format, atomically
        (staged, then renamed).  ``BrainEncoder.load(d).predict(X)`` is
        bitwise equal to ``self.predict(X)``.  Over several ranks every
        rank calls ``save``: rank 0 writes, the others wait at a barrier.
        """
        from repro_torch.serving_encoders import bundle
        W = self.weights_ if self.report_ is not None else None
        if compat.rank() == 0:
            bundle.save_bundle(bundle_dir, self, overwrite=overwrite,
                               weight_shards=weight_shards,
                               weight_dtype=weight_dtype,
                               provenance=provenance, weights=W)
        compat.barrier()
        return bundle_dir

    @classmethod
    def load(cls, bundle_dir: str, *, target_shards: int | None = None,
             device: torch.device | str | None = None) -> "BrainEncoder":
        """Rebuild a fitted encoder from a saved bundle (no refit), on
        ``device`` (CUDA unless ``device="cpu"``).  ``target_shards`` > 1
        places ``W`` column-sharded over a ``(1, target_shards)`` mesh of
        the ranks (the serving layout): each rank holds its column block,
        and ``predict`` gathers the columns."""
        from repro_torch.serving_encoders import bundle
        return bundle.EncoderBundle.open(bundle_dir).load_encoder(
            target_shards=target_shards, device=device)

    def predict(self, X) -> torch.Tensor:
        if self.target_shard_ is not None:
            mesh, axis = self.target_shard_
            local = ridge.predict(as_tensor(X, self.device),
                                  self.report_.weights)
            return mesh.all_gather(local, axis, dim=1)
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

    def _plan(self, decision: DispatchDecision, **kw) -> ShardingPlan:
        return ShardingPlan(data_shards=decision.data_shards,
                            target_shards=decision.target_shards,
                            data_axis=self.config.data_axis,
                            target_axis=self.config.target_axis, **kw)

    def _fit_mor(self, X, Y, decision: DispatchDecision) -> EncodingReport:
        cfg = self.config.ridge_cv_config(decision.method, device=self.device)
        if self.config.mor_taskwise and decision.target_shards > 1:
            raise ValueError("mor_taskwise=True is incompatible with "
                             "target_shards > 1: taskwise MOR is a host-level "
                             "per-target loop (paper Fig. 8 cost semantics)")
        if decision.target_shards > 1:
            plan = self._plan(decision)
            X, Y, t = plan.prepare(X, Y)
            mesh = plan.build_mesh(self.device)
            X_l, Y_l = plan.place(mesh, X, Y)
            W = mor.mor_fit_distributed(X_l, Y_l, mesh,
                                        axis=plan.target_axis, cfg=cfg)
            W = W[:, :t]
        elif self.config.mor_taskwise:
            W = mor.mor_fit_taskwise(X, Y, cfg)
        else:
            W = mor.mor_fit(X, Y, cfg)
        return EncodingReport(
            weights=W,
            best_lambda=np.empty((0,)),          # per-target λ stays internal
            cv_scores=np.empty((0, len(self.config.lambdas))),
            lambdas=self.config.lambdas, decision=decision)

    def _bmor_report(self, res: bmor.BMORResult, t: int,
                     decision: DispatchDecision) -> EncodingReport:
        # Every rank holds the gathered W: dropping the padded columns is a
        # plain slice (the reference's slice of a target-sharded W fails).
        W = res.weights
        return EncodingReport(
            weights=W if W.shape[1] == t else W[:, :t].contiguous(),
            best_lambda=res.best_lambda.cpu().numpy(),
            cv_scores=res.cv_scores.cpu().numpy(),
            lambdas=self.config.lambdas, decision=decision)

    def _fit_bmor(self, X, Y, decision: DispatchDecision) -> EncodingReport:
        plan = self._plan(decision)
        X, Y, t = plan.prepare(X, Y)
        mesh = plan.build_mesh(self.device)
        X_l, Y_l = plan.place(mesh, X, Y)
        res = bmor.bmor_fit(X_l, Y_l, mesh, data_axis=plan.data_axis,
                            target_axis=plan.target_axis,
                            cfg=self.config.ridge_cv_config(
                                "eigh", device=self.device))
        return self._bmor_report(res, t, decision)

    def _fit_bmor_dual(self, X, Y, decision: DispatchDecision
                       ) -> EncodingReport:
        plan = self._plan(decision, replicate_rows=True)
        X, Y, t = plan.prepare(X, Y)
        mesh = plan.build_mesh(self.device)
        X_l, Y_l = plan.place(mesh, X, Y)
        res = bmor.bmor_fit_dual(X_l, Y_l, mesh,
                                 target_axis=plan.target_axis,
                                 cfg=self.config.ridge_cv_config(
                                     "dual", device=self.device))
        return self._bmor_report(res, t, decision)

    def _fit_banded(self, X, Y, decision: DispatchDecision) -> EncodingReport:
        """Banded RidgeCV; the candidates come from a CPU generator seeded
        with ``config.seed`` (a different draw from the reference's
        ``jax.random`` one for the same seed)."""
        bands = self.config.bands
        if sum(bands) != X.shape[1]:
            raise ValueError(f"bands {bands} sum to {sum(bands)} but X has "
                             f"{X.shape[1]} features")
        res = banded.banded_ridge_cv(
            torch.Generator().manual_seed(self.config.seed), X, Y,
            self.config.banded_config())
        return EncodingReport(
            weights=res.weights,
            best_lambda=np.empty((0,)),          # per-band, not per-grid-λ
            cv_scores=res.cv_scores.cpu().numpy()[None, :],
            lambdas=(), decision=decision,
            band_lambdas=res.band_lambdas.cpu().numpy())
