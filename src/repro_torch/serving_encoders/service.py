"""EncoderService — mixed-wave prediction serving over a registry.

Port of ``repro/serving_encoders/service.py``.  Concurrent
``PredictRequest``\\ s are micro-batched per model, their rows packed into
fixed-shape waves (the ragged tail zero-padded), and every wave runs the
same prediction program: ``standardize → X·W → de-standardize`` and, for
scored rows, the per-slot Pearson running sums.  ``compile_count`` counts
the distinct wave signatures flown (the reference counts XLA traces, one
per signature), so it equals the number of wave buckets actually flown.

**Mixed waves.**  Scored and unscored requests from any tenants pack into
the SAME waves: next to the padded feature block the program takes a
per-row request one-hot ``(wave_rows, score_slots)`` and a per-slot sum
carry, and emits the wave's predictions plus the updated ``(s, 5, t)``
running sums.

Two exactness properties make the packed serve BIT-identical to serving
each request alone (``reference_serve``):

* **Row independence.**  ``X·W`` is computed in row tiles of one fixed
  height (``ROW_TILE``, the wave padded up to a multiple of it), so every
  product launch has the same shape whatever the wave's size, and every
  tile starts 128-byte aligned.  A library GEMM picks its kernel (tiling,
  split-K, reduction order) from the shape and the alignment; with both
  fixed, a row's bits depend on its own values only — not on the wave's
  bucket, its offset in the wave, or the other rows.
* **Sequential sum chaining.**  The per-slot Pearson sums are a
  sequential f32 chain over the wave's rows, seeded with the slot's carry
  from the request's previous wave.  A row whose one-hot weight is zero
  adds an exact ``±0``, so a request's final sums are the same chain over
  its own rows at any wave offset or cut.  (``torch.cumsum`` or a ``sum``
  over rows would regroup the additions and break this.)  The chain is a
  Python loop over rows, one add per row: the plain version; the
  reference leaves it to XLA, so there is no kernel to port.

Wave shapes come from ``wave_buckets`` (picked per wave by the rows
remaining) or the single ``wave_rows``; ``ServiceStats`` records the pad
economics per bucket and the accounting per tenant.  A model whose bundle
fails to load mid-serve degrades ONLY its own requests (typed
``BundleError``/``RegistryError`` on ``PredictResult.error``, the bundle
evicted); malformed requests refuse the whole batch up front.

Observability, as the reference's: each wave is a ``serve.wave.build``
span (host-side packing and the copy to the device) and a
``serve.wave.execute`` span; ``ServiceStats`` also feeds the
``repro_torch.obs`` counters ``waves{bucket}``, ``wave_rows``,
``wave_pad_rows`` and ``tenant_rows{tenant}``.  ``compiles`` is the
``obs.CompileCounter`` of the wave programs, marked once per new
(program, wave shape, weight shape and dtype) signature, and every flight
runs inside ``_expect_shape``'s window, so under ``REPRO_OBS_STRICT=1`` a
signature the shape key did not predict raises ``obs.RecompileError``.
On the card an unscored wave's ``serve.wave.execute`` span measures the
enqueue: nothing waits for the device there, as in the reference.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.serving_encoders.bundle import BundleError
from repro_torch.serving_encoders.registry import EncoderRegistry, RegistryError

#: Height of every ``X·W`` product launch (rows).  32 rows keep every tile
#: 128-byte aligned for any feature and target width (32·4 bytes per
#: column of either operand).
ROW_TILE = 32


class ServiceError(ValueError):
    """Malformed request: empty/shape-mismatched feature blocks and
    admission rejections (unknown models are the registry's)."""


@dataclasses.dataclass
class PredictRequest:
    """One client request: raw (un-standardized) stimulus features for one
    model, optionally with measured targets to score against.  ``tenant``
    is the accounting principal (defaults to the model name)."""

    model: str
    features: np.ndarray                 # (rows, p) raw features
    targets: np.ndarray | None = None    # (rows, t) → score with Pearson r
    tenant: str | None = None

    @property
    def tenant_id(self) -> str:
        return self.tenant if self.tenant is not None else self.model


@dataclasses.dataclass
class PredictResult:
    model: str
    predictions: np.ndarray | None       # (rows, t) raw-unit predictions
    pearson_r: np.ndarray | None = None  # (t,) when targets were given
    # Typed load/serve fault (BundleError/RegistryError) that degraded
    # this request.  None = served.
    error: Exception | None = None


@dataclasses.dataclass
class ServiceStats:
    waves: int = 0
    rows: int = 0                        # real (unpadded) rows served
    pad_rows: int = 0                    # zero rows added to fill waves
    requests: int = 0
    # Per wave shape flown: {wave_rows: {"waves", "rows", "pad_rows"}}.
    per_bucket: dict = dataclasses.field(default_factory=dict)
    # Per tenant: {"rows", "bytes", "requests", "scored", "errors",
    # "rejected"} (bytes = feature + target payload served).
    per_tenant: dict = dataclasses.field(default_factory=dict)

    def record_wave(self, wave_rows: int, real: int) -> None:
        b = self.per_bucket.setdefault(
            wave_rows, {"waves": 0, "rows": 0, "pad_rows": 0})
        b["waves"] += 1
        b["rows"] += real
        b["pad_rows"] += wave_rows - real
        self.waves += 1
        self.pad_rows += wave_rows - real
        m = obs.get_metrics()
        m.counter("waves", bucket=wave_rows).inc()
        m.counter("wave_rows").inc(real)
        m.counter("wave_pad_rows").inc(wave_rows - real)

    def tenant(self, tenant: str) -> dict:
        return self.per_tenant.setdefault(
            tenant, {"rows": 0, "bytes": 0, "requests": 0, "scored": 0,
                     "errors": 0, "rejected": 0})

    def record_request(self, tenant: str, rows: int, nbytes: int,
                       scored: bool) -> None:
        acct = self.tenant(tenant)
        acct["rows"] += rows
        acct["bytes"] += nbytes
        acct["requests"] += 1
        acct["scored"] += int(scored)
        obs.get_metrics().counter("tenant_rows", tenant=tenant).inc(rows)

    def record_error(self, tenant: str) -> None:
        self.tenant(tenant)["errors"] += 1

    def record_rejected(self, tenant: str) -> None:
        self.tenant(tenant)["rejected"] += 1

    def to_dict(self) -> dict:
        """The reference's stats schema (kind ``"service"``)."""
        return {
            "schema": obs.SCHEMA_VERSION,
            "kind": "service",
            "waves": int(self.waves),
            "rows": int(self.rows),
            "pad_rows": int(self.pad_rows),
            "requests": int(self.requests),
            "per_bucket": {int(k): dict(v)
                           for k, v in sorted(self.per_bucket.items())},
            "per_tenant": {k: dict(v)
                           for k, v in sorted(self.per_tenant.items())},
        }


# -- the wave programs -------------------------------------------------------

def tiled_matmul(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``A·W`` in f32 as ``ROW_TILE``-row products of one shape: a row's
    bits do not depend on how many rows ``A`` has or where the row sits.
    ``A``'s rows are zero-padded up to a multiple of ``ROW_TILE``; the
    result keeps ``A``'s row count."""
    m, k = A.shape
    m_pad = -(-m // ROW_TILE) * ROW_TILE
    if m_pad != m:
        A = torch.cat([A, A.new_zeros((m_pad - m, k))])
    A = A.contiguous()
    W = W.float()
    out = torch.empty((m_pad, W.shape[1]), dtype=torch.float32,
                      device=A.device)
    for lo in range(0, m_pad, ROW_TILE):
        torch.matmul(A[lo:lo + ROW_TILE], W, out=out[lo:lo + ROW_TILE])
    return out[:m]


def predict_rows(X: torch.Tensor, W: torch.Tensor, mu_x: torch.Tensor,
                 sd_x: torch.Tensor, mu_y: torch.Tensor,
                 sd_y: torch.Tensor) -> torch.Tensor:
    """Raw-unit predictions of a wave: ``((X − μ_x)/σ_x)·W·σ_y + μ_y``."""
    Xs = (X - mu_x) / sd_x
    return tiled_matmul(Xs, W) * sd_y + mu_y


def chain_sums(sums: torch.Tensor, Yt: torch.Tensor, P: torch.Tensor,
               onehot: torch.Tensor) -> torch.Tensor:
    """Per-slot Pearson running sums ``(s, 5, t)`` continued over the
    wave's rows in order: row i adds ``onehot[i, slot]·[y, p, y², p², y·p]``
    to every slot (an exact ``±0`` where its weight is 0).  A sequential
    loop over rows, one in-place add per row, in blocks of 8 rows whose
    terms are formed elementwise first."""
    sums = sums.clone()
    for lo in range(0, Yt.shape[0], 8):
        y, q, w = Yt[lo:lo + 8], P[lo:lo + 8], onehot[lo:lo + 8]
        terms = torch.stack([y, q, y * y, q * q, y * q], dim=1)  # (b, 5, t)
        weighted = w[:, :, None, None] * terms[:, None]         # (b,s,5,t)
        for i in range(weighted.shape[0]):
            sums.add_(weighted[i])
    return sums


def predict_mixed(X: torch.Tensor, Yt: torch.Tensor, onehot: torch.Tensor,
                  sums_in: torch.Tensor, W: torch.Tensor, mu_x: torch.Tensor,
                  sd_x: torch.Tensor, mu_y: torch.Tensor, sd_y: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One mixed wave: its predictions and the per-slot sums chained
    through ``sums_in``."""
    P = predict_rows(X, W, mu_x, sd_x, mu_y, sd_y)
    return P, chain_sums(sums_in, Yt, P, onehot)


# -- mixed-wave packing ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WaveSegment:
    """Rows ``[req_lo, req_hi)`` of request ``req`` land at wave offset
    ``wave_lo``; ``slot`` is the request's Pearson score slot within this
    wave (None = unscored)."""

    req: int
    req_lo: int
    req_hi: int
    wave_lo: int
    slot: int | None


@dataclasses.dataclass(frozen=True)
class MixedWave:
    rows: int                    # wave shape flown (a bucket size)
    fill: int                    # real rows (rows - fill are padding)
    segments: tuple              # WaveSegment, contiguous from offset 0


def plan_mixed_waves(req_rows: Sequence[int], scored: Sequence[bool],
                     next_wave: Callable[[int], int],
                     score_slots: int) -> list[MixedWave]:
    """Pack ragged scored/unscored requests into fixed-shape mixed waves.

    Requests flow into waves in arrival order; ``next_wave(remaining)``
    picks each wave's shape.  Every scored request intersecting a wave
    holds one of its ``score_slots`` one-hot slots; when a NEW scored
    request would need a slot and none is free the wave closes early (its
    tail rows become padding).  Pure and deterministic.
    """
    if score_slots < 1:
        raise ServiceError(f"score_slots must be >= 1, got {score_slots}")
    waves: list[MixedWave] = []
    remaining = sum(req_rows)
    r, done = 0, 0                      # cursor: request index, rows consumed
    while remaining:
        w = next_wave(remaining)
        fill, slots = 0, 0
        segs: list[WaveSegment] = []
        while fill < w and r < len(req_rows):
            rows = req_rows[r]
            if done == rows:                       # exhausted → advance
                r, done = r + 1, 0
                continue
            slot = None
            if scored[r]:
                if slots == score_slots:
                    break                          # close the wave early
                slot, slots = slots, slots + 1
            take = min(w - fill, rows - done)
            segs.append(WaveSegment(r, done, done + take, fill, slot))
            fill += take
            done += take
            remaining -= take
            if done == rows:
                r, done = r + 1, 0
        waves.append(MixedWave(rows=w, fill=fill, segments=tuple(segs)))
    return waves


class EncoderService:
    """Micro-batching mixed-wave server over an ``EncoderRegistry``, on the
    registry's device.

    >>> service = EncoderService(registry, wave_buckets=(32, 128))
    >>> results = service.serve([PredictRequest("sub-01", X1),
    ...                          PredictRequest("sub-02", X2, targets=Y2)])

    Requests for the same model are packed together, scored and unscored
    alike.  Wave shapes come from ``wave_buckets`` when given (picked per
    wave by the rows remaining) or the single ``wave_rows``;
    ``serve(..., wave_rows=...)`` pins one shape per call.
    ``compile_count`` counts the distinct (program, wave shape, weight
    shape and dtype) signatures flown (an alias over the
    ``obs.CompileCounter`` ``compiles``).  ``score_slots`` bounds how many
    scored requests share one wave; ``prefetch_next=True`` touches the
    registry for the NEXT queued model on a background thread while the
    current model's waves are in flight.
    """

    def __init__(self, registry: EncoderRegistry, *, wave_rows: int = 128,
                 wave_buckets: Sequence[int] | None = None,
                 score_slots: int = 4, prefetch_next: bool = False,
                 return_predictions: bool = True):
        self.registry = registry
        self.device = registry.device
        if wave_rows < 1:
            raise ServiceError(f"wave_rows must be >= 1, got {wave_rows}")
        self.wave_rows = wave_rows
        if wave_buckets is not None:
            wave_buckets = tuple(sorted({int(b) for b in wave_buckets}))
            if not wave_buckets or wave_buckets[0] < 1:
                raise ServiceError(f"wave_buckets must be positive ints, "
                                   f"got {wave_buckets}")
        self.wave_buckets = wave_buckets
        if score_slots < 1:
            raise ServiceError(f"score_slots must be >= 1, "
                               f"got {score_slots}")
        self.score_slots = score_slots
        self.prefetch_next = prefetch_next
        self.return_predictions = return_predictions
        self.compiles = obs.CompileCounter("service.predict")
        self._signatures: set = set()
        self._seen_shapes: set = set()
        self.stats = ServiceStats()

    @property
    def compile_count(self) -> int:
        """Distinct wave signatures flown (the reference's trace count; an
        alias over the shared :class:`repro_torch.obs.CompileCounter`)."""
        return self.compiles.count

    def _flown(self, key: tuple) -> None:
        """Mark a wave program's signature the first time it flies — the
        port's counterpart of the reference's trace."""
        if key not in self._signatures:
            self.compiles.mark()
            self._signatures.add(key)

    def _expect_shape(self, key: tuple):
        """Strict-sentinel window for one wave flight: a shape key seen
        before must fly 0 new signatures; a fresh key is allowed exactly
        one.  Under ``REPRO_OBS_STRICT=1`` a violation raises
        (``obs.RecompileError``) instead of skewing the counter."""
        fresh = key not in self._seen_shapes
        self._seen_shapes.add(key)
        return self.compiles.expect(at_most=1 if fresh else 0)

    # -- wave planning -------------------------------------------------------
    def _plan_waves(self, n_rows: int, wave_rows: int | None) -> list[int]:
        """Wave shapes covering ``n_rows``: the pinned single shape, or a
        bucket-ladder plan — the largest bucket while full waves remain,
        then the min-pad cover of the tail (a single bucket that swallows
        it, or the greedy descending ladder when that pads less); equal
        pad prefers the single wave."""
        if wave_rows is not None or self.wave_buckets is None:
            w = wave_rows if wave_rows is not None else self.wave_rows
            return [w] * -(-n_rows // w)
        big = self.wave_buckets[-1]
        sizes = [big] * (n_rows // big)
        tail = n_rows - big * len(sizes)
        if not tail:
            return sizes
        single = [next(b for b in self.wave_buckets if b >= tail)]
        ladder, rem = [], tail
        for b in reversed(self.wave_buckets):
            take = rem // b
            ladder += [b] * take
            rem -= b * take
        if rem:
            ladder.append(self.wave_buckets[0])
        return sizes + (ladder if sum(ladder) < single[0] else single)

    def _next_wave(self, remaining: int, wave_rows: int | None) -> int:
        """First wave of the ladder plan for ``remaining`` rows."""
        return self._plan_waves(remaining, wave_rows)[0]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _pad(block: np.ndarray, rows: int) -> np.ndarray:
        pad = rows - block.shape[0]
        if not pad:
            return block
        return np.concatenate(
            [block, np.zeros((pad, block.shape[1]), np.float32)])

    # -- windowed serving (whole-brain bundles) ------------------------------
    def predict_columns(self, model: str, features: np.ndarray,
                        col_range: tuple[int, int], *,
                        wave_rows: int | None = None) -> np.ndarray:
        """Predict ONE target-column window of one model.

        The registry pages in (and charges) only the weight column shards
        overlapping ``col_range``; rows fly in the same fixed-shape waves
        as ``serve``.  Returns the ``(rows, hi - lo)`` raw-unit
        predictions.
        """
        lo, hi = col_range
        bundle = self.registry.bundle(model)
        p, t = bundle.shape
        if not (0 <= lo < hi <= t):
            raise ServiceError(f"column window [{lo}, {hi}) invalid for "
                               f"{model!r} with t={t}")
        feats = np.asarray(features, np.float32)
        if feats.ndim != 2 or feats.shape[1] != p or not feats.size:
            raise ServiceError(f"request for {model!r}: features "
                               f"{feats.shape} incompatible with p={p}")
        if wave_rows is not None and wave_rows < 1:
            raise ServiceError(f"wave_rows must be >= 1, got {wave_rows}")
        max_wave = wave_rows if wave_rows is not None else (
            self.wave_buckets[-1] if self.wave_buckets else self.wave_rows)
        shards = self.registry.get_columns(model, (lo, hi),
                                           wave_rows=max_wave)
        first_lo = shards[0].bounds[0]
        parts, counts = [], []
        pos = 0
        for w in self._plan_waves(feats.shape[0], wave_rows):
            with obs.span("serve.wave.build", rows=w, model=model):
                chunk = self._to_device(self._pad(feats[pos:pos + w], w))
            real = min(w, feats.shape[0] - pos)
            outs = []
            with obs.span("serve.wave.execute", rows=w,
                          shards=len(shards)):
                for e in shards:
                    n_cols = int(e.W.shape[1])
                    with self._expect_shape(("predict", w, p, n_cols)):
                        self._flown(("predict", w, p, n_cols, e.W.dtype))
                        outs.append(predict_rows(chunk, e.W, e.mu_x, e.sd_x,
                                                 e.mu_y, e.sd_y))
            parts.append(torch.cat(outs, dim=1) if len(outs) > 1
                         else outs[0])
            counts.append(real)
            self.stats.record_wave(w, real)
            pos += w
        out = np.concatenate([P[:c].cpu().numpy()
                              for P, c in zip(parts, counts)])
        self.stats.rows += feats.shape[0]
        self.stats.requests += 1
        return out[:, lo - first_lo:hi - first_lo]

    # -- serving -------------------------------------------------------------
    def _serve_group(self, model: str, reqs: list[PredictRequest],
                     blocks: list[np.ndarray], t: int, max_wave: int,
                     wave_rows: int | None) -> list[PredictResult]:
        """Fly one model's packed mixed waves; results in ``reqs`` order."""
        entry = self.registry.get(model, wave_rows=max_wave,
                                  score_slots=self.score_slots)
        enc_args = (entry.weights, entry.mu_x, entry.sd_x,
                    entry.mu_y, entry.sd_y)
        s = self.score_slots
        scored = [r.targets is not None for r in reqs]
        targets = [None if r.targets is None
                   else np.asarray(r.targets, np.float32) for r in reqs]
        plan = plan_mixed_waves(
            [b.shape[0] for b in blocks], scored,
            lambda rem: self._next_wave(rem, wave_rows), s)

        # Per-request running Pearson sums, on the device: the f32 chain
        # each scored wave continues.
        req_sums = {j: torch.zeros((5, t), dtype=torch.float32,
                                   device=self.device)
                    for j, sc in enumerate(scored) if sc}
        p = blocks[0].shape[1]
        flown: list[tuple[MixedWave, torch.Tensor]] = []
        for wave in plan:
            with obs.span("serve.wave.build", rows=wave.rows,
                          fill=wave.fill, model=model):
                X = np.zeros((wave.rows, p), np.float32)
                Yt = np.zeros((wave.rows, t), np.float32)
                onehot = np.zeros((wave.rows, s), np.float32)
                for seg in wave.segments:
                    dst = slice(seg.wave_lo,
                                seg.wave_lo + seg.req_hi - seg.req_lo)
                    X[dst] = blocks[seg.req][seg.req_lo:seg.req_hi]
                    if seg.slot is not None:
                        Yt[dst] = targets[seg.req][seg.req_lo:seg.req_hi]
                        onehot[dst, seg.slot] = 1.0
                sums_in = torch.zeros((s, 5, t), dtype=torch.float32,
                                      device=self.device)
                for seg in wave.segments:
                    if seg.slot is not None:
                        sums_in[seg.slot] = req_sums[seg.req]
                X, Yt, onehot = (self._to_device(a) for a in (X, Yt, onehot))
            with obs.span("serve.wave.execute", rows=wave.rows,
                          fill=wave.fill, model=model):
                with self._expect_shape(("mixed", wave.rows, p, t, s)):
                    self._flown(("mixed", wave.rows, p, t, s,
                                 entry.weights.dtype))
                    P, sums_out = predict_mixed(X, Yt, onehot, sums_in,
                                                *enc_args)
                self.stats.record_wave(wave.rows, wave.fill)
                for seg in wave.segments:
                    if seg.slot is not None:
                        req_sums[seg.req] = sums_out[seg.slot]
            flown.append((wave, P))

        out_pred = None
        if self.return_predictions:
            out_pred = {j: np.empty((b.shape[0], t), np.float32)
                        for j, b in enumerate(blocks)}
            for wave, P in flown:
                host = P.cpu().numpy()
                for seg in wave.segments:
                    out_pred[seg.req][seg.req_lo:seg.req_hi] = \
                        host[seg.wave_lo:seg.wave_lo + seg.req_hi - seg.req_lo]

        results = []
        for j, req in enumerate(reqs):
            r = None
            if scored[j]:
                # Finalise from the accumulated chain with the kernel's
                # formula — identical sums (packed vs alone) → identical r.
                r = np.asarray(ops.pearson_r_from_sums(
                    req_sums[j].cpu().numpy().astype(np.float64),
                    blocks[j].shape[0]))
            results.append(PredictResult(
                model=model,
                predictions=None if out_pred is None else out_pred[j],
                pearson_r=r))
            self.stats.rows += blocks[j].shape[0]
            self.stats.record_request(
                req.tenant_id, blocks[j].shape[0],
                blocks[j].nbytes + (targets[j].nbytes if scored[j] else 0),
                scored[j])
        return results

    def _prefetch(self, model: str, max_wave: int) -> None:
        """Hot-bundle prefetch: touch the registry for the next queued
        model.  Faults stay silent here — they surface (typed, per
        request) when the model is actually served."""
        try:
            self.registry.get(model, wave_rows=max_wave,
                              score_slots=self.score_slots)
        except Exception:
            pass

    def serve(self, requests: Sequence[PredictRequest], *,
              wave_rows: int | None = None) -> list[PredictResult]:
        if wave_rows is not None and wave_rows < 1:
            raise ServiceError(f"wave_rows must be >= 1, got {wave_rows}")
        # The largest shape this call may fly: what residency is charged at.
        max_wave = wave_rows if wave_rows is not None else (
            self.wave_buckets[-1] if self.wave_buckets else self.wave_rows)
        groups: dict[str, list[int]] = {}
        for i, req in enumerate(requests):
            groups.setdefault(req.model, []).append(i)

        # Pass 1 — validate EVERY request against its bundle's MANIFEST
        # before any device work, so one malformed request cannot discard
        # another model's completed predictions; nothing is loaded yet.
        prepared: dict[str, list] = {}
        for model, idxs in groups.items():
            p, t = self.registry.bundle(model).shape
            self.registry.ensure_servable(model, wave_rows=max_wave,
                                          score_slots=self.score_slots)
            blocks = []
            for i in idxs:
                feats = np.asarray(requests[i].features, np.float32)
                if feats.ndim != 2 or feats.shape[1] != p or not feats.size:
                    raise ServiceError(
                        f"request for {model!r}: features {feats.shape} "
                        f"incompatible with the bundle's p={p}")
                if requests[i].targets is not None and \
                        np.shape(requests[i].targets) != (feats.shape[0], t):
                    raise ServiceError(
                        f"request for {model!r}: targets "
                        f"{np.shape(requests[i].targets)} != expected "
                        f"({feats.shape[0]}, {t})")
                blocks.append(feats)
            prepared[model] = blocks

        # Pass 2 — load (one model at a time), pack, and fly each model's
        # mixed waves.  A load/serve fault degrades ONLY that model's
        # requests.
        results: list[PredictResult | None] = [None] * len(requests)
        order = list(groups)
        pending: threading.Thread | None = None
        for gi, model in enumerate(order):
            if pending is not None:
                pending.join()                     # prefetched THIS model
                pending = None
            if self.prefetch_next and gi + 1 < len(order):
                pending = threading.Thread(
                    target=self._prefetch, args=(order[gi + 1], max_wave),
                    daemon=True)
                pending.start()
            idxs = groups[model]
            t = self.registry.bundle(model).shape[1]
            try:
                group_results = self._serve_group(
                    model, [requests[i] for i in idxs], prepared[model],
                    t, max_wave, wave_rows)
            except (BundleError, RegistryError) as err:
                self.registry.evict(model)
                group_results = []
                for i in idxs:
                    self.stats.record_error(requests[i].tenant_id)
                    group_results.append(PredictResult(
                        model=model, predictions=None, error=err))
            for i, res in zip(idxs, group_results):
                results[i] = res
            self.stats.requests += len(idxs)
        if pending is not None:
            pending.join()
        return results                                 # arrival order


def reference_serve(service: EncoderService,
                    requests: Sequence[PredictRequest], *,
                    wave_rows: int | None = None) -> list[PredictResult]:
    """The per-request reference: each request served ALONE (no packing,
    no wave sharing)."""
    return [service.serve([req], wave_rows=wave_rows)[0]
            for req in requests]


__all__ = ["EncoderService", "MixedWave", "PredictRequest", "PredictResult",
           "ROW_TILE", "ServiceError", "ServiceStats", "WaveSegment",
           "chain_sums", "plan_mixed_waves", "predict_mixed", "predict_rows",
           "reference_serve", "tiled_matmul"]
