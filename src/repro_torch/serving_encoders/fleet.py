"""Fleet tier — N serving workers, one artifact directory, shared state.

Port of ``repro/serving_encoders/fleet.py``:

* ``ResidencyMap`` — a small on-disk JSON map (``residency.json`` next to
  the bundles) of which worker holds which bundles resident and at what
  byte charge.  Every update takes an ``fcntl.flock`` on a sidecar lock
  file and rewrites the map atomically (tmp + rename), so worker
  *processes* see one coherent fleet view.  Rows are heartbeat leases:
  ``expire_dead`` reaps stale ones, and the lock wait is bounded.
* ``FleetRegistry`` — an ``EncoderRegistry`` that publishes its residency
  transitions (loads and evictions) to a ``ResidencyMap`` under its worker
  id.  Weight reads stay mmap'd read-only, so co-located workers share the
  OS page cache for the bytes themselves.
* ``FleetFrontend`` — bounded admission in ROWS: a ``submit`` that would
  overflow the bound is REJECTED with a typed ``ServiceError`` (counted
  per tenant in ``ServiceStats``); ``flush`` drains the queue through one
  mixed-wave ``serve`` call, and re-admits the batch if its worker is lost.

Fleet events go through ``repro_torch.obs`` as in the reference: the
``fleet.flush`` span, the ``fleet.admit`` / ``fleet.reject`` /
``fleet.replay`` / ``fleet.lease_expired`` / ``fleet.lock_timeout``
instants, and the counters ``admitted_rows``, ``rejected_requests``,
``requests_replayed`` and ``lease_expirations``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Sequence

import numpy as np

from repro_torch import obs
from repro_torch.serving_encoders.registry import EncoderRegistry
from repro_torch.serving_encoders.service import (
    EncoderService, PredictRequest, PredictResult, ServiceError,
)

RESIDENCY_MAP = "residency.json"


class FleetError(RuntimeError):
    """Fleet coordination fault (lock-acquire timeout, lease violation)."""


class WorkerLost(FleetError):
    """The worker serving a batch died mid-flight.  Raised by transports /
    the fault-injection harness; ``FleetFrontend.flush`` re-admits the
    batch instead of dropping it, and ``replay`` retries the drain."""


class ResidencyMap:
    """File-lock-guarded on-disk residency map shared by fleet workers.

    Layout::

        {"workers": {"<worker>": {"models": {"<model>": bytes},
                                  "resident_bytes": int,
                                  "loads": int, "evictions": int,
                                  "heartbeat": float}}}

    Every mutation runs read-modify-write under an exclusive ``flock`` on
    ``<path>.lock`` and lands via tmp + ``os.replace`` — concurrent
    workers serialize on the lock and a crashed writer never leaves a
    torn map.  The map is *bookkeeping only*: losing it costs telemetry,
    never correctness.

    **Leases, not assertions.**  Each worker row is heartbeat-stamped
    (``publish``/``heartbeat`` refresh the stamp); a row whose stamp is
    older than a TTL is a DEAD worker's stale claim — ``expire_dead``
    reaps such rows and ``holders(ttl_s=...)`` ignores them, so routing
    never trusts a holder that stopped proving it is alive.

    **Bounded lock wait.**  A worker killed while holding the fcntl lock
    releases it with its fd (the OS guarantees that), but a *wedged*
    holder would block every peer forever — ``lock_timeout_s`` bounds the
    acquire with a typed :class:`FleetError` instead.  ``clock``/``sleep``
    are injectable so lease/lock tests run on virtual time.
    """

    def __init__(self, path: str, *, lock_timeout_s: float = 30.0,
                 clock=time.time, sleep=time.sleep):
        self.path = path
        self.lock_timeout_s = lock_timeout_s
        self._clock = clock
        self._sleep = sleep
        self._lockpath = path + ".lock"
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)

    def _locked(self):
        import fcntl

        timeout = self.lock_timeout_s
        clock = self._clock
        sleep = self._sleep
        lockpath = self._lockpath

        class _Lock:
            def __enter__(_self):
                _self.fd = os.open(lockpath, os.O_CREAT | os.O_RDWR, 0o644)
                deadline = clock() + timeout
                while True:
                    try:
                        fcntl.flock(_self.fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        return _self.fd
                    except OSError:
                        if clock() >= deadline:
                            os.close(_self.fd)
                            obs.instant("fleet.lock_timeout", path=lockpath)
                            raise FleetError(
                                f"could not acquire residency lock "
                                f"{lockpath} within {timeout}s — a peer "
                                f"worker is wedged while holding it")
                        sleep(0.01)

            def __exit__(_self, *exc):
                import fcntl as _f
                _f.flock(_self.fd, _f.LOCK_UN)
                os.close(_self.fd)
                return False

        return _Lock()

    def _read(self) -> dict:
        if not os.path.exists(self.path):
            return {"workers": {}}
        try:
            with open(self.path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            # A torn map should be impossible (atomic replace) but a
            # deleted/garbled one must not take the fleet down.
            return {"workers": {}}

    def _write(self, data: dict) -> None:
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmpresidency_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def publish(self, worker: str, models: dict, *, loads: int = 0,
                evictions: int = 0) -> None:
        """Replace ``worker``'s residency row with ``{model: bytes}``.
        The row is heartbeat-stamped: publishing IS proof of life."""
        with self._locked():
            data = self._read()
            data["workers"][worker] = {
                "models": {m: int(b) for m, b in sorted(models.items())},
                "resident_bytes": int(sum(models.values())),
                "loads": int(loads), "evictions": int(evictions),
                "heartbeat": float(self._clock()),
            }
            self._write(data)

    def heartbeat(self, worker: str) -> None:
        """Refresh ``worker``'s lease stamp without touching its models.
        A worker with no row yet gets an empty one — heartbeating before
        the first load still claims the lease."""
        with self._locked():
            data = self._read()
            row = data["workers"].setdefault(
                worker, {"models": {}, "resident_bytes": 0,
                         "loads": 0, "evictions": 0})
            row["heartbeat"] = float(self._clock())
            self._write(data)

    def expire_dead(self, ttl_s: float, *, now: float | None = None
                    ) -> list[str]:
        """Reap every worker row whose heartbeat is older than ``ttl_s``
        (returned sorted).  Rows written by pre-lease code (no stamp)
        count as dead."""
        if now is None:
            now = self._clock()
        with self._locked():
            data = self._read()
            dead = sorted(
                w for w, row in data["workers"].items()
                if now - row.get("heartbeat", float("-inf")) > ttl_s)
            for w in dead:
                del data["workers"][w]
            if dead:
                self._write(data)
        for w in dead:
            obs.get_metrics().counter("lease_expirations").inc()
            obs.instant("fleet.lease_expired", worker=w)
        return dead

    def retire(self, worker: str) -> None:
        """Drop a worker's row (clean shutdown)."""
        with self._locked():
            data = self._read()
            if data["workers"].pop(worker, None) is not None:
                self._write(data)

    def snapshot(self) -> dict:
        """Point-in-time copy of the whole map (shared lock not needed:
        reads see either the old or the new atomic file)."""
        return self._read()

    def holders(self, model: str, *, ttl_s: float | None = None
                ) -> list[str]:
        """Workers currently holding ``model`` resident — the routing
        hint: their page cache (and device copy) is warm.  With
        ``ttl_s``, only workers whose lease is fresh count — a dead
        holder's stale claim is never routed to."""
        snap = self._read()
        now = self._clock()
        return sorted(
            w for w, row in snap["workers"].items()
            if model in row.get("models", {})
            and (ttl_s is None
                 or now - row.get("heartbeat", float("-inf")) <= ttl_s))

    def fleet_resident_bytes(self) -> int:
        snap = self._read()
        return sum(row.get("resident_bytes", 0)
                   for row in snap["workers"].values())


class FleetRegistry(EncoderRegistry):
    """An ``EncoderRegistry`` that mirrors its residency into a shared
    ``ResidencyMap`` under ``worker_id`` — loads, LRU evictions, and
    explicit fault evictions all publish, so the fleet view tracks the
    true per-process account (which the in-process lock already keeps
    exact)."""

    def __init__(self, *, worker_id: str, residency_map: ResidencyMap,
                 **kwargs):
        super().__init__(**kwargs)
        self.worker_id = worker_id
        self.residency_map = residency_map

    def _publish(self) -> None:
        with self._lock:
            models = {name: e.resident_bytes
                      for name, e in self._loaded.items()}
            for (name, i), e in self._shards.items():
                key = f"{name}#shard{i}"
                models[key] = e.resident_bytes
            loads = self.loads + self.shard_loads
            evictions = self.evictions
        self.residency_map.publish(self.worker_id, models,
                                   loads=loads, evictions=evictions)

    def get(self, name, *, wave_rows=None, score_slots=0):
        with self._lock:
            before = (self.loads, self.evictions)
            entry = super().get(name, wave_rows=wave_rows,
                                score_slots=score_slots)
            changed = (self.loads, self.evictions) != before
        if changed:
            self._publish()
        return entry

    def get_columns(self, name, col_range, *, wave_rows=None):
        with self._lock:
            before = (self.shard_loads, self.evictions)
            out = super().get_columns(name, col_range, wave_rows=wave_rows)
            changed = (self.shard_loads, self.evictions) != before
        if changed:
            self._publish()
        return out

    def evict(self, name):
        hit = super().evict(name)
        if hit:
            self._publish()
        return hit

    def heartbeat(self) -> None:
        """Refresh this worker's lease (call between serving windows —
        every publish also stamps it, so only an *idle* worker needs
        explicit heartbeats to keep its claims routable)."""
        self.residency_map.heartbeat(self.worker_id)

    def close(self) -> None:
        """Retire this worker's row from the shared map."""
        self.residency_map.retire(self.worker_id)


@dataclasses.dataclass
class _Pending:
    request: PredictRequest
    index: int              # submission order — results come back in it


class FleetFrontend:
    """Bounded-admission front door over an ``EncoderService``.

    >>> fe = FleetFrontend(service, max_pending_rows=4096)
    >>> fe.submit(PredictRequest("sub-01", X))       # admitted (or raises)
    >>> results = fe.flush()                         # one mixed-wave batch

    ``submit`` admits a request only while the queued row total stays
    within ``max_pending_rows`` — the SLO knob: rows are what a wave
    spends latency on, so bounding rows bounds the worst-case drain time.
    Overflow raises a typed ``ServiceError`` (and bumps the tenant's
    ``rejected`` count): the client sheds load instead of the worker
    stalling or OOM-ing.  ``flush`` serves everything admitted so far in
    ONE ``serve`` call — same-model requests pack into shared mixed
    waves, and with ``prefetch_next`` on the service the next model's
    bundle is touched while the current one's waves are in flight.
    """

    def __init__(self, service: EncoderService, *,
                 max_pending_rows: int = 4096):
        if max_pending_rows < 1:
            raise ServiceError(f"max_pending_rows must be >= 1, "
                               f"got {max_pending_rows}")
        self.service = service
        self.max_pending_rows = max_pending_rows
        self._pending: list[_Pending] = []
        self._pending_rows = 0
        self.admitted = 0
        self.rejected = 0
        self.replayed = 0    # requests re-admitted after a lost worker

    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    def submit(self, request: PredictRequest) -> int:
        """Admit one request; returns its submission index within the
        current window.  Raises ``ServiceError`` on backpressure."""
        rows = int(np_rows(request))
        if self._pending_rows + rows > self.max_pending_rows:
            self.rejected += 1
            self.service.stats.record_rejected(request.tenant_id)
            obs.get_metrics().counter("rejected_requests").inc()
            obs.instant("fleet.reject", tenant=request.tenant_id,
                        rows=rows, pending_rows=self._pending_rows)
            raise ServiceError(
                f"admission rejected for tenant {request.tenant_id!r}: "
                f"{rows} rows would put the queue at "
                f"{self._pending_rows + rows} > max_pending_rows="
                f"{self.max_pending_rows} — retry after a flush")
        idx = len(self._pending)
        self._pending.append(_Pending(request, idx))
        self._pending_rows += rows
        self.admitted += 1
        obs.get_metrics().counter("admitted_rows").inc(rows)
        obs.instant("fleet.admit", tenant=request.tenant_id, rows=rows)
        return idx

    def flush(self, *, wave_rows: int | None = None) -> list[PredictResult]:
        """Serve everything admitted since the last flush (one mixed-wave
        batch; results in submission order) and empty the queue.

        If the worker dies with the batch in flight (:class:`WorkerLost`),
        the batch is RE-ADMITTED — the queue is restored exactly as it
        was, ``requests_replayed`` counts the survivors, and the error
        propagates so the caller can retry the flush (``replay`` does).
        """
        if not self._pending:
            return []
        pending = self._pending
        batch = [p.request for p in pending]
        rows = self._pending_rows
        self._pending = []
        self._pending_rows = 0
        with obs.span("fleet.flush", requests=len(batch), rows=rows):
            try:
                return self.service.serve(batch, wave_rows=wave_rows)
            except WorkerLost:
                # The requests died with the worker — put them back in
                # admission order instead of dropping them on the floor.
                self._pending = pending
                self._pending_rows = rows
                self.replayed += len(batch)
                obs.get_metrics().counter("requests_replayed").inc(
                    len(batch))
                obs.instant("fleet.replay", requests=len(batch), rows=rows)
                raise

    def replay(self, requests: Sequence[PredictRequest], *,
               wave_rows: int | None = None, max_flush_attempts: int = 3
               ) -> tuple[list[PredictResult | None], list[Exception]]:
        """Drain a traffic sequence through bounded admission, surviving
        lost workers: requests whose flush dies with a worker stay
        admitted and the flush is retried (up to ``max_flush_attempts``
        per window) — see the module-level :func:`replay`."""
        return replay(self, requests, wave_rows=wave_rows,
                      max_flush_attempts=max_flush_attempts)


def np_rows(request: PredictRequest) -> int:
    return int(np.shape(request.features)[0])


def replay(frontend: FleetFrontend, requests: Sequence[PredictRequest], *,
           wave_rows: int | None = None, max_flush_attempts: int = 3
           ) -> tuple[list[PredictResult | None], list[Exception]]:
    """Replay a traffic sequence through bounded admission: submit until
    backpressure, flush, resubmit — the drain loop every harness uses.
    A flush that dies with its worker (:class:`WorkerLost`) leaves the
    window re-admitted in the frontend (see ``flush``); the drain retries
    it up to ``max_flush_attempts`` times before giving up, so a worker
    lost mid-trace costs a retry, not the requests.  Returns (results in
    arrival order — ``None`` only if a request was rejected twice, i.e.
    it alone overflows the queue — , rejections)."""
    results: list[PredictResult | None] = [None] * len(requests)
    rejections: list[Exception] = []
    window: list[int] = []

    def drain():
        for attempt in range(max_flush_attempts):
            try:
                flushed = frontend.flush(wave_rows=wave_rows)
                break
            except WorkerLost:
                if attempt + 1 >= max_flush_attempts:
                    raise
        for i, res in zip(window, flushed):
            results[i] = res
        window.clear()

    for i, req in enumerate(requests):
        try:
            frontend.submit(req)
            window.append(i)
        except ServiceError as err:
            rejections.append(err)
            drain()
            try:
                frontend.submit(req)
                window.append(i)
            except ServiceError as err2:      # alone it overflows: skip
                rejections.append(err2)
    drain()
    return results, rejections


__all__ = ["FleetFrontend", "FleetRegistry", "ResidencyMap", "RESIDENCY_MAP",
           "FleetError", "WorkerLost", "replay"]
