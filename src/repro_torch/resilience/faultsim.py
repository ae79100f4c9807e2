"""Deterministic fault-injection harness for the resilience tier.

Port of ``repro/resilience/faultsim.py``.

Every retry/lease/resume test in the repo drives failures through ONE
seeded :class:`FaultInjector` instead of monkeypatched randomness or
sleep-and-hope timing: the injector counts invocations per named op and
raises exactly the planned exception on exactly the planned invocation.
Two runs with the same plan fail identically — which is what lets a
check gate "injected transient read faults change neither λ nor
compile_count" as a bitwise assertion.

Wrappers around the real components:

* :func:`wrap_store` — a ``RunStore`` whose shard mmaps (op
  ``store.mmap``) and per-chunk yields (op ``store.chunk``) consult the
  injector; the store's retry policy and the ``ChunkPrefetcher``'s
  stream-restart path are exercised against it unmodified.
* :func:`flaky_proxy` — a generic delegating proxy that interposes the
  injector before named methods; :func:`flaky_bundle` specialises it for
  ``EncoderBundle`` loads (ops ``bundle.load_encoder`` /
  ``bundle.load_shard``).
* :class:`KillAfterBlock` — a ``FitJournal`` wrapper that hard-kills the
  process (``os._exit``) immediately after block N commits to the
  ledger: the crash-resume gate's deterministic "pull the plug here".
* :func:`truncate_file` — torn-write simulation for staging payloads.
"""
from __future__ import annotations

import os
import threading
from typing import Callable

from repro_torch.resilience.policy import TransientFault

__all__ = [
    "InjectedFault", "InjectedPermanentFault", "FaultInjector",
    "wrap_store", "flaky_proxy", "flaky_bundle", "KillAfterBlock",
    "truncate_file",
]


class InjectedFault(TransientFault):
    """A planned transient failure (retryable under any FaultPolicy)."""


class InjectedPermanentFault(OSError):
    """A planned permanent failure — must NOT be retried."""

    transient = False


class FaultInjector:
    """Seeded, counting fault planner.

    ``plan(op, fail_at)`` arms invocation number ``fail_at`` (1-based) of
    ``op``; ``check(op)`` — called by the wrappers on every invocation —
    raises the armed exception when the count matches.  ``times`` arms a
    run of consecutive failures (attempts ``fail_at`` ..
    ``fail_at + times - 1``), which is how a test forces a give-up with
    ``max_attempts`` retries.  Thread-safe: the prefetcher's reader
    thread and the consumer may both consult the injector.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._plans: dict[str, list[tuple[int, Callable[[], BaseException]]]] \
            = {}
        self._fired: dict[str, int] = {}

    def plan(self, op: str, fail_at: int, *, times: int = 1,
             exc: Callable[[], BaseException] | None = None) -> None:
        if fail_at < 1 or times < 1:
            raise ValueError("fail_at and times are 1-based and positive")
        if exc is None:
            exc = lambda: InjectedFault(  # noqa: E731
                f"injected fault: op={op} seed={self.seed}")
        with self._lock:
            plans = self._plans.setdefault(op, [])
            plans.extend((fail_at + i, exc) for i in range(times))

    def check(self, op: str) -> None:
        """Count one invocation of ``op``; raise if this one was planned."""
        with self._lock:
            n = self._counts.get(op, 0) + 1
            self._counts[op] = n
            hit = None
            for i, (at, exc) in enumerate(self._plans.get(op, ())):
                if at == n:
                    hit = exc
                    del self._plans[op][i]
                    self._fired[op] = self._fired.get(op, 0) + 1
                    break
        if hit is not None:
            raise hit()

    def count(self, op: str) -> int:
        with self._lock:
            return self._counts.get(op, 0)

    def fired(self, op: str) -> int:
        with self._lock:
            return self._fired.get(op, 0)


def wrap_store(store, injector: FaultInjector):
    """A ``RunStore`` clone whose reads consult ``injector``.

    Ops: ``store.mmap`` (one per shard-pair mapping — the
    ``_mmap_raw`` seam the store-level retry wraps) and ``store.chunk``
    (one per chunk yielded by the synchronous iterator — what the
    prefetcher's restarting reader sees mid-stream).
    """
    base = type(store)

    class _FaultyStore(base):
        def _mmap_raw(self, r):
            injector.check("store.mmap")
            return super()._mmap_raw(r)

        def _iter_chunks_sync(self, *args, **kwargs):
            for item in super()._iter_chunks_sync(*args, **kwargs):
                injector.check("store.chunk")
                yield item

    faulty = object.__new__(_FaultyStore)
    faulty.__dict__.update(store.__dict__)
    return faulty


class _FlakyProxy:
    """Delegating proxy that runs ``injector.check(op)`` before the
    named methods (everything else passes straight through)."""

    def __init__(self, target, injector: FaultInjector, ops: dict):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_injector", injector)
        object.__setattr__(self, "_ops", dict(ops))

    def __getattr__(self, name):
        attr = getattr(self._target, name)
        op = self._ops.get(name)
        if op is None or not callable(attr):
            return attr

        def _guarded(*args, **kwargs):
            self._injector.check(op)
            return attr(*args, **kwargs)

        return _guarded


def flaky_proxy(target, injector: FaultInjector, ops: dict):
    """Wrap ``target`` so each method named in ``ops`` consults the
    injector under its op label before delegating."""
    return _FlakyProxy(target, injector, ops)


def flaky_bundle(bundle, injector: FaultInjector):
    """An ``EncoderBundle`` whose loads consult the injector (ops
    ``bundle.load_encoder`` / ``bundle.load_shard``)."""
    return flaky_proxy(bundle, injector, {
        "load_encoder": "bundle.load_encoder",
        "load_weight_shard": "bundle.load_shard",
    })


class KillAfterBlock:
    """``FitJournal`` wrapper: hard-exit right after block ``n`` commits.

    ``os._exit`` (no atexit, no finally blocks) models a SIGKILL'd fit
    child at the exact crash-consistency boundary: the ledger lists
    blocks 0..n, everything later is lost.  Exit code defaults to 42 so
    the launcher's crash-resume gate can tell a planned kill from a real
    failure.
    """

    def __init__(self, journal, kill_after: int, *, exit_code: int = 42):
        self._journal = journal
        self._kill_after = kill_after
        self._exit_code = exit_code

    def put_block(self, bi: int, **kwargs) -> None:
        self._journal.put_block(bi, **kwargs)
        if bi == self._kill_after:
            os._exit(self._exit_code)

    def __getattr__(self, name):
        return getattr(self._journal, name)


def truncate_file(path: str, keep_bytes: int) -> None:
    """Simulate a torn write: keep only the first ``keep_bytes`` bytes."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
