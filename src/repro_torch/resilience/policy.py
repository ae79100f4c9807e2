"""Transient-fault retry policy for the streaming tier.

Port of ``repro/resilience/policy.py``.  A :class:`FaultPolicy` describes
how to retry an I/O operation that failed transiently: how many attempts,
how the backoff grows, how much deterministic jitter to add, and an
optional per-op wall-clock deadline.  :func:`retry_call` executes a
callable under a policy, classifying each exception as transient (retry)
or permanent (raise immediately).  The reference's ``io_retries`` /
``io_giveups`` counters and ``retry.backoff`` spans are not carried over
yet.

Determinism: the jitter is a pure function of ``(seed, op, attempt)``
(CRC32-derived), never ``random``/wall clock, so two processes with the
same policy back off identically.  ``sleep`` and ``clock`` are injectable
so tests run with a virtual clock.

Classification: :class:`TransientFault` (and any exception with a truthy
``transient`` attribute) always retries; plain ``OSError`` with errno in
:data:`TRANSIENT_ERRNOS` and ``TimeoutError`` retry; everything else is
permanent and propagates on the first occurrence.
"""
from __future__ import annotations

import errno
import time
import zlib
from dataclasses import dataclass, field, replace
from typing import Callable

__all__ = [
    "FaultPolicy", "TransientFault", "RetryGiveUp", "retry_call",
    "classify_default", "TRANSIENT_ERRNOS", "NO_RETRY",
]

#: errno values treated as transient for plain ``OSError``.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ETIMEDOUT,
})


class TransientFault(OSError):
    """An error the caller should retry under its :class:`FaultPolicy`.

    Subclasses ``OSError`` so that give-up translation sites (``except
    OSError: raise StoreError``) keep working when a retry loop exhausts
    and re-raises.
    """

    transient = True


class RetryGiveUp(RuntimeError):
    """Marker kept for interface parity with the reference — never raised:
    the original exception is always re-raised on give-up."""


def classify_default(exc: BaseException) -> bool:
    """Return True if ``exc`` should be retried (transient)."""
    t = getattr(exc, "transient", None)
    if t is not None:
        return bool(t)
    if isinstance(exc, TimeoutError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return False


@dataclass(frozen=True)
class FaultPolicy:
    """How to retry one class of I/O operation.

    Attributes
    ----------
    max_attempts : total tries including the first (>= 1).
    base_delay_s : backoff before attempt 2 (then grows by ``backoff``).
    backoff      : multiplicative growth per retry.
    max_delay_s  : backoff cap.
    jitter       : fraction of the delay perturbed deterministically
                   from ``(seed, op, attempt)``; 0 disables.
    deadline_s   : optional per-op wall-clock budget measured on
                   ``clock``; exceeded -> give up even with attempts
                   remaining.
    seed         : jitter seed (same seed -> same delays everywhere).
    sleep/clock  : injectable for tests (virtual time, no real sleeps).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    backoff: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.25
    deadline_s: float | None = None
    seed: int = 0
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)

    def delay_for(self, op: str, attempt: int) -> float:
        """Deterministic backoff before retry number ``attempt`` (1-based)."""
        d = min(self.base_delay_s * (self.backoff ** (attempt - 1)),
                self.max_delay_s)
        if self.jitter:
            h = zlib.crc32(f"{self.seed}:{op}:{attempt}".encode()) / 0xFFFFFFFF
            d *= 1.0 + self.jitter * (2.0 * h - 1.0)
        return max(d, 0.0)

    def with_virtual_time(self) -> "FaultPolicy":
        """Copy with a no-op sleep and a counting clock (for tests)."""
        t = [0.0]

        def _sleep(s: float) -> None:
            t[0] += s

        def _clock() -> float:
            return t[0]

        return replace(self, sleep=_sleep, clock=_clock)


#: Policy that never retries — used to opt a path out without branching.
NO_RETRY = FaultPolicy(max_attempts=1, base_delay_s=0.0, jitter=0.0)


def retry_call(fn: Callable, policy: FaultPolicy | None, op: str,
               classify: Callable[[BaseException], bool] = classify_default):
    """Run ``fn()`` under ``policy``; retry transient failures.

    Raises the LAST exception unchanged on give-up (attempt or deadline
    exhaustion) and the FIRST exception unchanged when permanent, so
    callers' ``except`` clauses see the same types as without a policy.
    """
    if policy is None:
        policy = NO_RETRY
    start = policy.clock()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 - reclassified below
            if not classify(exc):
                raise
            out_of_attempts = attempt >= policy.max_attempts
            out_of_time = (policy.deadline_s is not None
                           and policy.clock() - start >= policy.deadline_s)
            if out_of_attempts or out_of_time:
                raise
            delay = policy.delay_for(op, attempt)
            if delay > 0.0:
                policy.sleep(delay)
