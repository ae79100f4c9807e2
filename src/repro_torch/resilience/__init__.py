"""repro_torch.resilience — the crash-safe execution tier.

Port of ``repro/resilience``.  Three independent mechanisms, one
deterministic test harness:

* **Retry** (:mod:`~repro_torch.resilience.policy`): :class:`FaultPolicy`
  (attempts, exponential backoff with deterministic jitter, per-op
  deadline) + :func:`retry_call`, wired into ``RunStore`` shard mmaps,
  the ``ChunkPrefetcher`` reader (which restarts its stream at the next
  unconsumed chunk), and ``EncoderRegistry`` bundle/shard loads.
  Retries and give-ups are ``repro_torch.obs`` counters
  (``io_retries{op=...}`` / ``io_giveups{op=...}``).
* **Checkpoint/resume** (:mod:`~repro_torch.resilience.journal`):
  :class:`FitJournal` — the atomic-rename progress ledger that makes a
  killed ``fit_wholebrain`` resumable with bit-identical λ and W.
* **Cleanup** (:mod:`~repro_torch.resilience.cleanup`):
  :func:`reap_stale_staging` — age-gated sweep of the staging dirs and
  tmp files crashed writers leave behind.

:mod:`~repro_torch.resilience.faultsim` is the seeded fault-injection
harness (fail the Nth read, truncate a payload, kill after block N) that
makes every resilience test deterministic.  Fleet liveness (heartbeat
leases, ``expire_dead``, request replay) lives with the fleet itself in
``repro_torch.serving_encoders.fleet``.
"""
from repro_torch.resilience.cleanup import (  # noqa: F401
    STAGING_PATTERNS, reap_stale_staging,
)
from repro_torch.resilience.journal import (  # noqa: F401
    FitJournal, JournalError,
)
from repro_torch.resilience.policy import (  # noqa: F401
    NO_RETRY, FaultPolicy, RetryGiveUp, TransientFault, classify_default,
    retry_call,
)

__all__ = [
    "FaultPolicy", "TransientFault", "RetryGiveUp", "retry_call",
    "classify_default", "NO_RETRY",
    "FitJournal", "JournalError",
    "reap_stale_staging", "STAGING_PATTERNS",
]
