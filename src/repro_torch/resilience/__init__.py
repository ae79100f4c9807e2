"""Resilience helpers of the port: retry policy and staging cleanup.

Copies of ``repro/resilience/policy.py`` and ``cleanup.py`` without their
observability spans and counters (those come with the port's obs slice).
``RunStore`` uses both: ``FaultPolicy`` arms retry on shard reads, and
``reap_stale_staging`` sweeps what a crashed writer left behind.
"""
from repro_torch.resilience.cleanup import (  # noqa: F401
    STAGING_PATTERNS, reap_stale_staging,
)
from repro_torch.resilience.policy import (  # noqa: F401
    NO_RETRY, FaultPolicy, RetryGiveUp, TransientFault, classify_default,
    retry_call,
)
