"""Compile counting + the recompile sentinel.

Port of ``repro/obs/sentinel.py``.  The reference counts XLA traces: a
Python side effect inside a jitted body runs once per distinct trace
signature.  Eager PyTorch traces nothing, so the port's "compile" is the
first sight of a new fixed-shape signature by one of its fixed-shape
tiers (``foldstats._FixedShapeUpdate``, ``wholebrain._ColumnBlockUpdate``,
``EncoderService``'s wave programs); each calls ``counter.mark()``
exactly where it records such a signature.

``mark()`` does three things:

1. bumps ``.count`` (the number every existing gate reads — the public
   aliases ``chunk_update_compile_count`` etc. read it);
2. bumps the global metric ``compiles{tier=<tier>}``;
3. enforces the **recompile sentinel**: inside an ``expect(at_most=N)``
   window, a new signature that would push the window's compile delta
   past N raises :class:`RecompileError` AT THAT CALL, before the update
   runs, when strict mode is on.

Strict mode is ``REPRO_OBS_STRICT=1`` in the environment (the same
variable as the reference), turning post-hoc ``compile_count == 1``
assertions into a guard that fires at the moment of the violation.  Off
by default: an unexpected new signature in an exploratory session is a
perf bug, not a crash.
"""
from __future__ import annotations

import contextlib
import os

from repro_torch.obs.metrics import get_metrics

__all__ = ["CompileCounter", "RecompileError", "strict_enabled"]


class RecompileError(RuntimeError):
    """A fixed-shape tier saw more new signatures than its expectation
    window allows (raised at that call under ``REPRO_OBS_STRICT=1``)."""


def strict_enabled() -> bool:
    return os.environ.get("REPRO_OBS_STRICT", "") == "1"


class CompileCounter:
    """Signature counter for one fixed-shape tier.

    >>> compiles = CompileCounter("foldstats.chunk_update")
    >>> def update(chunk):
    ...     if signature(chunk) not in seen:
    ...         compiles.mark()      # once per distinct signature
    ...         seen.add(signature(chunk))
    ...     ...
    >>> with compiles.expect(at_most=1):     # the fixed-shape contract
    ...     for chunk in stream: update(chunk)

    ``expect`` windows nest (inner windows shadow outer); the window
    limit is evaluated inside ``mark``, so a violating signature raises
    before its update runs — under strict mode only.
    """

    def __init__(self, tier: str):
        self.tier = tier
        self.count = 0
        self._limit: int | None = None          # absolute ceiling in-window
        self._metric = get_metrics().counter("compiles", tier=tier)

    def mark(self) -> None:
        """Call where the tier first sees a new signature."""
        self.count += 1
        self._metric.inc()
        if (self._limit is not None and self.count > self._limit
                and strict_enabled()):
            raise RecompileError(
                f"{self.tier}: compile #{self.count} exceeds the expectation "
                f"window (allowed {self._limit}) — a fixed-shape tier is "
                f"seeing a new signature (REPRO_OBS_STRICT=1)")

    @contextlib.contextmanager
    def expect(self, at_most: int = 1):
        """Bound compiles inside the ``with`` body to ``at_most`` beyond
        the current count (sentinel active only under strict mode)."""
        prev = self._limit
        self._limit = self.count + at_most
        try:
            yield self
        finally:
            self._limit = prev

    def delta(self, before: int) -> int:
        return self.count - before

    def __int__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return f"CompileCounter({self.tier!r}, count={self.count})"
