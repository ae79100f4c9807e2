"""Orphaned-staging reaper: sweep up what crashed writers left behind.

Port of ``repro/resilience/cleanup.py``.  Every atomic-rename writer
stages under a well-known temporary name next to its target (``*.tmp-<pid>``
for shard writes, ``manifest.json.tmp`` for the store manifest, and the
bundle writers' ``.tmpbundle_*`` / ``.old_*``).  A process killed mid-write
leaves that entry behind; no manifest references it, so it is garbage.

:func:`reap_stale_staging` deletes such entries **age-gated**: only entries
whose mtime is older than ``max_age_s`` go (a live concurrent writer's
staging is younger than that), and every reaped entry is counted in the
``staging_reaped`` obs counter plus an ``obs.instant("cleanup.reap")``
marker.
"""
from __future__ import annotations

import fnmatch
import os
import shutil
import time

from repro_torch import obs

__all__ = ["STAGING_PATTERNS", "reap_stale_staging"]

#: glob patterns every atomic-rename writer stages under.
STAGING_PATTERNS = (
    ".tmpbundle_*",        # BundleWriter staging dirs
    ".tmpresidency_*",     # ResidencyMap atomic-JSON staging
    "*.tmp-*",             # shard/array tmp-then-rename files
    "manifest.json.tmp",   # RunStore manifest staging
    ".old_*",              # replaced-bundle graveyard dirs
)


def reap_stale_staging(root: str, *, max_age_s: float = 3600.0,
                       patterns: tuple[str, ...] = STAGING_PATTERNS,
                       now: float | None = None) -> list[str]:
    """Delete stale staging entries directly under ``root``.

    Returns the (possibly empty) list of reaped entry names.  A missing
    ``root`` is a no-op; entries that vanish mid-sweep (a concurrent
    reaper) are skipped silently — the sweep is best-effort and never
    raises for reapable garbage.
    """
    if not os.path.isdir(root):
        return []
    if now is None:
        now = time.time()
    reaped: list[str] = []
    for name in sorted(os.listdir(root)):
        if not any(fnmatch.fnmatch(name, pat) for pat in patterns):
            continue
        path = os.path.join(root, name)
        try:
            age = now - os.lstat(path).st_mtime
        except OSError:
            continue                        # vanished mid-sweep
        if age < max_age_s:
            continue                        # possibly a live writer
        try:
            if os.path.isdir(path) and not os.path.islink(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.unlink(path)
        except OSError:
            continue
        reaped.append(name)
        obs.instant("cleanup.reap", path=name, age_s=round(age, 1))
    if reaped:
        obs.get_metrics().counter("staging_reaped").inc(len(reaped))
    return reaped
