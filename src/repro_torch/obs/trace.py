"""Span tracing — nested, thread-safe, exportable to JSONL and Perfetto.

One process-global tracer slot (``install``/``uninstall``): when empty,
``span()`` costs one module-global load plus returning a shared no-op
singleton — the hot paths stay instrumented permanently without paying
for it.  When a :class:`Tracer` is installed every ``span`` context
records a completed event on exit:

* ``name`` — dotted phase name (``fit.stats``, ``prefetch.wait``, …);
  the naming convention is documented in ``repro_torch.obs`` and in the
  ``repro_torch.encoding`` package docstring.
* ``ts_us``/``dur_us`` — microseconds on the tracer's monotonic clock
  (``time.perf_counter`` based; never wall-clock, so spans order
  correctly across NTP slews).
* ``track`` — a small per-thread integer (0 = first thread seen), and
  ``tid`` the OS thread ident, so concurrent threads render as separate
  tracks in Perfetto.
* ``depth``/``parent`` — nesting within the thread (a thread-local span
  stack), so reports can attribute child time to phases.
* ``attrs`` — user key/values (``bytes=...``, ``tenant=...``).

Export formats:

* ``write_jsonl(path)`` — one JSON object per event line (the format
  ``launch/obs_report.py`` and ``benchmarks/parse_sweep_log.py`` read).
* ``write_perfetto(path)`` — Chrome ``trace_event`` JSON
  (``{"traceEvents": [...]}``, ``ph="X"`` complete events), loadable
  directly in https://ui.perfetto.dev.

``timed(name)`` is the variant the streaming tier uses: it ALWAYS
measures the region (two ``perf_counter`` calls) and exposes ``.dur_s``,
emitting the span only when a tracer is installed — so derived stats
(``PrefetchStats`` stall seconds) and the trace are two views of the
SAME measurement instead of parallel bookkeeping.

While ``torch.profiler`` runs, ``span`` and ``timed`` also open a
profiler range under the span's name (``_RecordFunctionFast``), with or
without a tracer installed, so the spans nest on the profiler's own
timeline among the torch ops they enclose and name the host work a
device trace would otherwise call "no torch op".  The range only marks
time: it adds no synchronise.  The profiler records a range on the
thread that started it only, so spans of other threads (the
prefetcher's ``prefetch.stage``) do not reach its trace.  With the
profiler off the cost is one flag check.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = [
    "Tracer", "span", "timed", "instant", "install", "uninstall",
    "current", "write_trace",
]

_tracer: "Tracer | None" = None


class _NullSpan:
    """Shared no-op span: returned when no tracer is installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


def _open_range(name: str) -> _RecordFunctionFast:
    """An entered profiler range; the caller checked the profiler runs."""
    rf = _RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _Range:
    """A span with no tracer installed while ``torch.profiler`` runs: the
    profiler range alone, nothing recorded."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        self._rf = _open_range(self.name)
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(None, None, None)
        return False

    def set(self, **attrs):
        return self


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._rf = None

    def set(self, **attrs):
        """Attach/override attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = _open_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        tr = self._tracer
        stack = tr._tls.stack
        stack.pop()
        parent = stack[-1].name if stack else None
        tr._record(self.name, self._t0, t1 - self._t0, len(stack),
                   parent, self.attrs)
        return False


class _Timed:
    """Always-measured region; span emitted only if a tracer is live.

    The measured ``dur_s`` is the single source both for derived stats
    (e.g. prefetch stall accounting) and — when tracing is on — for the
    recorded span, so they can never drift apart.
    """

    __slots__ = ("name", "attrs", "_t0", "dur_s", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.dur_s = 0.0
        self._rf = None

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = _open_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.dur_s = t1 - self._t0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        tr = _tracer
        if tr is not None:
            stack = getattr(tr._tls, "stack", None)
            depth = len(stack) if stack else 0
            parent = stack[-1].name if stack else None
            tr._record(self.name, self._t0, self.dur_s, depth, parent,
                       self.attrs)
        return False


class Tracer:
    """Thread-safe in-memory span collector on a monotonic clock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._tls = threading.local()
        self._tracks: dict[int, int] = {}
        self._epoch = time.perf_counter()
        self.pid = os.getpid()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _Span:
        return _Span(self, name, attrs)

    def _track_id(self, ident: int) -> int:
        tid = self._tracks.get(ident)
        if tid is None:
            tid = self._tracks[ident] = len(self._tracks)
        return tid

    def _record(self, name: str, t0: float, dur_s: float, depth: int,
                parent: str | None, attrs: dict) -> None:
        ident = threading.get_ident()
        with self._lock:
            self._events.append({
                "name": name,
                "ts_us": round((t0 - self._epoch) * 1e6, 3),
                "dur_us": round(dur_s * 1e6, 3),
                "track": self._track_id(ident),
                "tid": ident,
                "depth": depth,
                "parent": parent,
                "attrs": attrs,
            })

    def instant(self, name: str, **attrs: Any) -> None:
        """Record a zero-duration marker event (Perfetto ``ph="i"``)."""
        ident = threading.get_ident()
        stack = getattr(self._tls, "stack", None)
        with self._lock:
            self._events.append({
                "name": name,
                "ts_us": round((time.perf_counter() - self._epoch) * 1e6, 3),
                "dur_us": 0.0,
                "track": self._track_id(ident),
                "tid": ident,
                "depth": len(stack) if stack else 0,
                "parent": stack[-1].name if stack else None,
                "attrs": attrs,
                "instant": True,
            })

    # -- reading / export --------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")

    def to_perfetto(self) -> dict:
        """Chrome/Perfetto ``trace_event`` document (``ph="X"`` complete
        events, instants as ``ph="i"``)."""
        out = []
        for ev in self.events():
            rec = {"name": ev["name"], "cat": ev["name"].split(".")[0],
                   "ph": "i" if ev.get("instant") else "X",
                   "ts": ev["ts_us"], "pid": self.pid, "tid": ev["track"],
                   "args": dict(ev["attrs"], depth=ev["depth"])}
            if not ev.get("instant"):
                rec["dur"] = ev["dur_us"]
            else:
                rec["s"] = "t"
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_perfetto(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)
            f.write("\n")


def install(tracer: "Tracer | None" = None) -> Tracer:
    """Install (and return) the process-global tracer."""
    global _tracer
    if tracer is None:
        tracer = Tracer()
    _tracer = tracer
    return tracer


def uninstall() -> None:
    global _tracer
    _tracer = None


def current() -> "Tracer | None":
    return _tracer


def span(name: str, **attrs: Any):
    """Open a (context-manager) span — a shared no-op when no tracer is
    installed and ``torch.profiler`` is off, so permanently instrumented
    hot paths cost one module attribute load and one flag check on the
    disabled path; the profiler's range alone when only the profiler
    runs."""
    t = _tracer
    if t is None:
        if _profiler._is_profiler_enabled:
            return _Range(name)
        return _NULL_SPAN
    return t.span(name, **attrs)


def timed(name: str, **attrs: Any) -> _Timed:
    """Always-measured region (see module docstring): ``.dur_s`` is valid
    whether or not a tracer is installed; a profiler range too while
    ``torch.profiler`` runs."""
    return _Timed(name, attrs)


def instant(name: str, **attrs: Any) -> None:
    """Zero-duration marker (admit/reject/hit events)."""
    t = _tracer
    if t is not None:
        t.instant(name, **attrs)


def write_trace(tracer: Tracer, path: str) -> str:
    """Write ``tracer`` to ``path`` — Perfetto ``trace_event`` JSON when
    the suffix is ``.json``, JSONL otherwise.  Returns the format used."""
    if path.endswith(".json"):
        tracer.write_perfetto(path)
        return "perfetto"
    tracer.write_jsonl(path)
    return "jsonl"
