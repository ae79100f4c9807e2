"""Process-global metrics registry: typed counters/gauges/histograms.

One :class:`MetricsRegistry` instance (module-global ``REGISTRY``,
reachable via :func:`get_metrics`) holds every metric in the process.
Instruments are identified by ``(name, sorted(labels))`` — asking twice
returns the SAME object, so hot paths hoist the lookup once
(``ctr = get_metrics().counter("bytes_staged")``) and pay a plain
float-add per event afterwards.

``snapshot()`` renders everything into ONE JSON-serialisable dict (the
shared schema documented in ``repro_torch.obs.__doc__``), whose marker
``stream_stats_``, ``ServiceStats.to_dict`` and ``PrefetchStats.to_dict``
carry instead of inventing bespoke key sets.  Label sets flatten
Prometheus-style: ``compiles{tier=foldstats}``.

The RSS gauge is fed by :func:`start_rss_poller` — a daemon thread that
samples ``/proc/self/status`` ``VmRSS`` (fallback: ``ru_maxrss``) every
``interval_s`` into ``rss_bytes`` / high-water ``rss_peak_bytes``.
"""
from __future__ import annotations

import json
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_metrics", "snapshot", "start_rss_poller", "read_rss_bytes",
    "SCHEMA_VERSION",
]

SCHEMA_VERSION = "repro.obs/v1"


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing float."""

    __slots__ = ("key", "value", "_lock")

    def __init__(self, key: str):
        self.key = key
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class Gauge:
    """Last-write-wins instantaneous value (also tracks its own peak)."""

    __slots__ = ("key", "value", "peak", "_lock")

    def __init__(self, key: str):
        self.key = key
        self.value = 0.0
        self.peak = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
            if v > self.peak:
                self.peak = v


class Histogram:
    """Streaming summary: count/sum/min/max (no bucket boundaries to
    configure — reports derive mean; percentiles belong to traces)."""

    __slots__ = ("key", "count", "sum", "min", "max", "_lock")

    def __init__(self, key: str):
        self.key = key
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def summary(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0}
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max,
                    "mean": self.sum / self.count}


class MetricsRegistry:
    """Typed, labelled instruments with one JSON snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        with self._lock:
            c = self._counters.get(k)
            if c is None:
                c = self._counters[k] = Counter(k)
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        with self._lock:
            g = self._gauges.get(k)
            if g is None:
                g = self._gauges[k] = Gauge(k)
            return g

    def histogram(self, name: str, **labels) -> Histogram:
        k = _key(name, labels)
        with self._lock:
            h = self._histograms.get(k)
            if h is None:
                h = self._histograms[k] = Histogram(k)
            return h

    def snapshot(self) -> dict:
        """The shared metrics-snapshot schema (see ``repro_torch.obs``):
        JSON-serialisable, stable key names, round-trips losslessly."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: {"value": g.value, "peak": g.peak}
                      for k, g in self._gauges.items()}
            hists = {k: h.summary() for k, h in self._histograms.items()}
        return {"schema": SCHEMA_VERSION,
                "counters": dict(sorted(counters.items())),
                "gauges": dict(sorted(gauges.items())),
                "histograms": dict(sorted(hists.items()))}

    def reset(self) -> None:
        """Drop every instrument (tests; fresh bench children)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")


REGISTRY = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    return REGISTRY


def snapshot() -> dict:
    return REGISTRY.snapshot()


def read_rss_bytes() -> int:
    """Current resident set in bytes (``/proc`` on Linux, ``ru_maxrss``
    high-water fallback elsewhere)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(ru) * 1024          # kB on Linux


class _RssPoller:
    def __init__(self, registry: MetricsRegistry, interval_s: float):
        self._stop = threading.Event()
        self._gauge = registry.gauge("rss_bytes")
        self._interval = interval_s
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-rss-poller")

    def _run(self) -> None:
        while not self._stop.is_set():
            self._gauge.set(float(read_rss_bytes()))
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._gauge.set(float(read_rss_bytes()))    # final sample


def start_rss_poller(interval_s: float = 0.25,
                     registry: MetricsRegistry | None = None) -> _RssPoller:
    """Start the lightweight RSS sampler; returns a handle with
    ``stop()``.  The gauge's ``peak`` field is the observed high-water."""
    p = _RssPoller(registry or REGISTRY, interval_s)
    p._gauge.set(float(read_rss_bytes()))
    p._thread.start()
    return p
