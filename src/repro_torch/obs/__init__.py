"""repro_torch.obs — the unified observability layer (tracing, metrics, sentinels).

Port of ``repro/obs``: the same spans, instruments, snapshot schema and
strict-mode variable, so a trace or snapshot from either package reads
the same.

Disabled by default (stdlib, plus torch's profiler hooks in the spans),
and shared by every tier: the fit path (``BrainEncoder``/``foldstats``),
the streaming tier (``ChunkPrefetcher``), the whole-brain column-blocked
driver, and the serving fleet
(``EncoderService``/``EncoderRegistry``/``FleetFrontend``) all emit through the SAME three primitives instead of bespoke stat dicts:

* **Spans** — ``with obs.span("fit.stats", bytes=n): ...`` nests, is
  thread-safe, stamps a monotonic clock, and exports to JSONL or
  Chrome/Perfetto ``trace_event`` JSON (``obs.write_trace``).  With no
  tracer installed the call returns a shared no-op after one module
  attribute load — hot paths stay permanently instrumented.
  ``obs.timed`` additionally ALWAYS measures (the streaming tier derives
  ``PrefetchStats`` stall seconds from the same measurement the span
  records).  ``obs.instant`` records zero-duration markers
  (admit/reject/hit).  While ``torch.profiler`` runs, ``span`` and
  ``timed`` also open a profiler range of the span's name, tracer or
  not (below).
* **Metrics** — ``obs.get_metrics()`` returns the process-global
  :class:`~repro_torch.obs.metrics.MetricsRegistry`; ``obs.snapshot()`` renders
  every counter/gauge/histogram into one JSON dict (schema below) whose
  schema marker ``stream_stats_``, ``ServiceStats.to_dict`` and
  ``PrefetchStats.to_dict`` carry too.
* **Compile sentinels** — :class:`~repro_torch.obs.sentinel.CompileCounter` is
  the one signature counter behind
  ``foldstats.chunk_update_compile_count``,
  ``wholebrain.colblock_update_compile_count`` and
  ``EncoderService.compile_count``; ``counter.expect(at_most=N)`` windows
  raise :class:`~repro_torch.obs.sentinel.RecompileError` at the violating
  call under ``REPRO_OBS_STRICT=1`` when a fixed-shape tier sees a new
  signature.

Span naming convention: dotted ``<tier>.<phase>[.<subphase>]`` —
``fit.dispatch`` / ``fit.stats`` / ``fit.eigh`` / ``fit.solve``,
``prefetch.stage`` / ``prefetch.wait`` / ``prefetch.compute_stall``,
``wholebrain.block`` / ``wholebrain.xstats``, ``serve.wave.build`` /
``serve.wave.execute``, ``registry.load`` / ``registry.evict`` /
``registry.hit``, ``fleet.admit`` / ``fleet.reject`` / ``fleet.flush``.
The port adds leaf spans that name the work between kernels, each under
a span the reference has: the in-memory primal fit's
``fit.primal.stats`` / ``fit.primal.eigh`` (each fold's and the refit's)
/ ``fit.primal.score`` / ``fit.primal.solve``, and the whole-brain
fit's ``wholebrain.score`` / ``wholebrain.project`` /
``wholebrain.weights_emit`` (the host weight matrix or the writer) and
``wholebrain.scratch_write`` / ``_flush`` / ``_read`` / ``_free`` (the
global-mode ``Â`` scratch memmap).  A leaf names the time under it; a
span with children names only the time none of them covers.

Metrics-snapshot schema (``obs.snapshot()``; version ``repro.obs/v1``)
----------------------------------------------------------------------

====================================  =========  ==========================================
key                                   type       meaning
====================================  =========  ==========================================
``schema``                            str        ``"repro.obs/v1"``
``counters``                          dict       flat ``name{label=v,...} -> float``
``gauges``                            dict       ``key -> {"value", "peak"}``
``histograms``                        dict       ``key -> {"count","sum","min","max","mean"}``
====================================  =========  ==========================================

Well-known instruments (all optional — present once the producing tier ran):

====================================  =========  ==========================================
instrument                            type       producer
====================================  =========  ==========================================
``compiles{tier=...}``                counter    every ``CompileCounter.mark`` (tiers:
                                                 ``foldstats.chunk_update``,
                                                 ``wholebrain.colblock_update``,
                                                 ``wholebrain.gram``, ``service.predict``)
``bytes_staged``                      counter    prefetcher staging copies (bytes)
``chunks_staged``                     counter    prefetcher chunks staged
``read_stall_s`` / ``compute_stall_s``  counter  prefetcher stall seconds (consumer /
                                                 producer side)
``wave_pad_rows`` / ``wave_rows``     counter    serving pad vs real rows per wave
``waves``                             counter    compiled predict waves executed
``tenant_rows{tenant=...}``           counter    per-tenant served rows
``registry_hits`` / ``registry_loads``  counter  bundle cache hits / cold loads
``registry_evictions``                counter    LRU + fault evictions
``admitted_rows`` / ``rejected_requests``  counter  fleet admission outcomes
``io_retries{op=...}``                counter    transient faults retried by
                                                 ``resilience.retry_call`` (ops:
                                                 ``store.mmap``, ``prefetch.read``,
                                                 ``registry.load_encoder`` /
                                                 ``load_shard`` / ``load_std``)
``io_giveups{op=...}``                counter    retry budget exhausted — the original
                                                 error re-raised (typed at the caller)
``staging_reaped``                    counter    stale staging orphans swept by
                                                 ``resilience.reap_stale_staging``
``lease_expirations``                 counter    dead-worker leases reaped by
                                                 ``ResidencyMap.expire_dead``
``requests_replayed``                 counter    requests re-admitted after a
                                                 ``WorkerLost`` flush
``rss_bytes``                         gauge      resident set (background poller;
                                                 ``peak`` = observed high-water)
``scratch_io_s``                      telemetry  host seconds of one whole-brain fit's
                                                 ``wholebrain.scratch_*`` spans
                                                 (``WholebrainResult.telemetry`` and
                                                 ``stream_stats_``; 0.0 per block)
====================================  =========  ==========================================

Stats ``to_dict()`` payloads (``PrefetchStats``, ``ServiceStats``, and the
``stream_stats_`` dict) carry ``{"schema": "repro.obs/v1", "kind": ...}``
plus their flat snake_case fields — benches consume those dicts, never
raw attributes.

Surfacing: ``launch/obs_report.py`` renders a per-phase time/bytes table
from a JSONL trace and can gate span coverage (``--assert-coverage``)::

    tracer = obs.install()
    ...                                   # a fit, a serve
    obs.write_trace(tracer, "trace.jsonl")
    obs.uninstall()
    # python -m repro_torch.launch.obs_report trace.jsonl --assert-coverage 0.95

**Spans around CUDA work.**  A span closes on the host clock, and PyTorch
returns before the card finishes, so a span measures the enqueue unless
the code forces completion.  As in the reference, exactly the
``fit.eigh``/``fit.solve`` spans of ``core/ridge.py`` and the whole-brain
solver and ``fit.foldstats.chunk_update`` call ``torch.cuda.synchronize``,
and with them the port's ``fit.primal.stats`` / ``.eigh`` / ``.score`` /
``.solve``, and only while a tracer is installed
(``device.sync_if_traced``); an untraced run gains no synchronise.  So
the in-memory ``fit.solve`` of ``BrainEncoder.fit`` ends with its last
synced leaf on the primal path.  ``wholebrain.score`` and
``wholebrain.project`` end with their own host reads of the card's
results; the ``wholebrain.scratch_*`` spans and
``wholebrain.weights_emit`` are host work.  An unscored
``serve.wave.execute`` span reads enqueue time.

**Spans on the profiler's timeline.**  While ``torch.profiler`` runs,
every ``span``/``timed`` region also opens a profiler range of the same
name (nested as the spans nest, closed on exit, exceptions included),
with or without a tracer installed, so a device trace names the host
work in each idle gap by the innermost span around it.  The range adds
no synchronise: a fit under the profiler alone keeps its untraced
timeline.  The profiler records ranges of the thread that started it
only, so the prefetcher thread's ``prefetch.stage`` does not reach its
trace (the fit thread's ``prefetch.wait`` does).  With the profiler off
the cost is one flag check and no allocation.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    REGISTRY, SCHEMA_VERSION, Counter, Gauge, Histogram, MetricsRegistry,
    get_metrics, read_rss_bytes, snapshot, start_rss_poller,
)
from repro_torch.obs.sentinel import (  # noqa: F401
    CompileCounter, RecompileError, strict_enabled,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer, current, install, instant, span, timed, uninstall, write_trace,
)

__all__ = [
    "Tracer", "span", "timed", "instant", "install", "uninstall", "current",
    "write_trace",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "REGISTRY",
    "get_metrics", "snapshot", "start_rss_poller", "read_rss_bytes",
    "SCHEMA_VERSION",
    "CompileCounter", "RecompileError", "strict_enabled",
]
