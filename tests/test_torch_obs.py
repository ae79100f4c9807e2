"""The port's observability layer (``repro_torch.obs``) against JAX's.

Mirrors ``tests/test_obs.py`` case by case where the case exists in the
port, then holds the port against the reference on the same inputs:

* spans nest, record safely from concurrent threads, export to Perfetto
  and JSONL, and ``launch/obs_report.py`` reads them as the reference's
  report does;
* the span tree of a chunked ``fit(store=)``, of a 4-block
  ``fit_wholebrain`` and of one mixed-trace serve is the reference's: the
  same multiset of (name, depth, parent) and the same attribute keys per
  span name, on the same store directories and bundles;
* the metrics snapshot moves as the reference's after the same runs
  (``compiles{tier}``, ``bytes_staged``, ``chunks_staged``, ``wave_rows``,
  ``wave_pad_rows``, ``admitted_rows``);
* the strict sentinel raises ``RecompileError`` when a fixed-shape update
  sees a new signature inside ``expect(at_most=1)`` — before the update
  runs — and stays silent without ``REPRO_OBS_STRICT``; the armed fit and
  serve paths never raise;
* with no tracer installed the instrumented paths are free (<2% of a
  chunked fit) and never call ``torch.cuda.synchronize``.
"""
import collections
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro import obs as jobs
from repro.encoding import BrainEncoder as JEncoder
from repro.encoding import EncoderConfig as JConfig
from repro.launch import obs_report as jobs_report
from repro.serving_encoders import EncoderRegistry as JRegistry
from repro.serving_encoders import EncoderService as JService
from repro.serving_encoders import FleetFrontend as JFrontend
from repro.serving_encoders import traffic as jtraffic
from repro.wholebrain import fit_wholebrain as jfit_wholebrain
from repro_torch import obs
from repro_torch.core import foldstats
from repro_torch.data.store import RunStore
from repro_torch.device import sync_if_traced
from repro_torch.encoding import BrainEncoder, EncoderConfig
from repro_torch.launch import obs_report
from repro_torch.serving_encoders import (
    EncoderRegistry, EncoderService, FleetFrontend,
)
from repro_torch.serving_encoders import traffic as ttraffic
from repro_torch.wholebrain import fit_wholebrain

# Present only when the reader found the queue full: timing, not structure.
TIMING_ONLY = {"prefetch.compute_stall"}


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts (and ends) with no tracer installed in either
    package."""
    obs.uninstall()
    jobs.uninstall()
    yield
    obs.uninstall()
    jobs.uninstall()


def _problem(seed, n, p, t):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    W = rng.normal(size=(p, t)).astype(np.float32) / np.sqrt(p)
    Y = (X @ W + 0.05 * rng.normal(size=(n, t))).astype(np.float32)
    return X, Y


def _stores(make_run_store, X, Y, n_folds, n_runs=3):
    """One store directory, opened by the reference and by the port."""
    jstore = make_run_store(X, Y, n_runs=n_runs, n_folds=n_folds)
    return jstore, RunStore.open(jstore.root)


def _tree(events):
    """Multiset of (name, depth, parent) and the attribute keys per name."""
    events = [e for e in events if e["name"] not in TIMING_ONLY]
    shape = collections.Counter((e["name"], e["depth"], e["parent"],
                                 bool(e.get("instant"))) for e in events)
    keys = collections.defaultdict(set)
    for e in events:
        keys[e["name"]].add(tuple(sorted(e["attrs"])))
    return shape, dict(keys)


def _traced(mod, fn):
    tracer = mod.install()
    try:
        out = fn()
    finally:
        mod.uninstall()
    return out, tracer.events()


def _counter_deltas(mod, fn, keys):
    before = mod.snapshot()["counters"]
    out = fn()
    after = mod.snapshot()["counters"]
    return out, {k: after.get(k, 0.0) - before.get(k, 0.0) for k in keys}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_nesting_records_parent_depth_attrs():
    tracer = obs.install()
    with obs.span("outer", phase="a"):
        with obs.span("inner") as sp:
            sp.set(bytes=128)
        obs.instant("marker", hit=True)
    obs.uninstall()

    by_name = {e["name"]: e for e in tracer.events()}
    assert set(by_name) == {"outer", "inner", "marker"}
    outer, inner, marker = (by_name[k] for k in ("outer", "inner", "marker"))
    assert outer["depth"] == 0 and outer["parent"] is None
    assert inner["depth"] == 1 and inner["parent"] == "outer"
    assert inner["attrs"] == {"bytes": 128}
    assert outer["attrs"] == {"phase": "a"}
    assert marker["instant"] is True and marker["parent"] == "outer"
    assert outer["ts_us"] <= inner["ts_us"]
    assert inner["ts_us"] + inner["dur_us"] \
        <= outer["ts_us"] + outer["dur_us"] + 1.0


def test_span_disabled_is_shared_noop():
    assert obs.current() is None
    s1 = obs.span("anything", big=1)
    s2 = obs.span("else")
    assert s1 is s2
    with s1 as sp:
        sp.set(x=1)


def test_timed_measures_without_tracer():
    with obs.timed("region") as t:
        time.sleep(0.01)
    assert t.dur_s >= 0.009
    tracer = obs.install()
    with obs.timed("region") as t2:
        pass
    obs.uninstall()
    (ev,) = tracer.events()
    assert ev["name"] == "region"
    assert abs(ev["dur_us"] - t2.dur_s * 1e6) < 1.0


def test_span_thread_safety_distinct_tracks():
    tracer = obs.install()
    n_threads, spans_each = 8, 25
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait()
        for j in range(spans_each):
            with obs.span(f"t{i}", j=j):
                with obs.span(f"t{i}.child"):
                    pass

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    obs.uninstall()

    events = tracer.events()
    assert len(events) == n_threads * spans_each * 2
    assert len({e["track"] for e in events}) == n_threads
    for e in events:
        if e["name"].endswith(".child"):
            assert e["parent"] == e["name"][:-len(".child")]
            assert e["depth"] == 1


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def _sample_tracer(mod=obs):
    tracer = mod.install()
    with mod.span("fit.wholebrain", n=64):
        with mod.span("fit.eigh"):
            pass
        mod.instant("registry.hit", model="m0")
    mod.uninstall()
    return tracer


def test_perfetto_export_required_keys():
    doc = _sample_tracer().to_perfetto()
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert len(doc["traceEvents"]) == 3
    for rec in doc["traceEvents"]:
        for key in ("name", "cat", "ph", "ts", "pid", "tid", "args"):
            assert key in rec, (key, rec)
        if rec["ph"] == "X":
            assert "dur" in rec and rec["dur"] >= 0
        else:
            assert rec["ph"] == "i" and rec["s"] == "t"
    assert {r["cat"] for r in doc["traceEvents"]} == {"fit", "registry"}
    json.dumps(doc)
    # The reference's export of the same spans has the same records.
    jdoc = _sample_tracer(jobs).to_perfetto()
    strip = [{k: v for k, v in r.items() if k not in ("ts", "dur", "pid")}
             for r in doc["traceEvents"]]
    jstrip = [{k: v for k, v in r.items() if k not in ("ts", "dur", "pid")}
              for r in jdoc["traceEvents"]]
    assert strip == jstrip


def test_write_trace_picks_format_by_suffix(tmp_path):
    tracer = _sample_tracer()
    jpath, lpath = str(tmp_path / "t.json"), str(tmp_path / "t.jsonl")
    assert obs.write_trace(tracer, jpath) == "perfetto"
    assert obs.write_trace(tracer, lpath) == "jsonl"
    assert "traceEvents" in json.load(open(jpath))
    lines = [json.loads(ln) for ln in open(lpath)]
    assert [e["name"] for e in lines] == [e["name"] for e in tracer.events()]


def test_obs_report_coverage_and_render(tmp_path):
    tracer = obs.install()
    with obs.span("root"):
        with obs.span("a"):
            time.sleep(0.02)
        with obs.span("b"):
            time.sleep(0.02)
    obs.uninstall()
    path = str(tmp_path / "trace.jsonl")
    tracer.write_jsonl(path)

    events = obs_report.load_events(path)
    root, cov = obs_report.root_coverage(events)
    assert root["name"] == "root"
    assert cov > 0.9
    out = obs_report.render(events)
    assert "root" in out and "%wall" in out
    # The reference's report reads the port's trace to the same numbers.
    jevents = jobs_report.load_events(path)
    assert jevents == events
    assert jobs_report.root_coverage(jevents) == (root, cov)
    assert jobs_report.render(jevents) == out
    assert jobs_report.summarize(jevents) == obs_report.summarize(events)


def test_obs_report_cli_gates_coverage(tmp_path, monkeypatch, capsys):
    tracer = obs.install()
    with obs.span("root"):
        with obs.span("a"):
            time.sleep(0.01)
        time.sleep(0.03)                   # unattributed: ~25% coverage
    obs.uninstall()
    path = str(tmp_path / "trace.jsonl")
    obs.write_trace(tracer, path)
    monkeypatch.setattr("sys.argv", ["obs_report", path,
                                     "--assert-coverage", "0.1"])
    obs_report.main()
    assert "coverage" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["obs_report", path,
                                     "--assert-coverage", "0.95"])
    with pytest.raises(SystemExit, match="coverage assertion failed"):
        obs_report.main()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_snapshot_json_roundtrip(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("compiles", tier="foldstats.chunk_update").inc()
    reg.counter("compiles", tier="foldstats.chunk_update").inc(2)
    reg.counter("bytes_staged").inc(4096)
    reg.gauge("rss_bytes").set(100.0)
    reg.gauge("rss_bytes").set(50.0)
    for v in (1.0, 3.0, 2.0):
        reg.histogram("flush_ms").observe(v)

    snap = reg.snapshot()
    assert snap["schema"] == obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert snap["counters"]["compiles{tier=foldstats.chunk_update}"] == 3.0
    assert snap["gauges"]["rss_bytes"] == {"value": 50.0, "peak": 100.0}
    hist = snap["histograms"]["flush_ms"]
    assert hist["count"] == 3 and hist["min"] == 1.0 and hist["max"] == 3.0
    assert hist["mean"] == pytest.approx(2.0)

    path = str(tmp_path / "metrics.json")
    reg.write_json(path)
    assert json.load(open(path)) == json.loads(json.dumps(snap))
    reg.reset()
    assert reg.snapshot()["counters"] == {}


def test_same_instrument_same_object():
    reg = obs.MetricsRegistry()
    assert reg.counter("x", a=1, b=2) is reg.counter("x", b=2, a=1)
    assert reg.counter("x") is not reg.counter("y")


def test_rss_poller_records_peak():
    reg = obs.MetricsRegistry()
    poller = obs.start_rss_poller(interval_s=0.01, registry=reg)
    time.sleep(0.03)
    poller.stop()
    g = reg.snapshot()["gauges"]["rss_bytes"]
    assert g["peak"] >= g["value"] > 0
    assert obs.read_rss_bytes() > 0


# ---------------------------------------------------------------------------
# recompile sentinel
# ---------------------------------------------------------------------------

def _chunked_stats(X, Y, chunk_rows):
    """Feed the fixed-shape chunk update directly (``compute_chunked``
    would open its own window, which shadows the caller's)."""
    acc = foldstats.FoldStatsAccumulator(X.shape[0], 3, chunk_rows=chunk_rows,
                                         device="cpu")
    for i in range(0, X.shape[0], chunk_rows):
        acc.update(X[i:i + chunk_rows], Y[i:i + chunk_rows])
    return acc.finalize()


def test_sentinel_fires_on_shape_changing_update(monkeypatch):
    """A fixed-shape tier that sees a second signature inside
    ``expect(at_most=1)`` raises at that update, before it runs."""
    X, Y = _problem(0, 60, 5, 3)
    ctr = foldstats.chunk_update_compiles()
    seen = foldstats._FIXED_UPDATE._seen
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    c0 = ctr.count
    with ctr.expect(at_most=1):
        _chunked_stats(X, Y, 11)              # fresh signature: allowed
        _chunked_stats(X, Y, 11)              # known: no mark
        with pytest.raises(obs.RecompileError):
            _chunked_stats(X, Y, 13)          # a second new shape → raises
    assert ctr.count == c0 + 2
    # The raising update never ran: its signature was not recorded.
    assert not any(sig[0] == 13 and sig[1] == 5 for sig in seen)
    assert foldstats.chunk_update_compile_count() == ctr.count


def test_sentinel_silent_without_strict(monkeypatch):
    X, Y = _problem(1, 60, 6, 3)
    ctr = foldstats.chunk_update_compiles()
    monkeypatch.delenv("REPRO_OBS_STRICT", raising=False)
    c0 = ctr.count
    m0 = obs.snapshot()["counters"].get(
        "compiles{tier=foldstats.chunk_update}", 0.0)
    with ctr.expect(at_most=1):
        _chunked_stats(X, Y, 17)
        _chunked_stats(X, Y, 19)              # over the window: counted only
    assert ctr.count == c0 + 2
    assert obs.snapshot()["counters"][
        "compiles{tier=foldstats.chunk_update}"] == m0 + 2


def test_sentinel_windows_nest(monkeypatch):
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    ctr = obs.CompileCounter("test.nested")
    with ctr.expect(at_most=5):
        with ctr.expect(at_most=0):
            with pytest.raises(obs.RecompileError):
                ctr.mark()
        ctr.mark()
    assert ctr.count == 2


def test_service_expect_shape_sentinel(monkeypatch):
    """A wave shape key seen before may fly no new signature: one the key
    did not predict (another weight dtype) raises under strict mode."""
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    svc = EncoderService(EncoderRegistry(device="cpu"))
    key = ("mixed", 8, 4, 3, 2)
    with svc._expect_shape(key):
        svc._flown(key + (torch.float32,))
    with svc._expect_shape(key):
        svc._flown(key + (torch.float32,))    # repeat: no mark
        with pytest.raises(obs.RecompileError):
            svc._flown(key + (torch.bfloat16,))
    assert svc.compile_count == 2


# ---------------------------------------------------------------------------
# span trees and metrics against the reference
# ---------------------------------------------------------------------------

def test_chunked_fit_span_tree_and_metrics_match_reference(make_run_store,
                                                           monkeypatch):
    X, Y = _problem(2, 221, 9, 5)
    jstore, store = _stores(make_run_store, X, Y, n_folds=3)
    kw = dict(n_folds=3, device_memory_budget=1, chunk_rows=23)
    keys = ("compiles{tier=foldstats.chunk_update}", "bytes_staged",
            "chunks_staged")
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")     # armed: must not raise
    (jenc, jev), jd = _counter_deltas(jobs, lambda: _traced(
        jobs, lambda: JEncoder(**kw).fit(store=jstore)), keys)
    (tenc, tev), td = _counter_deltas(obs, lambda: _traced(
        obs, lambda: BrainEncoder(EncoderConfig(**kw),
                                  device="cpu").fit(store=store)), keys)
    assert tenc.report_.decision.method == "chunked"
    assert _tree(tev) == _tree(jev)
    assert td == jd
    assert td[keys[0]] == 1 and td["chunks_staged"] == 10
    assert td["bytes_staged"] == tenc.stream_stats_["bytes_staged"]
    names = {e["name"] for e in tev}
    assert {"fit", "fit.dispatch", "fit.stats", "fit.foldstats.shard",
            "fit.finalize", "fit.eigh", "fit.solve", "prefetch.stage",
            "prefetch.wait", "prefetch.yield"} <= names
    # PrefetchStats is derived from the spans' own measurements.
    waits = sum(e["dur_us"] for e in tev if e["name"] == "prefetch.wait")
    assert tenc.stream_stats_["read_stall_s"] == pytest.approx(
        waits / 1e6, abs=1e-5)
    root, _ = obs_report.root_coverage(tev)
    assert root["name"] == "fit"


def test_fit_chunks_span_tree_matches_reference():
    X, Y = _problem(3, 150, 7, 4)
    chunks = [(X[i:i + 29], Y[i:i + 29]) for i in range(0, 150, 29)]
    jenc, jev = _traced(jobs, lambda: JEncoder(n_folds=3).fit_chunks(
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in chunks], 150))
    tenc, tev = _traced(obs, lambda: BrainEncoder(
        n_folds=3, device="cpu").fit_chunks(chunks, 150))
    assert _tree(tev) == _tree(jev)
    assert sum(e["name"] == "fit.foldstats.chunk_update" for e in tev) == 6


def test_in_memory_fit_span_tree_matches_reference():
    X, Y = _problem(4, 80, 6, 4)
    _, jev = _traced(jobs, lambda: JEncoder(n_folds=3).fit(
        jnp.asarray(X), jnp.asarray(Y)))
    _, tev = _traced(obs, lambda: BrainEncoder(n_folds=3, device="cpu").fit(
        X, Y))
    assert _tree(tev) == _tree(jev)


@pytest.mark.parametrize("lambda_mode", ["global", "per_block"])
def test_wholebrain_span_tree_and_metrics_match_reference(
        make_run_store, monkeypatch, lambda_mode):
    X, Y = _problem(5, 96, 8, 40)
    jstore, store = _stores(make_run_store, X, Y, n_folds=3)
    cfg = dict(n_folds=3, chunk_rows=31, use_pallas=False)
    keys = ("compiles{tier=wholebrain.colblock_update}", "bytes_staged",
            "chunks_staged")
    monkeypatch.setenv("REPRO_OBS_STRICT", "1")
    (jres, jev), jd = _counter_deltas(jobs, lambda: _traced(
        jobs, lambda: jfit_wholebrain(jstore, JConfig(**cfg), t_block=12,
                                      lambda_mode=lambda_mode)), keys)
    (tres, tev), td = _counter_deltas(obs, lambda: _traced(
        obs, lambda: fit_wholebrain(store, EncoderConfig(**cfg), t_block=12,
                                    lambda_mode=lambda_mode,
                                    device="cpu")), keys)
    assert tres.telemetry["n_blocks"] == 4
    assert _tree(tev) == _tree(jev)
    # The first mode run in this process sees the fresh signature.
    assert td[keys[0]] == jd[keys[0]] <= 1
    assert td["bytes_staged"] == jd["bytes_staged"] \
        == tres.telemetry["bytes_staged"]
    assert td["chunks_staged"] == jd["chunks_staged"]
    blocks = [e for e in tev if e["name"] == "wholebrain.block"]
    assert [e["attrs"]["block"] for e in blocks] == [0, 1, 2, 3]
    assert all(e["parent"] == "fit.wholebrain" for e in blocks)
    root, cov = obs_report.root_coverage(tev)
    assert root["name"] == "fit.wholebrain" and cov > 0.5


@pytest.fixture(scope="module")
def tiny_fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_fleet")
    return jtraffic.build_synthetic_fleet(str(root), 2, n=64, p=16, t=24)


def test_serve_span_tree_and_metrics_match_reference(tiny_fleet,
                                                     monkeypatch):
    spec = ttraffic.make_mixed_trace(3, n_models=2, n_requests=12, p=16,
                                     t=24, wave_rows=16)
    assert spec.digest() == jtraffic.make_mixed_trace(
        3, n_models=2, n_requests=12, p=16, t=24, wave_rows=16).digest()
    names = [name for name, _ in tiny_fleet]
    keys = ("wave_rows", "wave_pad_rows", "admitted_rows", "registry_loads",
            "registry_hits")
    keys += tuple(f"waves{{bucket={b}}}" for b in (8, 32))
    keys += tuple(f"tenant_rows{{tenant=tenant-{i:02d}}}" for i in range(4))
    keys += ("compiles{tier=service.predict}",)

    def serve(reg_cls, svc_cls, fe_cls, requests, **reg_kw):
        reg = reg_cls(**reg_kw)
        for name, path in tiny_fleet:
            reg.add(name, path)
        svc = svc_cls(reg, wave_buckets=(8, 32))
        fe = fe_cls(svc, max_pending_rows=10**6)
        for r in requests:
            fe.submit(r)
        return fe.flush(), svc

    monkeypatch.setenv("REPRO_OBS_STRICT", "1")     # _expect_shape armed
    (jout, jev), jd = _counter_deltas(jobs, lambda: _traced(
        jobs, lambda: serve(JRegistry, JService, JFrontend,
                            jtraffic.replay_requests(spec, names))), keys)
    (tout, tev), td = _counter_deltas(obs, lambda: _traced(
        obs, lambda: serve(EncoderRegistry, EncoderService, FleetFrontend,
                           ttraffic.replay_requests(spec, names),
                           device="cpu")), keys)
    assert _tree(tev) == _tree(jev)
    assert td == jd
    svc = tout[1]
    st = svc.stats
    assert td["wave_rows"] == sum(b["rows"] for b in st.per_bucket.values())
    assert td["wave_pad_rows"] == st.pad_rows
    assert sum(td[f"waves{{bucket={b}}}"] for b in (8, 32)) == st.waves
    assert td["admitted_rows"] == st.rows == sum(e.rows
                                                 for e in spec.entries)
    assert td["compiles{tier=service.predict}"] == svc.compile_count
    assert {"fleet.flush", "serve.wave.build", "serve.wave.execute",
            "registry.load", "fleet.admit"} <= {e["name"] for e in tev}
    for jr, tr in zip(jout[0], tout[0]):
        np.testing.assert_allclose(tr.predictions, np.asarray(jr.predictions),
                                   rtol=1e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# disabled-path cost and synchronisation
# ---------------------------------------------------------------------------

def test_disabled_tracer_overhead_under_2pct(make_run_store):
    """The spans a chunked fit emits must cost <2% of its wall when no
    tracer is installed: (per-span disabled cost) × (spans an instrumented
    run records) against the fit's own wall time."""
    rng = np.random.default_rng(0)
    n, p, t = 4096, 32, 16
    X = rng.normal(size=(n, p)).astype(np.float32)
    Y = rng.normal(size=(n, t)).astype(np.float32)
    store = RunStore.open(make_run_store(X, Y, n_runs=4).root)

    def fit():
        return BrainEncoder(n_folds=5, device_memory_budget=1,
                            chunk_rows=512, device="cpu").fit(store=store)

    fit()
    assert obs.current() is None
    t0 = time.perf_counter()
    fit()
    fit_wall = time.perf_counter() - t0

    tracer = obs.install()
    fit()
    obs.uninstall()
    n_spans = len(tracer.events())
    assert n_spans > 0

    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps * n_spans):
        with obs.span("fit.stats", bytes=1024):
            pass
    disabled_cost = (time.perf_counter() - t0) / reps
    overhead = disabled_cost / fit_wall
    assert overhead < 0.02, (
        f"disabled spans cost {overhead:.2%} of the chunked fit wall "
        f"({n_spans} spans, {disabled_cost * 1e6:.1f} µs/run vs "
        f"{fit_wall * 1e3:.1f} ms fit)")


def test_untraced_paths_never_synchronize(make_run_store, tiny_fleet,
                                          monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    # The one forcing point waits only while a tracer is installed.
    sync_if_traced(torch.device("cuda"))
    assert calls == []
    obs.install()
    sync_if_traced(torch.device("cuda"))
    sync_if_traced(torch.device("cpu"))
    obs.uninstall()
    assert calls == [torch.device("cuda")]
    calls.clear()

    X, Y = _problem(6, 96, 8, 40)
    store = RunStore.open(make_run_store(X, Y, n_runs=2, n_folds=3).root)
    BrainEncoder(n_folds=3, device_memory_budget=1, chunk_rows=32,
                 device="cpu").fit(store=store)
    BrainEncoder(n_folds=3, device="cpu").fit(X, Y)
    fit_wholebrain(store, EncoderConfig(n_folds=3, chunk_rows=32),
                   t_block=12, device="cpu")
    reg = EncoderRegistry(device="cpu")
    for name, path in tiny_fleet:
        reg.add(name, path)
    spec = ttraffic.make_mixed_trace(4, n_models=2, n_requests=6, p=16,
                                     t=24, wave_rows=16)
    EncoderService(reg, wave_buckets=(8, 32)).serve(
        ttraffic.replay_requests(spec, [n for n, _ in tiny_fleet]))
    assert calls == []


@pytest.mark.cuda
def test_cuda_traced_fit_synchronizes_only_at_eigh_and_solve(tmp_path,
                                                             monkeypatch):
    """On the card a traced streamed fit forces completion at exactly the
    ``fit.eigh`` and ``fit.solve`` spans; untraced it forces nothing, and
    both fits give the same bits.  (The store is the port's: the card's
    host cannot open the reference's.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the synchronise points are CUDA's")
    X, Y = _problem(7, 2048, 64, 32)
    writer = RunStore.create(str(tmp_path / "store"), n_folds=5)
    writer.write(X[:1024], Y[:1024], "run-0")
    writer.write(X[1024:], Y[1024:], "run-1")
    store = RunStore.open(str(tmp_path / "store"))
    real = torch.cuda.synchronize
    calls = []

    def counting(device=None):
        calls.append(device)
        real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", counting)

    def fit():
        return BrainEncoder(n_folds=5, device_memory_budget=1,
                            chunk_rows=256).fit(store=store)

    plain = fit()
    assert calls == []
    traced, events = _traced(obs, fit)
    assert len(calls) == 2
    root, cov = obs_report.root_coverage(events)
    assert root["name"] == "fit" and cov >= 0.95
    assert torch.equal(plain.weights_, traced.weights_)
