"""``scratch_io_s``: its reader, the traced run that reports it, and the
trace reduction naming an idle gap by the program's span around it."""
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from rb import cell, spec, trace  # noqa: E402

TINY = {
    "parcels-inmem": {"n": 400, "p": 64, "t": 24, "chunk_rows": 128,
                      "features": {"width": 16}},
    "wholebrain-colblocked": {"n": 300, "p": 64, "t": 48, "chunk_rows": 128,
                              "target_block": 16, "features": {"width": 16}},
}


def _ctx(*streams):
    fits = [types.SimpleNamespace(stream=s) for s in streams]
    return types.SimpleNamespace(fits=fits)


def test_reader_means_the_fits_and_finds_nothing_without_the_key():
    read = spec.reader("scratch_io_s").read
    assert read(_ctx({"scratch_io_s": 1.5})) == 1.5
    assert read(_ctx({"scratch_io_s": 1.0}, {"scratch_io_s": 2.0})) == 1.5
    # A program without the counter (the parent of this metric), or a fit
    # with no stream statistics (in memory): nothing to read.
    assert read(_ctx({"read_stall_s": 0.7})) is None
    assert read(_ctx(None)) is None
    assert read(_ctx({"scratch_io_s": 1.0}, {"read_stall_s": 0.7})) is None
    assert read(_ctx()) is None


@pytest.mark.parametrize("workload", sorted(TINY))
def test_traced_run_reports_it_in_the_store_cell_alone(workload):
    res = cell.run(workload, 2**31 + 17, 0.05, True,
                   t_start=time.perf_counter(), device="cpu",
                   overrides=TINY[workload])
    assert res["correct"], res["checks"]
    if workload == "wholebrain-colblocked":
        m = res["metrics"]["scratch_io_s"]
        assert m["unit"] == "s" and m["value"] > 0
    else:
        assert "scratch_io_s" not in res["metrics"]


def test_idle_gap_is_named_by_the_scratch_span():
    """A whole-brain fit profiled on the CPU as the harness profiles it:
    ``collect`` keeps the program's ``wholebrain.scratch_write`` range as
    a host op, and an idle gap that lies over it (two device activities
    placed at its ends) is labelled by it, for all its length."""
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import EncoderConfig
    from repro_torch.wholebrain import fit_wholebrain

    rng = np.random.default_rng(3)
    X = rng.normal(size=(96, 8)).astype(np.float32)
    Y = rng.normal(size=(96, 24)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        store = RunStore.create(d + "/store", n_folds=3)
        store.write(X[:48], Y[:48], "run-0")
        store.write(X[48:], Y[48:], "run-1")
        store = RunStore.open(d + "/store")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(trace.WINDOW):
                fit_wholebrain(store, EncoderConfig(n_folds=3, chunk_rows=32),
                               t_block=12, device="cpu")
    rec = trace.collect(prof.profiler.kineto_results.events())
    writes = [o for o in rec.ops if o.name == "wholebrain.scratch_write"]
    assert len(writes) == 3                 # the creation, two blocks
    w = max(writes, key=lambda o: o.end - o.start)
    before = trace.Activity(w.start - 10, w.start, 0, "k0", "kernel")
    after = trace.Activity(w.end, w.end + 10, 0, "k1", "kernel")
    summ = trace.summarize(trace.Records(rec.ops, [before, after],
                                         rec.window))
    gaps = dict(summ.idle_gaps)
    assert gaps["host: wholebrain.scratch_write"] == pytest.approx(
        (w.end - w.start) / 1e9)
