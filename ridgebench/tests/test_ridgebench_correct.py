"""The comparison that decides ``correct``, driven through a whole run on
the CPU at a tiny size: the program's CPU path passes, its control and
each fault the cells can have fail, the harness loads neither JAX nor
the JAX package, and the trace reduction sorts device time into layers."""
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from rb import cell, correct, trace  # noqa: E402

TINY = {
    "parcels-inmem": {"n": 400, "p": 64, "t": 24, "chunk_rows": 128,
                      "features": {"width": 16}},
    "wholebrain-colblocked": {"n": 300, "p": 64, "t": 48, "chunk_rows": 128,
                              "target_block": 16, "features": {"width": 16}},
}
CELLS = sorted(TINY)


def _run(workload, seed=11):
    return cell.run(workload, seed, 0.05, False, t_start=time.perf_counter(),
                    device="cpu", overrides=TINY[workload])


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"ridgebench_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_the_ports_cpu_path(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    kind = "inmem" if workload == "parcels-inmem" else "store"
    assert set(res["metrics"]) == {f"fit_s.{kind}", "peak_mem_gib",
                                   "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_on_the_cpu(workload):
    """A traced run profiles its first fit; on the CPU no device
    activity is found, so the device readers return nothing."""
    res = cell.run(workload, 13, 0.05, True, t_start=time.perf_counter(),
                   device="cpu", overrides=TINY[workload])
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not any(m.startswith("fit_s") for m in res["metrics"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_separates(workload):
    """The reference with its products in TF32 (emulated on the CPU) in
    the program's place reads each number at least ten times the
    program's.  At this size both lie below the cell's limits, which
    are set from readings at the cell's own size on the card (the
    ``cuda`` test below)."""
    ctl = _load("control")
    limits = cell.spec.cell(workload)["limits"]
    for r in ctl.readings(workload, [5, 6], device="cpu",
                          overrides=TINY[workload]):
        assert correct.judge(r["program"], limits)[0], r
        for name, value in r["program"].items():
            assert r["control"][name] >= 10 * value, (name, r)


def _half_rows(monkeypatch):
    from repro_torch.kernels import ref
    folds, masked = ref.xty_folds, ref.xty_folds_masked

    def half_folds(x, y, bounds):
        return torch.stack([2 * ref.xty(x[lo:hi:2], y[lo:hi:2])
                            for lo, hi in bounds])

    def half_masked(x, z, w):
        w = w.clone()
        w[1::2] = 0
        return masked(x, z, 2 * w)
    monkeypatch.setattr(ref, "xty_folds", half_folds)
    monkeypatch.setattr(ref, "xty_folds_masked", half_masked)
    return folds


def _unchanged(monkeypatch):
    from repro_torch.kernels import ref

    def zeros_folds(x, y, bounds):
        return torch.zeros(len(bounds), x.shape[1], y.shape[1])

    def zeros_masked(x, z, w):
        return torch.zeros(w.shape[1], x.shape[1], z.shape[1])
    monkeypatch.setattr(ref, "xty_folds", zeros_folds)
    monkeypatch.setattr(ref, "xty_folds_masked", zeros_masked)


def _altered(monkeypatch):
    from repro_torch.core import ridge
    from repro_torch.wholebrain import solver

    def alter(fn):
        def inner(*a, **k):
            W = fn(*a, **k).clone()
            W[0, 0] += 0.1 * W.abs().max()
            return W
        return inner
    monkeypatch.setattr(ridge, "solve", alter(ridge.solve))
    monkeypatch.setattr(solver, "_solve_projected",
                        alter(solver._solve_projected))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_half_rows, _unchanged, _altered],
                         ids=["half_rows", "state_unchanged",
                              "answer_altered"])
def test_faults_fail(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]


def test_harness_loads_no_jax():
    code = (
        "import sys, time, importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('rb_run', "
        f"{str(BENCH / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "from rb import cell\n"
        "for w, o in " + json.dumps(TINY) + ".items():\n"
        "    cell.run(w, 3, 0.01, False, t_start=time.perf_counter(),\n"
        "             device='cpu', overrides=o)\n"
        "print(run.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "ridgebench/run.py", "--workload", "parcels-inmem",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_trace_layers_and_gaps():
    ops = [trace.Op(0, 100, 1, 1, trace.WINDOW),
           trace.Op(10, 40, 1, 2, "aten::linalg_eigh"),
           trace.Op(11, 39, 1, 3, "aten::_linalg_eigh"),
           trace.Op(50, 60, 1, 4, "aten::matmul"),
           trace.Op(51, 59, 1, 5, "aten::mm"),
           trace.Op(70, 80, 1, 6, "aten::add")]
    acts = [trace.Activity(12, 20, 3, "syevd_kernel", "kernel"),
            trace.Activity(30, 38, 3, "ormtr_kernel", "kernel"),
            trace.Activity(52, 58, 5, "sgemm", "kernel"),
            trace.Activity(61, 66, 0, "void product_kernel<2, 2, 192>",
                           "kernel"),
            trace.Activity(71, 75, 6, "add_kernel", "kernel"),
            trace.Activity(76, 79, 0, "Memcpy HtoD", "copy")]
    s = trace.summarize(trace.Records(trace.nest(ops), acts, (0, 100)))
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(34e-9)
    assert s.layers == pytest.approx({
        "factorisation": 16e-9, "products": 6e-9, "fold statistics": 5e-9,
        "elementwise": 4e-9, "copies": 3e-9})
    gaps = dict(s.idle_gaps)
    # The gap 20-30 lies inside _linalg_eigh: cuSOLVER's host step.
    assert gaps["host: eigh host step"] == pytest.approx(10e-9)
    assert sum(gaps.values()) == pytest.approx(66e-9)


def test_trace_collect_reads_a_profiler_trace():
    """The profiler's raw events on the CPU: host ops nested under the
    window, no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function
    a = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU], acc_events=False) as p:
        with record_function(trace.WINDOW):
            torch.linalg.eigh(a @ a.T + 32 * torch.eye(32))
    rec = trace.collect(p.profiler.kineto_results.events())
    names = {o.name for o in rec.ops}
    assert {"aten::linalg_eigh", "aten::matmul"} <= names
    assert rec.window[1] > rec.window[0] and not rec.activities
    assert any(o.eigh and o.name != "aten::linalg_eigh" for o in rec.ops)
    assert trace.summarize(rec).busy_s == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card_at_the_cells_size(workload):
    """The control at the cell's own size on the card (minutes): the
    program passes the cell's limits and the TF32 control fails them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctl = _load("control")
    limits = cell.spec.cell(workload)["limits"]
    for r in ctl.readings(workload, [21]):
        assert correct.judge(r["program"], limits)[0], r
        assert not correct.judge(r["control"], limits)[0], r
