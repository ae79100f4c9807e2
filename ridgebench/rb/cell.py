"""Run one cell once: set-up, the measured window, the reference.

Set-up makes the inputs on the device from the seed (``data``), writes
the run store for a store-fed traffic mix (runs of ``run_rows`` rows,
under ``TMPDIR``), and warms up with one whole fit of the cell's own
inputs: the kernel library (built into ``build/kernels/`` inside the
checkout by its first run), cuBLAS and cuSOLVER handles and workspaces,
the caching allocator's blocks and the pinned staging buffers at the
cell's sizes.  The window then runs whole fits back to back,
``BrainEncoder(cfg).fit(...)`` each, until ``seconds`` have passed, and
finishes and counts the fit in progress.  A traced run profiles the
window's first fit (a fit is a few hundred thousand to two million
device activities); its per-layer metrics are of that fit.

After the window closes and the device's peak is read, the program's
state is freed and the plain reference (``reference``) fits the same
inputs; ``correct`` compares the two (``correct``).  Every fit must also
take the plan and make the kernel launches the cell file states.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

from rb import correct as correct_mod
from rb import data, reference, spec, trace as trace_mod

GIB = float(1 << 30)


def log(msg: str) -> None:
    print(f"[ridgebench] {msg}", file=sys.stderr, flush=True)


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def encoder_config(cfg: dict):
    from repro_torch.encoding import EncoderConfig
    return EncoderConfig(
        lambdas=tuple(float(l) for l in cfg["lambdas"]),
        n_folds=cfg["n_folds"], jitter=cfg["jitter"],
        scoring=cfg["scoring"], target_block=cfg.get("target_block"),
        device_memory_budget=cfg.get("device_memory_budget"),
        chunk_rows=cfg["chunk_rows"])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _checksum(*ts: torch.Tensor) -> float:
    return float(sum(t.sum(dtype=torch.float64) for t in ts))


def _flush(root: str) -> None:
    """Write a directory's files to the disk now, in set-up, so that the
    window does not pay for their write-back."""
    for name in os.listdir(root):
        fd = os.open(os.path.join(root, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


class _Inputs:
    """What one fit is called on: resident arrays or a run store."""

    def __init__(self, cfg: dict, traffic: dict, X: torch.Tensor,
                 Y: torch.Tensor):
        self.kind = traffic["input"]
        self.root = None
        self.host = None
        if self.kind == "memory":
            self.X, self.Y = X, Y
        elif self.kind == "store":
            from repro_torch.data.store import RunStore
            self.host = (X.cpu().numpy(), Y.cpu().numpy())
            self.root = tempfile.mkdtemp(prefix="ridgebench_store_")
            store = RunStore.create(os.path.join(self.root, "store"),
                                    n_folds=cfg["n_folds"])
            rows = traffic["run_rows"]
            Xh, Yh = self.host
            for i, lo in enumerate(range(0, Xh.shape[0], rows)):
                store.write(Xh[lo:lo + rows], Yh[lo:lo + rows],
                            f"run-{i:05d}")
            _flush(os.path.join(self.root, "store"))
            self.store = RunStore.open(os.path.join(self.root, "store"))
        else:
            raise ValueError(f"unknown input {self.kind!r}")

    def fit(self, enc):
        if self.kind == "memory":
            return enc.fit(self.X, self.Y)
        return enc.fit(store=self.store)

    def arrays(self, dev) -> tuple[torch.Tensor, torch.Tensor]:
        """The inputs the reference reads: the resident arrays, or the
        host copies of what was written to the store."""
        if self.kind == "memory":
            return self.X, self.Y
        return (torch.from_numpy(self.host[0]).to(dev),
                torch.from_numpy(self.host[1]).to(dev))

    def close(self) -> None:
        if self.root is not None:
            shutil.rmtree(self.root, ignore_errors=True)


@dataclasses.dataclass
class FitRecord:
    seconds: float
    lam: float
    cv: np.ndarray
    plan: str
    launches: dict
    stream: dict | None


def _launches() -> dict:
    from repro_torch.kernels import gram
    return dict(gram.LAUNCHES)


def _one_fit(inputs: _Inputs, enc_cfg, dev) -> tuple[object, FitRecord]:
    from repro_torch.encoding import BrainEncoder
    before = _launches()
    t0 = time.perf_counter()
    enc = inputs.fit(BrainEncoder(enc_cfg, device=dev))
    _sync(dev)
    sec = time.perf_counter() - t0
    after = _launches()
    rep = enc.report_
    rec = FitRecord(
        seconds=sec, lam=float(rep.best_lambda[0]),
        cv=np.asarray(rep.cv_scores[0], np.float64),
        plan=f"{rep.decision.solver}/{rep.decision.method}",
        launches={k: after[k] - before[k] for k in after},
        stream=enc.stream_stats_)
    return enc, rec


def _traced_fit(inputs: _Inputs, enc_cfg, dev):
    """One fit under ``torch.profiler``, inside the harness's window
    range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        # It warns that it keeps one cycle's events: one is all it has.
        warnings.filterwarnings("ignore", message=".*clears events")
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW):
                enc, rec = _one_fit(inputs, enc_cfg, dev)
    return enc, rec, prof


def _fit_faults(recs: list[FitRecord], cl: dict, dev) -> list[str]:
    """What is wrong with each fit's plan and kernel launches."""
    out = []
    for i, r in enumerate(recs):
        if r.plan != cl["plan"]:
            out.append(f"fit {i}: plan {r.plan}, not {cl['plan']}")
        if dev.type == "cuda" and r.launches != cl["launches_per_fit"]:
            out.append(f"fit {i}: launches {r.launches}, not "
                       f"{cl['launches_per_fit']}")
    return out


def device_block(dev, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": int(peak)}


def _card_peaks(dev) -> dict | None:
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for key, val in spec.peaks()["cards"].items():
        if key in name:
            return val
    return None


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device: str = "cuda",
        overrides: dict | None = None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``overrides`` replaces configuration keys (the tests' tiny sizes)."""
    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    cfg = merge(spec.config(bench, wl["config"]), overrides)
    tr = spec.traffic(wl["traffic"])
    cl = spec.cell(workload)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    X, Y = data.make(cfg, seed, dev)
    _sync(dev)
    inputs = _Inputs(cfg, tr, X, Y)
    if inputs.kind == "store":
        del X, Y
    sums = _checksum(*inputs.arrays(dev)) if inputs.kind == "memory" \
        else None
    try:
        enc_cfg = encoder_config(cfg)
        enc, warm = _one_fit(inputs, enc_cfg, dev)
        del enc
        gc.collect()
        _sync(dev)
        setup_s = time.perf_counter() - t_start
        log(f"{workload} seed {seed}: set-up {setup_s:.3f} s (warm-up fit "
            f"{warm.seconds:.3f} s, plan {warm.plan})")
        setup_peak = 0
        if dev.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)

        recs: list[FitRecord] = []
        w0 = time.perf_counter()
        while True:
            enc = None                      # free the last fit's state
            if traced and not recs:
                # The profiler traces the window's first fit; the rest of
                # the window runs as untraced runs do.
                enc, rec, prof = _traced_fit(inputs, enc_cfg, dev)
            else:
                enc, rec = _one_fit(inputs, enc_cfg, dev)
            recs.append(rec)
            if time.perf_counter() - w0 >= seconds:
                break
        w1 = time.perf_counter()
        window_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        fit_s = (w1 - w0) / len(recs)
        log(f"window {w1 - w0:.3f} s, {len(recs)} fits: "
            + ", ".join(f"{r.seconds:.3f}" for r in recs)
            + f" s; λ {sorted({r.lam for r in recs})}; peak "
            f"{window_peak / GIB:.3f} GiB")

        faults = _fit_faults(recs, cl, dev)
        if sums is not None and _checksum(*inputs.arrays(dev)) != sums:
            faults.append("the fit changed its input arrays")
        W = enc.weights_
        del enc
        gc.collect()

        metrics: dict[str, dict] = {}
        dev_info = device_block(dev, max(setup_peak, window_peak))
        breakdown = None
        if traced:
            t_tr = time.perf_counter()
            rec = trace_mod.collect(prof.profiler.kineto_results.events())
            del prof
            summ = trace_mod.summarize(rec)
            log(f"trace: {len(rec.ops)} host ops, {len(rec.activities)} "
                f"device activities, read in "
                f"{time.perf_counter() - t_tr:.3f} s")
            del rec
            dev_info.update(busy_s=summ.busy_s, window_s=summ.window_s)
            breakdown = {"device_ops": summ.device_ops,
                         "idle_gaps": summ.idle_gaps}
            log(f"trace: busy {summ.busy_s:.3f} of {summ.window_s:.3f} s; "
                f"layers {summ.layers}")
            ctx = types.SimpleNamespace(
                config=cfg, traffic=tr, cell=cl, fits=recs[:1],
                fit_s=recs[0].seconds,
                trace=summ, peaks=_card_peaks(dev), count=spec.count)
            for m in spec.metrics_for(bench, wl, True):
                v = spec.reader(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            # A metric is named by what it measures, then the kind of
            # cell it belongs to (``fit_s.inmem``, ``fit_s.store``).
            values = {"fit_s": fit_s, "peak_mem_gib": window_peak / GIB,
                      "setup_s": setup_s}
            for m in spec.metrics_for(bench, wl, False):
                value = values[m["name"].split(".")[0]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        if dev.type == "cuda":
            torch.cuda.empty_cache()
        Xr, Yr = inputs.arrays(dev)
        t_ref = time.perf_counter()
        ref = reference.ridge_cv(
            Xr, Yr, cfg["lambdas"], n_folds=cfg["n_folds"],
            jitter=cfg["jitter"], scoring=cfg["scoring"])
        _sync(dev)
        numbers = correct_mod.gaps([r.cv for r in recs], W, ref)
        ok, checks = correct_mod.judge(numbers, cl["limits"])
        lams = np.asarray(cfg["lambdas"])
        log(f"reference {time.perf_counter() - t_ref:.3f} s: λ "
            f"{lams[ref.best]:g}; CV curve "
            f"{np.round(ref.cv.numpy(), 6).tolist()}; λ compared "
            f"{lams[correct_mod.resolved(ref)].tolist()}")
    finally:
        inputs.close()
    for f in faults:
        log(f"FAULT {f}")
    good = bool(ok and not faults)
    result = {"correct": good, "attempted": len(recs),
              "failed": 0 if good else len(recs),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    return result
