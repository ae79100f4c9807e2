#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card (Hopper, sm_90a)

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
nvcc into ``build/kernels/``, then runs six phases, each of which raises
(exit code 1) on a failed check:

1. Environment: versions, TF32 switches (all off), card name and power
   limit, kernel build time and the compiler's register/spill report.
2. Each kernel against its plain PyTorch version, f32 and bf16, at small
   ragged shapes and at the main path's full shapes, with times of the
   kernel, the plain version, the nearest library call, and the card's
   bound for the same work.
3. The primal slice at the paper's full size (``parcels``: n=69,202
   training rows, p=16,384, t=444) through ``pipeline.run``: 76,891 rows
   are generated so that the 90/10 split leaves the fit the paper's
   69,202.  It must launch ``xty_folds`` exactly once and come out
   significant.
4. The dual slice (``whole_brain_mor``: n=1,000, p=16,384, t=2,000) through
   ``BrainEncoder`` — must launch ``xty`` twice and come out significant.
5. Kernel path against plain path (``use_pallas`` True/False) on the card.
6. The streamed slice at the ``parcels`` size: the 69,202 training rows are
   written to a ``RunStore`` under ``build/`` (about 4.7 GB of disk, deleted
   at the end) in runs of 480 rows, then fitted by ``pipeline.run_store``
   and by a budgeted ``BrainEncoder.fit(store=)``.  Each must launch
   ``xty_folds_masked`` 9 times (8,192-row chunks); the first must come out
   significant on the 7,689 held-out rows, the second must resolve to the
   ``chunked`` plan and equal the in-memory fit of the same rows.

The last two lines are the kernels' JSON record and the ``{"ok": true, ...}``
line.  Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (f32 FLOP/s outside the tensor cores, device memory bytes/s) from NVIDIA's
# data sheet, at the full power limit; "H100 80GB HBM3" is the SXM part.
_PEAKS = {"H100 80GB HBM3": (67e12, 3.35e12)}
# |kernel − plain| ≤ REL_TOL · max|plain|.  Both accumulate in f32 (bf16
# products are exact in f32), so the gap is summation order alone: about
# eps·sqrt(rows) of max|plain| at the full 69,202-row shape.
REL_TOL = 1e-4
# pipeline.run holds out this share of the rows before the fit.
TEST_FRAC = 0.1
# Phase 6: rows per stored run (about one 12-minute half-episode at TR
# 1.49 s) and rows per streamed chunk.
RUN_ROWS = 480
CHUNK_ROWS = 8192


def rows_before_split(n_fit: int) -> int:
    """Rows to generate so that ``pipeline.split`` leaves ``n_fit``."""
    n = round(n_fit / (1.0 - TEST_FRAC))
    while n - max(1, round(n * TEST_FRAC)) < n_fit:
        n += 1
    while n - max(1, round(n * TEST_FRAC)) > n_fit:
        n -= 1
    check(n - max(1, round(n * TEST_FRAC)) == n_fit,
          f"no row count leaves {n_fit} training rows")
    return n


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def peaks(name: str) -> tuple[float, float]:
    for key, val in _PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no f32/bandwidth peaks known for card {name!r}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 1
# --------------------------------------------------------------------------
def phase_env() -> dict:
    import torch
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = smi()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    print(f"[env] TF32: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}")
    print(f"[env] nvidia-smi: {card}")
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"[env] kernels built+loaded in {build_s:.2f} s: {path.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[env]   ptxas: {line.strip()}")
    return {"card": card, "build_s": build_s}


# --------------------------------------------------------------------------
# Phase 2
# --------------------------------------------------------------------------
def _compare(name, got, want, dtype_name) -> tuple[float, float]:
    """→ (max |kernel − plain|, max |plain|), checked against REL_TOL."""
    import torch
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.float32,
          f"{name}: shape/dtype {tuple(got.shape)} {got.dtype}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= REL_TOL * max(scale, 1e-30),
          f"{name} {dtype_name}: max|kernel-plain|={err:.3e} > "
          f"{REL_TOL:g}·max|plain|={REL_TOL * scale:.3e}")
    return err, scale


def phase_kernels_small() -> None:
    import torch
    from repro_torch.core.foldstats import fold_bounds
    from repro_torch.kernels import gram, ref

    g = torch.Generator("cuda").manual_seed(1)
    fold_cases = [  # (n, p, q, bounds)
        (203, 129, 70, fold_bounds(203, 5)),
        (1037, 255, 391, fold_bounds(1037, 5)),
        (150, 33, 17, [(0, 7), (7, 7), (7, 100), (100, 101), (101, 150)]),
        (9, 1, 300, [(0, 4), (4, 9)]),
    ]
    xty_cases = [(64, 32, 48), (300, 129, 70), (1, 1, 1), (1037, 255, 130),
                 (5000, 200, 7)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for n, p, q, b in fold_cases:
            x = torch.randn(n, p, device="cuda", generator=g).to(dt)
            y = torch.randn(n, q, device="cuda", generator=g).to(dt)
            err, _ = _compare(f"xty_folds{(n, p, q, len(b))}",
                              gram.xty_folds(x, y, b),
                              ref.xty_folds(x, y, b), dn)
            print(f"[kernels] xty_folds n={n} p={p} q={q} k={len(b)} {dn}: "
                  f"max abs err {err:.3e} ok")
        for n, p, q in xty_cases:
            x = torch.randn(n, p, device="cuda", generator=g).to(dt)
            y = torch.randn(n, q, device="cuda", generator=g).to(dt)
            err, _ = _compare(f"xty{(n, p, q)}", gram.xty(x, y),
                              ref.xty(x, y), dn)
            print(f"[kernels] xty n={n} p={p} q={q} {dn}: max abs err "
                  f"{err:.3e} ok")
    masked_cases = [(203, 129, 70, 1), (1037, 255, 391, 2), (9, 1, 300, 3)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for m, p, q, s in masked_cases:
            x = torch.randn(m, p, device="cuda", generator=g).to(dt)
            z = torch.randn(m, q, device="cuda", generator=g).to(dt)
            # Random, non-contiguous slots; the last slot stays all-zero
            # (s > 1), and some rows belong to no slot.
            slot = torch.randint(0, max(s - 1, 1) + 1, (m,), device="cuda",
                                 generator=g)
            w = torch.zeros(m, s, device="cuda")
            keep = slot < max(s - 1, 1)
            w[keep.nonzero()[:, 0], slot[keep]] = 1.0
            for name, wt in (("one-hot", w), ("real weights",
                             w * torch.rand(m, s, device="cuda",
                                            generator=g))):
                wt = wt.to(dt)
                err, _ = _compare(f"xty_folds_masked{(m, p, q, s)} {name}",
                                  gram.xty_folds_masked(x, z, wt),
                                  ref.xty_folds_masked(x, z, wt), dn)
                print(f"[kernels] xty_folds_masked m={m} p={p} q={q} s={s} "
                      f"{name} {dn}: max abs err {err:.3e} ok")
    # The wrappers refuse what the kernel does not take.
    x = torch.randn(8, 4, device="cuda")
    for bad in (x.T, x.double(), x.cpu()):
        try:
            gram.xty(bad, bad)
        except ValueError:
            continue
        raise RuntimeError("xty accepted an operand it must refuse")
    w = torch.ones(8, 2, device="cuda")
    for bad in (w.T.contiguous(), w.bfloat16(), w[:7]):
        try:
            gram.xty_folds_masked(x, x, bad)
        except ValueError:
            continue
        raise RuntimeError("xty_folds_masked accepted a mask it must refuse")


def _bound_ms(flops: float, nbytes: float, card: str) -> tuple[float, str]:
    f32_peak, bw = peaks(card)
    t_ops, t_bytes = flops / f32_peak, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _measure(name, kernel, plain, library, args32, flops, nbytes, card,
             reps):
    """Compare in f32 and bf16, time in f32 → the record's numbers.
    ``args32`` are the f32 operands; the same tensor twice stays shared."""
    import torch
    errs, scale = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        cast = {id(a): a.to(dt) for a in args32}
        args = [cast[id(a)] for a in args32]
        got = kernel(*args)
        want = plain(*args)
        dn = str(dt).removeprefix("torch.")
        errs[dn], scale[dn] = _compare(name, got, want, dn)
        del got, want, args, cast
        free()
    ms = time_ms(lambda: kernel(*args32), reps)
    plain_ms = time_ms(lambda: plain(*args32), reps)
    lib_ms = time_ms(lambda: library(*args32), reps)
    bound, by = _bound_ms(flops, nbytes, card)
    print(f"[kernels] {name}: max abs err f32 {errs['float32']:.3e}, bf16 "
          f"{errs['bfloat16']:.3e} (tol {REL_TOL:g}·max|plain|, max|plain| "
          f"{scale['float32']:.4e}); kernel "
          f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f}"
          f" ms, library {lib_ms:.3f} ms, bound {bound:.3f} ms ({by}) "
          f"[{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": errs["float32"]}


def phase_kernels_full(card: str, reps: int) -> dict:
    import torch
    from repro_torch.core.foldstats import fold_bounds
    from repro_torch.kernels import gram, ref

    from repro_torch.core import complexity
    from repro_torch.encoding import EncoderConfig

    g = torch.Generator("cuda").manual_seed(2)
    rec = {}
    # Primal: Xᵀ[X | Y] per fold at the shape phase 3's fit gives the kernel
    # (the parcels training rows after the split).
    w = complexity.PAPER_WORKLOADS["parcels"]
    n, p, t, k = w.n, w.p, w.t, EncoderConfig().n_folds
    b = fold_bounds(n, k)
    X = torch.randn(n, p, device="cuda", generator=g)
    Z = torch.cat([X, torch.randn(n, t, device="cuda", generator=g)], 1)
    q = p + t

    def lib_folds(x, y):
        return [torch.matmul(x[lo:hi].T, y[lo:hi]) for lo, hi in b]

    rec["xty_folds"] = _measure(
        f"xty_folds n={n} p={p} q={q} k={k}",
        lambda x, y: gram.xty_folds(x, y, b),
        lambda x, y: ref.xty_folds(x, y, b), lib_folds, (X, Z),
        2.0 * n * p * q, 4.0 * (n * p + n * q + k * p * q), card, reps)
    del X, Z
    free()
    # Dual: XXᵀ on a contiguous Xᵀ, and Xᵀα, at the whole_brain_mor shape.
    n, p, t = 1_000, 16_384, 2_000
    X = torch.randn(n, p, device="cuda", generator=g)
    Xt = X.T.contiguous()
    alpha = torch.randn(n, t, device="cuda", generator=g)
    parts = [
        _measure(f"xty XXt x=({p},{n})", gram.xty, ref.xty,
                 lambda x, y: torch.matmul(x.T, y), (Xt, Xt), 2.0 * p * n * n,
                 4.0 * (p * n + n * n), card, reps * 10),
        _measure(f"xty Xt.alpha x=({n},{p}) y=({n},{t})",
                 gram.xty, ref.xty, lambda x, y: torch.matmul(x.T, y),
                 (X, alpha), 2.0 * n * p * t,
                 4.0 * (n * p + n * t + p * t), card, reps * 10)]
    # One dual fit launches each once: the record sums the two shapes.
    rec["xty"] = {key: sum(pt[key] for pt in parts)
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rec["xty"]["bound_by"] = parts[0]["bound_by"]
    rec["xty"]["max_abs_err"] = max(pt["max_abs_err"] for pt in parts)
    del X, Xt, alpha
    free()
    # Streamed: one chunk update of phase 6 — the 8,192 rows at 8,192..16,383
    # of the parcels training rows, which straddle the fold-0/fold-1 bound.
    w = complexity.PAPER_WORKLOADS["parcels"]
    n, p, t, k = w.n, w.p, w.t, EncoderConfig().n_folds
    m, q, lo = CHUNK_ROWS, w.p + w.t, CHUNK_ROWS
    folds = [(max(a, lo) - lo, min(b, lo + m) - lo)
             for a, b in fold_bounds(n, k) if a < lo + m and b > lo]
    check(len(folds) == 2, f"chunk at row {lo} meets folds {folds}")
    W = torch.zeros(m, len(folds), device="cuda")
    for s_, (a, b) in enumerate(folds):
        W[a:b, s_] = 1.0
    X = torch.randn(m, p, device="cuda", generator=g)
    Z = torch.cat([X, torch.randn(m, t, device="cuda", generator=g)], 1)
    s = W.shape[1]

    def lib_masked(x, z, wt):
        return [torch.matmul((x * wt[:, i:i + 1]).T, z) for i in range(s)]

    rec["xty_folds_masked"] = _measure(
        f"xty_folds_masked m={m} p={p} q={q} s={s}", gram.xty_folds_masked,
        ref.xty_folds_masked, lib_masked, (X, Z, W), 2.0 * s * m * p * q,
        4.0 * (m * p + m * q + m * s + s * p * q), card, reps)
    selected = 2.0 * float(W.sum()) * p * q
    print(f"[kernels] xty_folds_masked: the mask selects "
          f"{int(W.sum())} of {s}·{m} slot-rows, {selected:.4e} of the "
          f"{2.0 * s * m * p * q:.4e} FLOPs computed (a stage-skipping "
          f"kernel's share) [{card}]")
    del X, Z, W
    free()
    return rec


# --------------------------------------------------------------------------
# Phase 3
# --------------------------------------------------------------------------
def phase_primal(card: str) -> int:
    import torch
    from repro_torch.core import complexity
    from repro_torch.data import fmri
    from repro_torch.encoding import EncoderConfig, pipeline
    from repro_torch.kernels import gram

    w = complexity.PAPER_WORKLOADS["parcels"]
    spec = fmri.SubjectSpec(n=rows_before_split(w.n), p=w.p, t=w.t)
    g = torch.Generator("cuda").manual_seed(0)
    t0 = time.perf_counter()
    X, Y, _ = fmri.generate(spec, g, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    gram.reset_launches()
    t0 = time.perf_counter()
    state = pipeline.run(X, Y, EncoderConfig(), device="cuda",
                         test_frac=TEST_FRAC, n_perms=5)
    total_s = time.perf_counter() - t0
    launches = dict(gram.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del X, Y
    rep, ev = state.report, state.evaluation
    d = rep.decision
    n_fit = state.X.shape[0]
    print(f"[primal] n={spec.n} rows, fit on n={n_fit} (test "
          f"{state.X_test.shape[0]}) p={spec.p} t={spec.t}: decision "
          f"{d.solver}/{d.method} kernel tier {d.use_pallas}; launches "
          f"{launches}; λ={rep.best_lambda[0]:g}; mean r {ev.mean_r:.4f} vs "
          f"null |r| {ev.null_abs_r:.4f} (significant {ev.significant})")
    print(f"[primal] data generated in {gen_s:.2f} s; pipeline.run "
          f"{total_s:.2f} s; stages (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in state.stage_seconds.items())
          + f"; peak device memory {peak / 2**30:.2f} GiB [{card}]")
    check(d.solver == "ridge" and d.method == "eigh" and d.use_pallas,
          f"primal decision {d}")
    check(n_fit == w.n, f"fit saw n={n_fit} rows, not the paper's {w.n}")
    check(launches["xty_folds"] == 1, f"xty_folds launches {launches}")
    check(float(rep.best_lambda[0]) in rep.lambdas, "λ not in the grid")
    check(bool(torch.isfinite(rep.weights).all()), "W has non-finite values")
    check(tuple(rep.weights.shape) == (spec.p, spec.t), "W shape")
    check(ev.significant, "primal fit not significant")
    n_eigh = EncoderConfig().n_folds + 1
    del state
    free()
    # The fit's eighs are not separable from the pipeline's wall time, so
    # time one eigh of a p×p SPD matrix on the same card.
    A = torch.randn(spec.p, spec.p, device="cuda", generator=g)
    M = A @ A.T / spec.p + torch.eye(spec.p, device="cuda")
    del A
    torch.linalg.eigh(M[:256, :256])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.eigh(M)
    torch.cuda.synchronize()
    eigh_s = time.perf_counter() - t0
    print(f"[primal] one eigh of a {spec.p}² f32 SPD matrix: {eigh_s:.2f} s; "
          f"the fit runs {n_eigh}: ~{n_eigh * eigh_s:.1f} s of the "
          f"{total_s:.1f} s pipeline [{card}]")
    del M
    free()
    return launches["xty_folds"]


# --------------------------------------------------------------------------
# Phase 4
# --------------------------------------------------------------------------
def phase_dual(card: str) -> int:
    import torch
    from repro_torch.core import complexity
    from repro_torch.data import fmri
    from repro_torch.encoding import BrainEncoder
    from repro_torch.kernels import gram

    w = complexity.PAPER_WORKLOADS["whole_brain_mor"]
    n_test = 20_000   # held-out rows from the same planted model
    spec = fmri.SubjectSpec(n=w.n + n_test, p=w.p, t=w.t)
    g = torch.Generator("cuda").manual_seed(3)
    X, Y, _ = fmri.generate(spec, g, device="cuda")
    gram.reset_launches()
    t0 = time.perf_counter()
    enc = BrainEncoder(device="cuda").fit(X[:w.n], Y[:w.n])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(gram.LAUNCHES)
    ev = enc.evaluate(X[w.n:], Y[w.n:], n_perms=5)
    rep, d = enc.report_, enc.report_.decision
    print(f"[dual] fit n={w.n} p={w.p} t={w.t} in {fit_s:.3f} s: decision "
          f"{d.solver}/{d.method} kernel tier {d.use_pallas}; launches "
          f"{launches}; λ={rep.best_lambda[0]:g}; on {n_test} held-out rows "
          f"mean r {ev.mean_r:.4f} vs null |r| {ev.null_abs_r:.4f} "
          f"(significant {ev.significant}) [{card}]")
    check(d.method == "dual" and d.use_pallas, f"dual decision {d}")
    check(launches["xty"] >= 2 and launches["xty_folds"] == 0,
          f"dual launches {launches}")
    check(bool(torch.isfinite(rep.weights).all()), "dual W non-finite")
    check(ev.significant, "dual fit not significant")
    del X, Y, enc
    free()
    return launches["xty"]


# --------------------------------------------------------------------------
# Phase 5
# --------------------------------------------------------------------------
def phase_paths() -> None:
    import numpy as np
    import torch
    from repro_torch.data import fmri
    from repro_torch.encoding import BrainEncoder
    from repro_torch.kernels import gram

    g = torch.Generator("cuda").manual_seed(4)
    for name, (n, p, t) in (("primal", (4096, 512, 256)),
                            ("dual", (256, 1024, 128))):
        X, Y, _ = fmri.generate(fmri.SubjectSpec(n=n, p=p, t=t), g,
                                device="cuda")
        gram.reset_launches()
        kern = BrainEncoder(device="cuda", use_pallas=True).fit(X, Y).report_
        launched = sum(gram.LAUNCHES.values())
        plain = BrainEncoder(device="cuda", use_pallas=False).fit(X, Y).report_
        check(launched >= 1 and sum(gram.LAUNCHES.values()) == launched,
              f"{name}: kernel launches {gram.LAUNCHES}")
        check(kern.best_lambda[0] == plain.best_lambda[0],
              f"{name}: λ {kern.best_lambda} vs {plain.best_lambda}")
        np.testing.assert_allclose(kern.weights.cpu().numpy(),
                                   plain.weights.cpu().numpy(),
                                   rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(kern.cv_scores, plain.cv_scores,
                                   rtol=1e-4, atol=2e-4)
        dw = (kern.weights - plain.weights).abs().max().item()
        print(f"[paths] {name} n={n} p={p} t={t}: λ {kern.best_lambda[0]:g} "
              f"equal, max|ΔW| {dw:.3e} (rtol 1e-4, atol 2e-4) ok")


# --------------------------------------------------------------------------
# Phase 6
# --------------------------------------------------------------------------
def phase_streamed(card: str) -> int:
    import numpy as np
    import torch
    from repro_torch.core import complexity
    from repro_torch.data import fmri
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder, EncoderConfig, pipeline
    from repro_torch.kernels import gram

    w = complexity.PAPER_WORKLOADS["parcels"]
    n_all = rows_before_split(w.n)
    spec = fmri.SubjectSpec(n=n_all, p=w.p, t=w.t)
    n_chunks = -(-w.n // CHUNK_ROWS)
    need = w.n * (w.p + w.t) * 4
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free_b = shutil.disk_usage(build).free
    check(free_b > need + (1 << 30),
          f"phase 6 writes a {need / 1e9:.2f} GB store under {build}, which "
          f"has {free_b / 1e9:.2f} GB free: free disk space and rerun")
    g = torch.Generator("cuda").manual_seed(5)
    X, Y, _ = fmri.generate(spec, g, device="cuda")
    X_test, Y_test = X[w.n:].clone(), Y[w.n:].clone()
    root = tempfile.mkdtemp(prefix="chip_smoke_store_", dir=build)
    try:
        t0 = time.perf_counter()
        store = RunStore.create(root, n_folds=EncoderConfig().n_folds)
        for i, lo in enumerate(range(0, w.n, RUN_ROWS)):
            hi = min(lo + RUN_ROWS, w.n)
            store.write(X[lo:hi], Y[lo:hi], f"sub-01_run-{i:04d}")
        del X, Y
        free()
        store = RunStore.open(root)
        write_s = time.perf_counter() - t0
        check(store.shape == (w.n, w.p, w.t), f"store shape {store.shape}")
        print(f"[streamed] store: {len(store.runs)} runs of {RUN_ROWS} rows, "
              f"{store.shape}, {store.nbytes_resident() / 1e9:.2f} GB, "
              f"written in {write_s:.2f} s")

        # (a) the two-pass streamed pipeline.
        torch.cuda.reset_peak_memory_stats()
        gram.reset_launches()
        t0 = time.perf_counter()
        state = pipeline.run_store(store, EncoderConfig(),
                                   chunk_rows=CHUNK_ROWS, device="cuda")
        run_s = time.perf_counter() - t0
        launches = dict(gram.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        rep, ss, std = state.report, state.encoder.stream_stats_, \
            state.standardizer
        ev = state.encoder.evaluate(std.apply_x(X_test), std.apply_y(Y_test),
                                    n_perms=5)
        sec = state.stage_seconds
        print(f"[streamed] run_store n={w.n} p={w.p} t={w.t} chunk_rows="
              f"{CHUNK_ROWS}: decision {rep.decision.solver}/"
              f"{rep.decision.method} kernel tier {rep.decision.use_pallas}; "
              f"launches {launches}; λ={rep.best_lambda[0]:g}; on "
              f"{X_test.shape[0]} held-out rows mean r {ev.mean_r:.4f} vs "
              f"null |r| {ev.null_abs_r:.4f} (significant {ev.significant})")
        print(f"[streamed] run_store {run_s:.2f} s: moments pass "
              f"{sec['fit_chunked.moments']:.2f} s, stats pass "
              f"{sec['fit_chunked.stats']:.2f} s, solve "
              f"{sec['fit_chunked.solve']:.2f} s; stream: {ss['chunks']} "
              f"chunks, {ss['bytes_staged'] / 1e9:.2f} GB staged, read_stall "
              f"{ss['read_stall_s']:.3f} s, compute_stall "
              f"{ss['compute_stall_s']:.3f} s; peak device memory "
              f"{peak / 2**30:.2f} GiB [{card}]")
        check(launches["xty_folds_masked"] == n_chunks
              and launches["xty_folds"] == 0,
              f"run_store launches {launches}, want {n_chunks} masked")
        check(float(rep.best_lambda[0]) in rep.lambdas, "λ not in the grid")
        check(bool(torch.isfinite(rep.weights).all()), "W has non-finite "
              "values")
        check(tuple(rep.weights.shape) == (w.p, w.t), "W shape")
        check(ss["chunks"] == n_chunks, f"stream chunks {ss['chunks']}")
        check(ev.significant, "streamed fit not significant")
        del state, rep, std
        free()

        # (b) budgeted fit(store=) → chunked, against the in-memory fit.
        budget = 4 << 30
        gram.reset_launches()
        t0 = time.perf_counter()
        enc = BrainEncoder(EncoderConfig(device_memory_budget=budget),
                           device="cuda").fit(store=store)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches_b = dict(gram.LAUNCHES)
        d = enc.report_.decision
        print(f"[streamed] fit(store=) with device_memory_budget="
              f"{budget / 2**30:g} GiB (resident set "
              f"{store.nbytes_resident() / 2**30:.2f} GiB): decision "
              f"{d.solver}/{d.method} kernel tier {d.use_pallas}; launches "
              f"{launches_b}; {fit_s:.2f} s [{card}]")
        check(d.method == "chunked" and d.use_pallas, f"budgeted decision {d}")
        check(launches_b["xty_folds_masked"] == n_chunks,
              f"fit(store=) launches {launches_b}")
        W_s, lam_s = enc.weights_.cpu(), enc.report_.best_lambda[0]
        del enc
        free()
        mem = BrainEncoder(device="cuda").fit(*store.load())
        W_m, lam_m = mem.weights_.cpu(), mem.report_.best_lambda[0]
        del mem
        free()
        dw = float((W_s - W_m).abs().max())
        tol = 2e-4 + 1e-4 * float(W_m.abs().max())
        print(f"[streamed] fit(store=) against the in-memory fit of the same "
              f"rows: λ {lam_s:g} vs {lam_m:g}, max|ΔW| {dw:.3e} (limit "
              f"{tol:.3e} = 2e-4 + 1e-4·max|W|) [{card}]")
        check(lam_s == lam_m, f"λ streamed {lam_s} != in-memory {lam_m}")
        check(np.isfinite(dw) and dw <= tol, f"max|ΔW| {dw} > {tol}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches["xty_folds_masked"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    env = phase_env()
    card = env["card"]
    phase_kernels_small()
    rec = phase_kernels_full(card, reps=3)
    launches = {"xty_folds": phase_primal(card),
                "xty": phase_dual(card)}
    phase_paths()
    launches["xty_folds_masked"] = phase_streamed(card)
    replaces = {"xty_folds": "src/repro/kernels/gram.py:158",
                "xty": "src/repro/kernels/gram.py:72",
                "xty_folds_masked": "src/repro/kernels/gram.py:233"}
    kernels = [{"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/gram.cu",
                "replaces": replaces[name], "launches": launches[name],
                **{k: rec[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")}}
               for name in ("xty_folds", "xty", "xty_folds_masked")]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
