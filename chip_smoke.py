#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card (Hopper, sm_90a)

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
nvcc into ``build/kernels/``, then runs thirteen phases, each of which
raises (exit code 1) on a failed check:

1. Environment: versions, TF32 switches (all off), card name and power
   limit, kernel build time (one nvcc per source, in parallel; beside it,
   the same sources in one serial nvcc call) and the compiler's
   register/spill report.
2. Each kernel against its plain PyTorch version, f32 and bf16, at small
   ragged shapes and at the main path's full shapes, with times of the
   kernel and the nearest library call (in turns: library, kernel,
   kernel, library), the plain version, and the card's bound for the same
   work; ``xty``'s two dual parts each on its own, with ``XXᵀ``
   (row-split) beside the row loop's unsplit one-range launch and its
   repeated launches held bitwise equal.  ``xty_folds`` and
   ``xty_folds_masked`` run on the split-bf16 tensor-core engine: their
   bound is the tensor-core time of the bf16 term products they compute,
   the f32-rate bound beside it; their small cases also check the split
   model, repeated launches bitwise equal and the non-finite rule (NaN
   where the plain version is NaN, non-finite where it is ±Inf), and
   ``xty_folds`` two launches bitwise equal at the full shape.
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

7. The backbone kernels (``flash_attention``, ``ssd_intra``) against their
   plain versions, f32 and bf16, at small ragged shapes covering every
   option (causal, window, softcap, GQA, head dimensions 16 to 256), then
   at the full-width shapes of one zamba2-2.7b forward (B=8 sequences of
   S=4,096 tokens): flash through ``mha_flash`` on strided views of one
   projection, as the model calls it (B=8, S=T=4,096, H=32, K=80, causal,
   bf16), and through ``flash_attention`` on contiguous (B·H, S, K) copies;
   ssd_intra (tensor cores, L and x split into exact bf16 terms) at N=128
   chunks, Q=256, H=80, P=64 on f32 inputs, as the forward feeds it, and
   on bf16 inputs; its small cases also hold it against the split model
   (``ref.ssd_intra_split``), repeated launches bitwise equal and the
   non-finite rule.  Times of the kernel, the plain version, the nearest
   library call (flash: ``scaled_dot_product_attention``, backend named)
   and the card's bound (bf16 flash and ssd_intra: the largest of the
   tensor-core time of their bf16 term products, the exponentials at the
   SFU rate, and the bytes; ssd_intra's f32-rate bound beside it).
8. The full-width, full-depth zamba2-2.7b forward (63 pattern slots,
   d=2,560) in f32 parameters, once with both kernel switches on and once
   with both off: max|Δh| ≤ 1e-3·max|h|.
9. The backbone-features slice (``launch/encode.py``'s steps) in bf16:
   parameters from a seed, 8 × 4,096 random tokens, ``hidden_states``
   (timed), the 32,768 × 2,560 standardized features, a planted response
   for t=444 parcels, ``pipeline.run`` (primal).  It must launch
   ``ssd_intra`` 54 times, ``flash_attention`` 9 times and ``xty_folds``
   once, and come out significant; that ``xty_folds`` launch is held
   against ``ref.xty_folds`` on its operands, and the fit against the
   plain-path fit (equal λ, W and CV curve within rtol 1e-4/atol 2e-4).
   Then one more forward runs under ``torch.profiler`` and the device
   time is printed by kernel.
10. The seed path's kernels (``solve_lambda_grid``, on the split engine as
    in phase 2, and ``pearson_r``) against their plain versions, f32 and
    bf16: at small ragged shapes (Q row- and column-major, repeated
    launches, an Inf and a NaN in A; a constant and a perfectly
    anti-correlated column), then
    at full shapes with times of kernel, plain version and library call
    beside the bound: the solve at the parcels primal split (r=11,
    p=16,384, t=444, Q from an ``eigh``), Pearson at the whole-brain
    evaluation (7,689 test rows × 264,805 targets) through ``ops.pearson_r``
    (one launch, counted), and on phase 3's held-out rows against the
    centred ``scoring.pearson_r``.
11. The seed per-fold CV path ``ridge_cv_reference`` with the kernel tier
    on: primal at the ``parcels`` size (5 ``solve_lambda_grid`` and 6
    ``xty`` launches; its first solve held against the plain version on
    its operands; λ, W and CV curve against ``ridge_cv`` at the reference's
    parity tolerance; wall times of both, and the seed path split into
    Gram + eigh, solve, predictions + scores and refit), then dual at the
    ``whole_brain_mor`` size (61 ``xty`` launches; equal to the plain seed
    path).
12. The whole-brain subject at full width (``whole_brain_bmor``: n=10,000,
    p=16,384, t=264,805; the full subject's n=69,202 is cut to the
    10,000 the repo's Table 1 rows give the B-MOR whole-brain experiment):
    a ``RunStore`` under ``build/`` written by ``materialize_synthetic``
    (10.6 GB of Y and 0.66 GB of X), ``BrainEncoder(device_memory_budget=
    64 GiB, target_block=16,384).fit(store=)``, which must plan
    ``colblocked`` itself (17 blocks, the last of 2,661 targets), make 36
    ``xty_folds_masked`` launches (2 chunks × (the X-only pass + 17
    blocks)) with one signature per update and one pass over X (its rows
    cached); its first column-block launch is held against the plain
    version on its operands, the first and the ragged last block's
    weights against the unblocked statistics solve of their columns (rtol
    1e-4, atol 2e-4).  Then ``save`` (17 shards, 17.4 GB), reopened with
    ``EncoderBundle.open``: two shards, the last among them, bitwise equal
    to the weights.  Prints the fit's time split (stats pass, eighs,
    scoring, Â and solve, the rest; save), peak device memory, staging.
    Free disk (~31 GB: the store, then the Â scratch or the bundle) and
    host RAM (~40 GB) are checked first; everything is deleted at the end.
13. The tier's parity on the card at n=4,000, p=2,048, t=6,728, 1,024-row
    chunks, t_block=2,048: kernel tier = plain tier, global mode = the
    unblocked ``chunked`` tier, per-block mode = ``ridge_cv_from_stats``
    per block, the spill path (X re-streamed per block) bitwise equal to
    the cached run, and ``BundleWriter`` shards (f32, bf16) bitwise equal
    to the collected weights (bf16 rounded to nearest even).

The last two lines are the kernels' JSON record and the ``{"ok": true, ...}``
line.  Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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
# H100 Tensor Core GPU data sheets, at each part's full power limit:
# "H100 80GB HBM3" is the SXM part (67 TFLOPS FP32, 3.35 TB/s), "H100 PCIe"
# the PCIe card (51 TFLOPS FP32, 2 TB/s of HBM2e), "H100 NVL" the NVL card
# (60 TFLOPS FP32, 3.9 TB/s).
_PEAKS = {"H100 80GB HBM3": (67e12, 3.35e12),
          "H100 PCIe": (51e12, 2.0e12),
          "H100 NVL": (60e12, 3.9e12)}
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
# Phases 7-9: the backbone slice.  Tolerances of the attention and SSD
# kernels against their plain versions, by output dtype.  Both sides read
# the same operands and compute in f32, so an f32 output differs in
# summation order only, and a bf16 output (rounded once, from f32 values
# that differ by ~1e-6) by at most one bf16 ulp: ≤ 2⁻⁷ of its magnitude.
BACKBONE = "zamba2-2.7b"
BATCH, SEQ, PARCELS = 8, 4096, 444
FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=8e-3, atol=1e-5)}
# bf16 tensor-core peak (dense, f32 accumulation): the rate for a product
# of two bf16 operands, which is exact in f32.  The same data sheets list
# the rates with sparsity (1,979, 1,513 and 1,671 TFLOPS); dense is half.
_BF16_PEAK = {"H100 80GB HBM3": 989e12, "H100 PCIe": 756e12,
              "H100 NVL": 835e12}
# Phase 10-11: the seed path.  The reference's kernel-test tolerance for
# Pearson r against the centred formula (tests/test_kernels.py:171-173, f32)
# and its parity tolerances of the seed path against ridge_cv
# (tests/test_foldstats.py:139-144).
PEARSON_CENTRED_TOL = 1e-3
SEED_CV_TOL, SEED_W_TOL = 1e-3, 2e-3
# The whole-brain evaluation: the paper's 264,805 targets on the held-out
# 10% of the rows that rows_before_split(69,202) generates.
WHOLE_BRAIN_T = 264_805
# Phase 12: the whole-brain column-blocked fit.  The block width is pinned:
# a block's working set on the card (C, the Gram's scoring terms, six
# eigenbases and up to three (r, p, t_block) scoring temporaries) is ~55 GB
# at 16,384, and the reference's pick_target_block would take ~88,000 at
# this budget because it prices only k·p·(p + t_block).
WB_TARGET_BLOCK = 16_384
WB_BUDGET = 64 << 30
# Phase 13: the tier's parity on the card at a small p (the paper's roi
# target count; chunks misaligned with the 5 folds; a ragged last block).
WB_SMALL = dict(n=4_000, p=2_048, t=6_728, chunk_rows=1_024, t_block=2_048)


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


def bf16_peak(name: str) -> float:
    for key, val in _BF16_PEAK.items():
        if key in name:
            return val
    raise RuntimeError(f"no bf16 tensor-core peak known for card {name!r}")


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
    how = ("one nvcc per source, in parallel, then linked" if log
           else "already built")
    print(f"[env] kernels built+loaded in {build_s:.2f} s ({how}): "
          f"{path.name}")
    if log:
        # The same sources in one serial nvcc call, for comparison only.
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            t0 = time.perf_counter()
            _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                         "-o", str(Path(tmp) / "serial.so"),
                         *map(str, _build._sources())])
            serial_s = time.perf_counter() - t0
        print(f"[env] the same sources in one serial nvcc call: "
              f"{serial_s:.2f} s [{card}]")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "Performance Loss" in line):
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


def _nonfinite_rule(name, got, want) -> float:
    """The split engine's rule for non-finite inputs: NaN where the plain
    version is NaN, non-finite where it is ±Inf, finite entries within
    REL_TOL·max|plain| → max |kernel − plain| over the finite entries."""
    import torch
    torch.cuda.synchronize()
    nan, inf = torch.isnan(want), torch.isinf(want)
    check(bool(nan.any()) or bool(inf.any()), f"{name}: no non-finite "
          f"entries in the plain version's output")
    check(bool(torch.isnan(got[nan]).all()), f"{name}: a NaN of the plain "
          f"version is not NaN in the kernel's output")
    check(not bool(torch.isfinite(got[inf]).any()), f"{name}: an Inf of the "
          f"plain version is finite in the kernel's output")
    fin = ~(nan | inf)
    err = (got[fin] - want[fin]).abs().max().item()
    scale = want[fin].abs().max().item()
    check(err <= REL_TOL * scale, f"{name}: finite entries max|kernel-plain|"
          f"={err:.3e} > {REL_TOL:g}·{scale:.3e}")
    return err


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
            got = gram.xty_folds(x, y, b)
            err, _ = _compare(f"xty_folds{(n, p, q, len(b))}", got,
                              ref.xty_folds(x, y, b), dn)
            check(torch.equal(got, gram.xty_folds(x, y, b)),
                  f"xty_folds{(n, p, q, len(b))}: repeated launches differ")
            check(all(not got[f].any() for f, (lo, hi) in enumerate(b)
                      if lo == hi), "xty_folds: an empty fold is not zero")
            model = (got - ref.xty_folds_split(x, y, b)).abs().max().item()
            print(f"[kernels] xty_folds n={n} p={p} q={q} k={len(b)} {dn}: "
                  f"max abs err {err:.3e} (against the split model "
                  f"{model:.3e}), repeated launch bitwise equal ok")
        for n, p, q in xty_cases:
            x = torch.randn(n, p, device="cuda", generator=g).to(dt)
            y = torch.randn(n, q, device="cuda", generator=g).to(dt)
            err, _ = _compare(f"xty{(n, p, q)}", gram.xty(x, y),
                              ref.xty(x, y), dn)
            print(f"[kernels] xty n={n} p={p} q={q} {dn}: max abs err "
                  f"{err:.3e} ok")
    # m, p, q multiples of no tile of the split engine (128 × 192 × 32).
    masked_cases = [(203, 129, 70, 1), (1037, 255, 391, 2), (9, 1, 300, 3),
                    (333, 131, 197, 2)]
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
                got = gram.xty_folds_masked(x, z, wt)
                err, _ = _compare(f"xty_folds_masked{(m, p, q, s)} {name}",
                                  got, ref.xty_folds_masked(x, z, wt), dn)
                check(torch.equal(got, gram.xty_folds_masked(x, z, wt)),
                      f"xty_folds_masked{(m, p, q, s)}: repeated launches "
                      f"differ")
                check(s == 1 or not got[-1].any(),
                      "xty_folds_masked: the all-zero slot is not zero")
                model = (got - ref.xty_folds_masked_split(x, z, wt)
                         ).abs().max().item()
                print(f"[kernels] xty_folds_masked m={m} p={p} q={q} s={s} "
                      f"{name} {dn}: max abs err {err:.3e} (against the "
                      f"split model {model:.3e}), repeated launch bitwise "
                      f"equal ok")
        # A NaN in x under a zero weight, an Inf in x under its weight, an
        # Inf in z.
        x = torch.randn(203, 129, device="cuda", generator=g)
        z = torch.randn(203, 70, device="cuda", generator=g)
        w = torch.zeros(203, 2, device="cuda")
        w[:100, 0] = 1.0
        w[100:, 1] = 1.0
        x[5, 3], w[5] = float("nan"), 0.0
        x[120, 9] = float("inf")
        z[150, 7] = float("inf")
        x, z, w = x.to(dt), z.to(dt), w.to(dt)
        err = _nonfinite_rule("xty_folds_masked non-finite",
                              gram.xty_folds_masked(x, z, w),
                              ref.xty_folds_masked(x, z, w))
        print(f"[kernels] xty_folds_masked non-finite inputs {dn}: NaN where "
              f"plain NaN, non-finite where plain ±Inf, finite max abs err "
              f"{err:.3e} ok")
        # xty_folds: a NaN in x and an Inf in y, in different folds.
        b = fold_bounds(203, 5)
        x = torch.randn(203, 129, device="cuda", generator=g)
        y = torch.randn(203, 70, device="cuda", generator=g)
        x[5, 3] = float("nan")
        y[150, 7] = float("inf")
        x, y = x.to(dt), y.to(dt)
        err = _nonfinite_rule("xty_folds non-finite", gram.xty_folds(x, y, b),
                              ref.xty_folds(x, y, b))
        print(f"[kernels] xty_folds non-finite inputs {dn}: NaN where plain "
              f"NaN, non-finite where plain ±Inf, finite max abs err "
              f"{err:.3e} ok")
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
             reps, cast_args=None, products=None):
    """Compare in f32 and bf16, time in f32 → the record's numbers.
    ``args32`` are the f32 operands; the same tensor twice stays shared.
    ``cast_args``: the indices of the operands the bf16 comparison rounds
    (default all; the others stay f32).  ``products``: for a kernel on the
    split-bf16 engine, the bf16 term products it computes per product of
    the function; its bound is then the tensor-core time of those, with
    the f32-rate bound kept beside it.  Kernel and library call are timed
    in turns (library, kernel, kernel, library)."""
    import torch
    errs, scale = {}, {}
    idx = range(len(args32)) if cast_args is None else cast_args
    for dt in (torch.float32, torch.bfloat16):
        cast = {id(args32[i]): args32[i].to(dt) for i in idx}
        args = [cast.get(id(a), a) for a in args32]
        got = kernel(*args)
        want = plain(*args)
        dn = str(dt).removeprefix("torch.")
        errs[dn], scale[dn] = _compare(name, got, want, dn)
        del got, want, args, cast
        free()
    turns = [time_ms(lambda: fn(*args32), reps)
             for fn in (library, kernel, kernel, library)]
    ms, lib_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain_ms = time_ms(lambda: plain(*args32), reps)
    bound_f32, by = _bound_ms(flops, nbytes, card)
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_f32, "bound_by": by,
           "max_abs_err": errs["float32"], "tflops": flops / ms / 1e9}
    how = f"bound {bound_f32:.3f} ms ({by})"
    if products is not None:
        t_tc = products * flops / bf16_peak(card) * 1e3
        t_bytes = nbytes / peaks(card)[1] * 1e3
        rec.update(bound_ms=max(t_tc, t_bytes), bound_f32_ms=bound_f32,
                   bound_by="operations" if t_tc >= t_bytes else "bytes")
        how = (f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}: "
               f"{products} bf16 term products on the tensor cores; "
               f"bytes {t_bytes:.3f} ms), f32-rate bound {bound_f32:.3f} ms")
    print(f"[kernels] {name}: max abs err f32 {errs['float32']:.3e}, bf16 "
          f"{errs['bfloat16']:.3e} (tol {REL_TOL:g}·max|plain|, max|plain| "
          f"{scale['float32']:.4e}); kernel {ms:.3f} ms ({turns[1]:.3f}/"
          f"{turns[2]:.3f}; {rec['tflops']:.1f} TFLOP/s of the function's "
          f"{flops:.4e} FLOPs), plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.3f} ms ({turns[0]:.3f}/{turns[3]:.3f}), {how} [{card}]")
    return rec


def phase_kernels_full(card: str, reps: int) -> dict:
    import torch
    from repro_torch.core.foldstats import fold_bounds
    from repro_torch.kernels import gram, ref, split_engine

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

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    first = gram.xty_folds(X, Z, b)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    check(torch.equal(first, gram.xty_folds(X, Z, b)),
          "two xty_folds launches at the full shape differ")
    del first
    free()
    rec["xty_folds"] = _measure(
        f"xty_folds n={n} p={p} q={q} k={k}",
        lambda x, y: gram.xty_folds(x, y, b),
        lambda x, y: ref.xty_folds(x, y, b), lib_folds, (X, Z),
        2.0 * n * p * q, 4.0 * (n * p + n * q + k * p * q), card, reps,
        products=len(split_engine.pairs(*split_engine.folds_planes(
            X.dtype))))
    print(f"[kernels] xty_folds: two launches bitwise equal; one launch "
          f"allocates {extra / 2**30:.2f} GiB (output and the engine's "
          f"scratch for the largest fold) [{card}]")
    del X, Z
    free()
    # Dual: XXᵀ on a contiguous Xᵀ, and Xᵀα, at the whole_brain_mor shape,
    # each part measured on its own.  XXᵀ's 1,000² output takes the row
    # split; the row loop's unsplit one-range launch is timed beside it, in
    # turns (unsplit, split, split, unsplit).
    n, p, t = 1_000, 16_384, 2_000
    X = torch.randn(n, p, device="cuda", generator=g)
    Xt = X.T.contiguous()
    alpha = torch.randn(n, t, device="cuda", generator=g)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = gram.row_splits(p, n, n, sms)
    check(len(splits) > 1 and gram.row_splits(n, p, t, sms) == [(0, n)],
          f"row splits: XXᵀ {len(splits)}, Xᵀα "
          f"{len(gram.row_splits(n, p, t, sms))}")
    check(torch.equal(gram.xty(Xt, Xt), gram.xty(Xt, Xt)),
          "two split xty launches on XXᵀ differ")
    parts = [
        _measure(f"xty XXt x=({p},{n}) in {len(splits)} row splits",
                 gram.xty, ref.xty,
                 lambda x, y: torch.matmul(x.T, y), (Xt, Xt), 2.0 * p * n * n,
                 4.0 * (p * n + n * n), card, reps * 10),
        _measure(f"xty Xt.alpha x=({n},{p}) y=({n},{t})",
                 gram.xty, ref.xty, lambda x, y: torch.matmul(x.T, y),
                 (X, alpha), 2.0 * n * p * t,
                 4.0 * (n * p + n * t + p * t), card, reps * 10)]
    unsplit = [(0, p)]
    turns = []
    for fn in (lambda: gram._launch(Xt, Xt, unsplit, "xty"),
               lambda: gram.xty(Xt, Xt), lambda: gram.xty(Xt, Xt),
               lambda: gram._launch(Xt, Xt, unsplit, "xty")):
        turns.append(time_ms(fn, reps * 10))
    one, split = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"[kernels] xty XXt: unsplit one-range launch {turns[0]:.3f}/"
          f"{turns[3]:.3f} ms, {len(splits)} row splits {turns[1]:.3f}/"
          f"{turns[2]:.3f} ms (×{one / split:.2f}); split launches bitwise "
          f"equal [{card}]")
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

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gram.xty_folds_masked(X, Z, W)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    rec["xty_folds_masked"] = _measure(
        f"xty_folds_masked m={m} p={p} q={q} s={s}", gram.xty_folds_masked,
        ref.xty_folds_masked, lib_masked, (X, Z, W), 2.0 * s * m * p * q,
        4.0 * (m * p + m * q + m * s + s * p * q), card, reps,
        products=len(split_engine.pairs(*split_engine.masked_planes(
            X.dtype))))
    print(f"[kernels] xty_folds_masked: one launch allocates "
          f"{extra / 2**30:.2f} GiB (output and the engine's scratch) "
          f"[{card}]")
    selected = 2.0 * float(W.sum()) * p * q
    print(f"[kernels] xty_folds_masked: the mask selects "
          f"{int(W.sum())} of {s}·{m} slot-rows, {selected:.4e} of the "
          f"{2.0 * s * m * p * q:.4e} FLOPs computed (a stage-skipping "
          f"kernel's share) [{card}]")
    del X, Z, W
    free()
    # Whole-brain: one column-block chunk update of phase 12 — rows 0..8,191
    # of its n=10,000 meet all five folds; z is the block's t_block columns.
    w = complexity.PAPER_WORKLOADS["whole_brain_bmor"]
    m, q = CHUNK_ROWS, WB_TARGET_BLOCK
    folds = [(a, min(b, m)) for a, b in fold_bounds(w.n, k) if a < m]
    W = torch.zeros(m, len(folds), device="cuda")
    for s_, (a, b) in enumerate(folds):
        W[a:b, s_] = 1.0
    X = torch.randn(m, w.p, device="cuda", generator=g)
    Z = torch.randn(m, q, device="cuda", generator=g)
    s = W.shape[1]
    rec["xty_folds_masked_wholebrain"] = _measure(
        f"xty_folds_masked (whole-brain column block) m={m} p={w.p} q={q} "
        f"s={s}", gram.xty_folds_masked, ref.xty_folds_masked, lib_masked,
        (X, Z, W), 2.0 * s * m * w.p * q,
        4.0 * (m * w.p + m * q + m * s + s * w.p * q), card, reps,
        products=len(split_engine.pairs(*split_engine.masked_planes(
            X.dtype))))
    del X, Z, W
    free()
    return rec


# --------------------------------------------------------------------------
# Phase 3
# --------------------------------------------------------------------------
def phase_primal(card: str) -> tuple[int, tuple]:
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
    # The held-out rows and their predictions, for phase 10's Pearson check.
    heldout = (state.Y_test, state.encoder.predict(state.X_test))
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
    return launches["xty_folds"], heldout


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


# --------------------------------------------------------------------------
# Phase 7
# --------------------------------------------------------------------------
def _close(name, got, want) -> float:
    """→ max |kernel − plain|, checked elementwise against FLASH_TOL of the
    output's dtype."""
    import torch
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
          f"{want.dtype}")
    dtype_name = str(want.dtype).removeprefix("torch.")
    tol = FLASH_TOL[dtype_name]
    g, w = got.float(), want.float()
    bad = (g - w).abs() > tol["atol"] + tol["rtol"] * w.abs()
    err = (g - w).abs().max().item()
    check(not bool(bad.any()) and bool(torch.isfinite(g).all()),
          f"{name} {dtype_name}: {int(bad.sum())} elements outside rtol "
          f"{tol['rtol']:g}/atol {tol['atol']:g}, max|kernel-plain|={err:.3e}")
    return err


def phase_backbone_kernels_small() -> None:
    import torch
    from repro_torch.kernels import attention, ref, ssd

    g = torch.Generator("cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    # (B, S, T, H, n_kv, K, causal, window, softcap)
    cases = [(2, 200, 200, 4, 4, 80, True, None, None),
             (1, 96, 96, 2, 1, 64, True, 40, 50.0),
             (3, 64, 64, 1, 1, 16, False, None, None),
             (2, 128, 100, 4, 2, 128, False, 30, 20.0),
             (1, 130, 130, 8, 2, 80, True, 70, None),
             (1, 65, 65, 2, 2, 256, True, None, 30.0),
             (2, 33, 97, 6, 3, 48, True, None, None)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        for b, s_, t, h, n_kv, kd, causal, window, softcap in cases:
            kw = dict(causal=causal, window=window, softcap=softcap)
            # Model layout with non-contiguous q/k/v (slices of one
            # projection, as an einsum may leave them).
            qkv = randn(b, s_ + 2 * t, h, kd)
            q = (qkv[:, :s_] * kd ** -0.5).to(dt)
            k = qkv[:, s_:s_ + t, :n_kv].to(dt)
            v = qkv[:, s_ + t:, :n_kv].to(dt)
            err = _close(f"mha_flash{(b, s_, t, h, n_kv, kd)} {kw}",
                         attention.mha_flash(q, k, v, n_kv, **kw),
                         ref.mha_flash(q, k, v, n_kv, **kw).contiguous())
            qf = q.permute(0, 2, 1, 3).reshape(b * h, s_, kd).contiguous()
            kf = torch.repeat_interleave(k, h // n_kv, dim=2).permute(
                0, 2, 1, 3).reshape(b * h, t, kd).contiguous()
            vf = torch.repeat_interleave(v, h // n_kv, dim=2).permute(
                0, 2, 1, 3).reshape(b * h, t, kd).contiguous()
            err2 = _close(f"flash_attention{(b * h, s_, t, kd)} {kw}",
                          attention.flash_attention(qf, kf, vf, **kw),
                          ref.flash_attention(qf, kf, vf, **kw))
            print(f"[backbone-kernels] flash B={b} S={s_} T={t} H={h} "
                  f"n_kv={n_kv} K={kd} causal={causal} window={window} "
                  f"softcap={softcap} {dn}: max abs err mha {err:.3e}, "
                  f"(BH,S,K) {err2:.3e} ok")
        for n, q_, h, p in [(3, 100, 5, 70), (2, 256, 8, 64), (4, 8, 16, 32),
                            (1, 64, 3, 130), (2, 1, 2, 1), (2, 256, 17, 64),
                            (1, 300, 9, 48)]:
            cb = (randn(n, q_, q_) / q_ ** 0.5).to(dt)
            la = torch.cumsum(-randn(n, q_, h).abs() * 0.05, 1).to(dt)
            x = randn(n, q_, h, p).to(dt)
            got = ssd.ssd_intra(cb, la, x)
            err = _close(f"ssd_intra{(n, q_, h, p)}", got,
                         ref.ssd_intra(cb, la, x))
            model = _close(f"ssd_intra{(n, q_, h, p)} split model", got,
                           ref.ssd_intra_split(cb, la, x))
            check(torch.equal(got, ssd.ssd_intra(cb, la, x)),
                  f"ssd_intra{(n, q_, h, p)}: repeated launches differ")
            print(f"[backbone-kernels] ssd_intra N={n} Q={q_} H={h} P={p} "
                  f"{dn}: max abs err {err:.3e} (against the split model "
                  f"{model:.3e}), repeated launch bitwise equal ok")
        # Non-finite values on and off the walk: an Inf and a NaN of x past
        # a tile's diagonal (the reference's 0·Inf), an Inf of cb below the
        # diagonal, a NaN and an Inf of cb above it.
        n, q_, h, p = 2, 256, 9, 64
        cb = randn(n, q_, q_) / q_ ** 0.5
        la = torch.cumsum(-randn(n, q_, h).abs() * 0.05, 1)
        x = randn(n, q_, h, p)
        x[0, 200, 3, 5], x[1, 10, 0, 7] = float("inf"), float("nan")
        x[1, 70, 8, 63] = float("-inf")
        cb[0, 5, 2], cb[0, 30, 150] = float("inf"), float("nan")
        cb[1, 100, 50], cb[1, 3, 40] = float("inf"), float("inf")
        cb, la, x = cb.to(dt), la.to(dt), x.to(dt)
        err = _nonfinite_rule("ssd_intra non-finite", ssd.ssd_intra(cb, la, x),
                              ref.ssd_intra(cb, la, x))
        print(f"[backbone-kernels] ssd_intra non-finite inputs {dn}: NaN where "
              f"plain NaN, non-finite where plain ±Inf, finite max abs err "
              f"{err:.3e} ok")
    # The wrappers refuse what the kernels do not take.
    q = torch.zeros(1, 8, 2, 80, device="cuda")
    for bad in (dict(n_kv=3), dict(window=0), dict(softcap=-1.0)):
        kw = dict(dict(n_kv=2), **bad)
        try:
            attention.mha_flash(q, q, q, kw.pop("n_kv"), **kw)
        except ValueError:
            continue
        raise RuntimeError(f"mha_flash accepted {bad}")
    for bad in (torch.zeros(1, 8, 1, 257, device="cuda"), q.double(),
                q.cpu()):
        try:
            attention.mha_flash(bad, bad, bad, 1)
        except ValueError:
            continue
        raise RuntimeError("mha_flash accepted an operand it must refuse")
    try:
        ssd.ssd_intra(q[0, :, :, :8], q[0, :, :, 0], q)
    except ValueError:
        pass
    else:
        raise RuntimeError("ssd_intra accepted mismatched shapes")


def _sdpa(q, k, v):
    """(name, fn) of the fastest SDPA backend that takes the model layout
    (B, S, H, K) as (B, H, S, K) views, causal, with q pre-scaled (scale
    1)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    args = [a.transpose(1, 2) for a in (q, k, v)]
    names = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
             "MATH")
    for backend in (getattr(SDPBackend, n) for n in names
                    if hasattr(SDPBackend, n)):
        def fn(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    *args, is_causal=True, scale=1.0).transpose(1, 2)
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, fn
    raise RuntimeError("no SDPA backend takes these inputs")


def phase_backbone_kernels_full(card: str, reps: int) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.kernels import attention, ref, split_engine, ssd
    from repro_torch.models.ssm import _dims

    cfg = configs.get_config(BACKBONE)
    g = torch.Generator("cuda").manual_seed(8)
    rec = {}
    # Flash: one shared-block attention of the forward, in the forward's
    # dtype (bf16 parameters → bf16 q, k, v), through the wrapper the model
    # calls (mha_flash), on strided q/k/v: views of one (B, S, 3, H, K)
    # projection, q's part of the weight pre-scaled.  Scores have std ~1.
    B, S, H, K = BATCH, SEQ, cfg.n_heads, cfg.resolved_head_dim
    n_kv, d, bh, dt = cfg.n_kv_heads, cfg.d_model, BATCH * cfg.n_heads, \
        torch.bfloat16
    x = torch.randn(B, S, d, device="cuda", generator=g).to(dt)
    w = torch.randn(d, 3, H, K, device="cuda", generator=g) * d ** -0.5
    w[:, 0] *= K ** -0.5
    q, k, v = torch.einsum("bsd,dchk->bschk", x, w.to(dt)).unbind(2)
    k, v = k[:, :, :n_kv], v[:, :, :n_kv]
    del x, w
    check(not q.is_contiguous() and not v.is_contiguous(),
          "full-width q/k/v are not strided views")
    got = attention.mha_flash(q, k, v, n_kv)
    want = ref.mha_flash(q, k, v, n_kv).contiguous()
    err = _close(f"mha_flash B={B} S=T={S} H={H} K={K} strided", got, want)
    scale = want.float().abs().max().item()
    del got, want
    # The (BH, S, K) wrapper on contiguous copies of the same operands.
    qf, kf, vf = (a.permute(0, 2, 1, 3).reshape(bh, S, K).contiguous()
                  for a in (q, k, v))
    err_f = _close(f"flash_attention BH={bh} S=T={S} K={K}",
                   attention.flash_attention(qf, kf, vf),
                   ref.flash_attention(qf, kf, vf))
    free()
    lib_name, lib_fn = _sdpa(q, k, v)
    lib_err = (lib_fn().float() - attention.mha_flash(q, k, v, n_kv).float()
               ).abs().max().item()
    ms = time_ms(lambda: attention.mha_flash(q, k, v, n_kv), reps)
    contig_ms = time_ms(lambda: attention.flash_attention(qf, kf, vf), reps)
    plain_ms = time_ms(lambda: ref.mha_flash(q, k, v, n_kv), reps)
    lib_ms = time_ms(lib_fn, reps)
    # Bound of the bf16 design, the largest of three: the tensor cores run
    # Q·Kᵀ once and P·V three times (P split exactly into three bf16 terms,
    # each product exact in f32) at the bf16 rate; one exponential per
    # visible pair at the SFU rate, 16 a clock per SM at the clock the bf16
    # peak implies (4,096 FLOP a clock per SM), i.e. peak / 256 a second;
    # the bytes.  Beside it, the earlier bound with P·V at the f32 rate.
    pairs = S * (S + 1) / 2                        # causal (query, key) pairs
    half = 2.0 * bh * K * pairs                    # FLOPs of each product
    f32_peak, bw = peaks(card)
    t_tc = 4 * half / bf16_peak(card)
    t_exp = bh * pairs / (bf16_peak(card) / 256)
    t_f32_pv = half / bf16_peak(card) + half / f32_peak
    t_bytes = 4 * bh * S * K * q.element_size() / bw   # q, k, v; o written
    bound = max(t_tc, t_exp, t_bytes) * 1e3
    by = "operations" if max(t_tc, t_exp) >= t_bytes else "bytes"
    print(f"[backbone-kernels] flash_attention (mha_flash) B={B} S=T={S} "
          f"H={H} n_kv={n_kv} K={K} causal bf16, strided q/k/v: max abs err "
          f"{err:.3e}, (BH,S,K) contiguous {err_f:.3e} (rtol "
          f"{FLASH_TOL['bfloat16']['rtol']:g}/atol "
          f"{FLASH_TOL['bfloat16']['atol']:g}, max|plain| {scale:.4e}); "
          f"kernel {ms:.3f} ms ({2 * half / ms / 1e9:.1f} TFLOP/s; "
          f"contiguous (BH,S,K) {contig_ms:.3f} ms), plain {plain_ms:.3f} "
          f"ms, library {lib_ms:.3f} ms (SDPA {lib_name}, max|SDPA-kernel| "
          f"{lib_err:.3e}), bound {bound:.3f} ms ({by}: tensor cores "
          f"{t_tc * 1e3:.3f} ms for Q·Kᵀ + 3 split P·V at the bf16 rate, "
          f"exponentials {t_exp * 1e3:.3f} ms at the SFU rate, bytes "
          f"{t_bytes * 1e3:.3f} ms; with P·V at the f32 rate, the CUDA-core "
          f"design's bound, {t_f32_pv * 1e3:.3f} ms) [{card}]")
    rec["flash_attention"] = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bound,
                              "bound_by": by, "max_abs_err": err}
    del q, k, v, qf, kf, vf, lib_fn
    free()
    # ssd_intra: one Mamba2 block's within-chunk term (f32, as the SSD
    # forward computes it), then the same values as bf16 inputs.
    _, H, P, _, _ = _dims(cfg)
    Q = cfg.ssm.chunk
    N = BATCH * SEQ // Q
    cb = torch.randn(N, Q, Q, device="cuda", generator=g) / Q ** 0.5
    la = torch.cumsum(-torch.randn(N, Q, H, device="cuda",
                                   generator=g).abs() * 0.05, 1)
    x = torch.randn(N, Q, H, P, device="cuda", generator=g)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        args = [a.to(dt) for a in (cb, la, x)]
        got = ssd.ssd_intra(*args)
        want = ref.ssd_intra(*args)
        dn = str(dt).removeprefix("torch.")
        errs[dn] = _close(f"ssd_intra N={N} Q={Q} H={H} P={P} {dn}", got,
                          want)
        scale = want.abs().max().item()
        del got, want, args
        free()
    ms = time_ms(lambda: ssd.ssd_intra(cb, la, x), reps * 10)
    plain_ms = time_ms(lambda: ref.ssd_intra(cb, la, x), reps)
    # Bound of the tensor-core design, the largest of three: the kept bf16
    # term products of L and x (6 for f32 x) at the bf16 rate, one
    # exponential per (q, k ≤ q, h) at the SFU rate (bf16 peak / 256, as
    # flash's), and the bytes of cb, la, x and y.  Beside it, the f32-rate
    # bound the CUDA-core kernel it replaces faced.
    pairs = Q * (Q + 1) / 2
    flops = 2.0 * N * H * P * pairs
    nbytes = 4.0 * (N * Q * Q + N * Q * H + 2 * N * Q * H * P)
    products = len(split_engine.pairs(3, 3))
    t_tc = products * flops / bf16_peak(card) * 1e3
    t_exp = N * H * pairs / (bf16_peak(card) / 256) * 1e3
    t_bytes = nbytes / peaks(card)[1] * 1e3
    bound = max(t_tc, t_exp, t_bytes)
    by = "bytes" if t_bytes >= max(t_tc, t_exp) else "operations"
    bound_f32, _ = _bound_ms(flops, nbytes, card)
    print(f"[backbone-kernels] ssd_intra N={N} Q={Q} H={H} P={P}: max abs "
          f"err f32 {errs['float32']:.3e}, bf16 inputs {errs['bfloat16']:.3e} "
          f"(rtol/atol 2e-4, max|plain| {scale:.4e}); kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s of the function's {flops:.4e} "
          f"FLOPs), plain {plain_ms:.3f} ms, library none, bound "
          f"{bound:.3f} ms ({by}: tensor cores {t_tc:.3f} ms for {products} "
          f"bf16 term products, exponentials {t_exp:.3f} ms at the SFU "
          f"rate, bytes {t_bytes:.3f} ms), f32-rate bound {bound_f32:.3f} ms "
          f"[{card}]")
    rec["ssd_intra"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                        "bound_ms": bound, "bound_by": by,
                        "bound_f32_ms": bound_f32,
                        "max_abs_err": errs["float32"]}
    del cb, la, x
    free()
    return rec


# --------------------------------------------------------------------------
# Phases 8 and 9
# --------------------------------------------------------------------------
def _backbone(kernels: bool, dtype):
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model

    cfg = configs.get_config(BACKBONE)
    cfg = dataclasses.replace(
        cfg, param_dtype=dtype, flash_threshold=512, flash_block=512,
        flash_kernel=kernels,
        ssm=dataclasses.replace(cfg.ssm, use_kernel=kernels))
    return cfg, build_model(cfg)


def _counted():
    from repro_torch.kernels import attention, gram, pearsonr, ridge_solve, ssd
    return (attention, gram, pearsonr, ridge_solve, ssd)


def _reset_counters() -> None:
    for mod in _counted():
        mod.reset_launches()


def _counters() -> dict:
    return {k: v for mod in _counted() for k, v in mod.LAUNCHES.items()}


def phase_backbone_f32_paths(card: str) -> None:
    import torch
    from repro_torch.data import synthetic

    cfg, model = _backbone(True, torch.float32)
    _, plain = _backbone(False, torch.float32)
    params = model.init(torch.Generator("cuda").manual_seed(10))
    batch = synthetic.make_batch(torch.Generator("cuda").manual_seed(11),
                                 cfg, BATCH, SEQ)

    def forward(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = m.hidden_states(params, batch)
        torch.cuda.synchronize()
        return h, time.perf_counter() - t0

    _reset_counters()
    h_k, kern_s = forward(model)
    launches = _counters()
    h, plain_s = forward(plain)
    dh = (h_k - h).abs().max().item()
    scale = h.abs().max().item()
    print(f"[backbone-f32] {cfg.name} full width and depth, f32 parameters, "
          f"B={BATCH} S={SEQ}: kernel path {kern_s:.2f} s (launches "
          f"{launches}), plain path {plain_s:.2f} s; max|Δh| {dh:.3e} vs "
          f"max|h| {scale:.4e} (limit 1e-3·max|h| = {1e-3 * scale:.3e}) "
          f"[{card}]")
    check(launches["flash_attention"] == cfg.n_repeats
          and launches["ssd_intra"] == cfg.n_repeats * 6,
          f"f32 kernel-path launches {launches}")
    check(bool(torch.isfinite(h).all()) and bool(torch.isfinite(h_k).all()),
          "non-finite hidden states")
    check(dh <= 1e-3 * scale, f"max|Δh| {dh:.3e} > 1e-3·max|h|")
    del params, h, h_k
    free()


def phase_backbone(card: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.foldstats import fold_bounds
    from repro_torch.data import fmri, synthetic
    from repro_torch.encoding import BrainEncoder, EncoderConfig, pipeline
    from repro_torch.kernels import gram, ref
    from repro_torch.models.params import count_params, param_bytes

    cfg, model = _backbone(True, torch.bfloat16)
    g = torch.Generator("cuda").manual_seed(12)
    t0 = time.perf_counter()
    params = model.init(g)
    batch = synthetic.make_batch(g, cfg, BATCH, SEQ)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    defs = model.param_defs()
    print(f"[backbone] {cfg.name}: {count_params(defs):,} parameters "
          f"({param_bytes(defs) / 1e9:.2f} GB bf16) drawn in {init_s:.2f} s")
    model.hidden_states(params, synthetic.make_batch(g, cfg, 1, 512))
    torch.cuda.synchronize()
    free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    h = model.hidden_states(params, batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_peak = torch.cuda.max_memory_allocated()
    # encode.py:160-177: every token's hidden state is one row of X.
    t0 = time.perf_counter()
    X = h.reshape(-1, h.shape[-1]).float()
    X = (X - X.mean(0)) / (X.std(0, correction=0) + 1e-6)
    n, p = X.shape
    _, _, mask = fmri.generate(fmri.SubjectSpec(n=n, p=p, t=PARCELS), g,
                               device="cuda")
    W_true = torch.randn(p, PARCELS, device="cuda", generator=g) / p ** 0.5
    W_true = W_true * mask.float()[None, :]
    Y = X @ W_true * 2.0 + torch.randn(n, PARCELS, device="cuda",
                                       generator=g)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    del h, W_true
    t0 = time.perf_counter()
    state = pipeline.run(X, Y, EncoderConfig(), device="cuda",
                         detrend_targets=False, n_perms=5)
    fit_s = time.perf_counter() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    rep, ev, d = state.report, state.evaluation, state.report.decision
    print(f"[backbone] hidden_states B={BATCH} S={SEQ} bf16: {fwd_s:.3f} s "
          f"({n / fwd_s:,.0f} tokens/s), peak device memory "
          f"{fwd_peak / 2**30:.2f} GiB; features X ({n}, {p}) + planted Y "
          f"(t={PARCELS}) {feat_s:.3f} s; pipeline.run {fit_s:.2f} s, stages "
          f"(s) " + ", ".join(f"{k} {v:.3f}"
                              for k, v in state.stage_seconds.items())
          + f"; peak device memory {peak / 2**30:.2f} GiB [{card}]")
    print(f"[backbone] decision {d.solver}/{d.method} kernel tier "
          f"{d.use_pallas}; launches {launches}; λ={rep.best_lambda[0]:g}; "
          f"fit on {state.X.shape[0]} rows, on {state.X_test.shape[0]} "
          f"held-out rows mean r {ev.mean_r:.4f} vs null |r| "
          f"{ev.null_abs_r:.4f} (significant {ev.significant})")
    n_mamba = cfg.n_repeats * sum(k == "mamba" for k in cfg.pattern)
    check(launches["ssd_intra"] == n_mamba == 54,
          f"ssd_intra launches {launches}")
    check(launches["flash_attention"] == cfg.n_repeats == 9,
          f"flash_attention launches {launches}")
    check(launches["xty_folds"] == 1 and d.method == "eigh" and d.use_pallas,
          f"fit launches {launches}, decision {d}")
    check(float(rep.best_lambda[0]) in rep.lambdas, "λ not in the grid")
    check(bool(torch.isfinite(rep.weights).all()), "W has non-finite values")
    check(tuple(rep.weights.shape) == (p, PARCELS), "W shape")
    check(ev.significant, "backbone-features fit not significant")
    del X, Y
    free()
    # The fit's xty_folds launch against its plain version on the same
    # operands (the standardized training rows, Xᵀ[X | Y] per fold), and
    # the whole fit against the plain-path fit (use_pallas=False).
    Xtr, Ytr = state.X, state.Y
    bounds = fold_bounds(Xtr.shape[0], EncoderConfig().n_folds)
    Z = torch.cat([Xtr, Ytr], 1)
    err, _ = _compare(f"xty_folds n={Xtr.shape[0]} p={p} q={Z.shape[1]} "
                      f"k={len(bounds)}", gram.xty_folds(Xtr, Z, bounds),
                      ref.xty_folds(Xtr, Z, bounds), "float32")
    del Z
    free()
    plain = BrainEncoder(EncoderConfig(), device="cuda",
                         use_pallas=False).fit(Xtr, Ytr).report_
    dw = (rep.weights - plain.weights).abs().max().item()
    print(f"[backbone] fit's xty_folds against ref.xty_folds on its operands:"
          f" max abs err {err:.3e} (tol {REL_TOL:g}·max|plain|); plain-path "
          f"fit λ {plain.best_lambda[0]:g} vs {rep.best_lambda[0]:g}, "
          f"max|ΔW| {dw:.3e} (rtol 1e-4, atol 2e-4) [{card}]")
    check(plain.best_lambda[0] == rep.best_lambda[0],
          f"λ kernel path {rep.best_lambda} vs plain {plain.best_lambda}")
    np.testing.assert_allclose(rep.weights.cpu().numpy(),
                               plain.weights.cpu().numpy(),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(rep.cv_scores, plain.cv_scores,
                               rtol=1e-4, atol=2e-4)
    del state, rep, plain, Xtr, Ytr
    free()
    _profile_forward(model, params, batch, fwd_s, card)
    del params
    free()
    return launches


def _profile_forward(model, params, batch, fwd_s: float, card: str) -> None:
    """Device time of one more bf16 forward by kernel, from torch.profiler:
    the device-side kernel records only (not the CPU ops that launch
    them), so no time is counted twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.hidden_states(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"[backbone] profile: the profiler recorded no device time "
              f"[{card}]")
        return
    rows.sort(reverse=True)
    ours = {k: sum(r[0] for r in rows if k in r[2])
            for k in ("flash_attention", "ssd_intra")}
    gemm = sum(r[0] for r in rows if any(
        w in r[2].lower() for w in ("gemm", "nvjet", "cutlass", "xmma")))
    print(f"[backbone] profile of one more bf16 forward: {wall_ms:.1f} ms "
          f"wall under the profiler (timed forward {fwd_s * 1e3:.1f} ms), "
          f"device busy {busy:.1f} ms ({100 * (1 - busy / wall_ms):.1f}% "
          f"idle): flash_attention {ours['flash_attention']:.1f} ms "
          f"({100 * ours['flash_attention'] / busy:.1f}%), ssd_intra "
          f"{ours['ssd_intra']:.1f} ms ({100 * ours['ssd_intra'] / busy:.1f}"
          f"%), library GEMMs {gemm:.1f} ms ({100 * gemm / busy:.1f}%), "
          f"everything else {busy - gemm - sum(ours.values()):.1f} ms; top "
          f"kernels by device time [{card}]:")
    for ms, count, name in rows[:12]:
        print(f"[backbone]   {ms:9.1f} ms {100 * ms / busy:5.1f}%  "
              f"×{count:<5d} {name[:110]}")


# --------------------------------------------------------------------------
# Phase 10
# --------------------------------------------------------------------------
def _refuses(fn, *args) -> bool:
    try:
        fn(*args)
    except ValueError:
        return True
    return False


def _pearson_pair(n, t, g):
    """(y_true, y_pred = ½·y_true + ½·noise) with column 0 of y_pred
    constant (a power of two, so Σcy = c·Σy exactly in f32 and r = 0) and
    column 1 the negated y_true (r = −1)."""
    import torch
    yt = torch.randn(n, t, device="cuda", generator=g)
    yp = torch.randn(n, t, device="cuda", generator=g)
    yp.mul_(0.5).add_(yt, alpha=0.5)
    yp[:, 0] = 2.0
    yp[:, 1] = -yt[:, 1]
    return yt, yp


def phase_seed_kernels_small() -> None:
    import torch
    from repro_torch.kernels import pearsonr, ref, ridge_solve

    g = torch.Generator("cuda").manual_seed(13)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).removeprefix("torch.")
        # tests/test_kernels.py::SHAPES_SOLVE (p, t, r), and edge sizes.
        for p, t, r in [(32, 24, 3), (130, 70, 11), (256, 128, 4), (1, 1, 1),
                        (257, 3, 2), (161, 445, 3)]:
            Q, _ = torch.linalg.qr(randn(p, p))
            ev = randn(p).abs() * 10 + 0.1
            a = randn(p, t).to(dt)
            lams = torch.logspace(-1, 3, r, device="cuda")
            errs = []
            for layout, q in (("row", Q.contiguous()),
                              ("column", Q.T.contiguous().T)):
                q = q.to(dt)
                check(p == 1 or q.is_contiguous() == (layout == "row"),
                      f"{layout}-major Q has strides {q.stride()}")
                got = ridge_solve.solve_lambda_grid(q, ev, a, lams)
                err, _ = _compare(
                    f"solve_lambda_grid{(p, t, r)} {layout}-major Q", got,
                    ref.solve_lambda_grid(q, ev, a, lams), dn)
                check(torch.equal(got, ridge_solve.solve_lambda_grid(
                    q, ev, a, lams)), f"solve_lambda_grid{(p, t, r)}: "
                    f"repeated launches differ")
                errs.append(err)
            print(f"[seed-kernels] solve_lambda_grid p={p} t={t} r={r} {dn}: "
                  f"max abs err row-major Q {errs[0]:.3e}, column-major "
                  f"{errs[1]:.3e}, repeated launches bitwise equal ok")
        # An Inf and a NaN in A.
        Q, _ = torch.linalg.qr(randn(130, 130))
        ev = randn(130).abs() * 10 + 0.1
        a = randn(130, 70)
        a[3, 5], a[7, 1] = float("inf"), float("nan")
        q, a = Q.T.contiguous().T.to(dt), a.to(dt)
        lams = torch.logspace(-1, 3, 4, device="cuda")
        err = _nonfinite_rule("solve_lambda_grid non-finite",
                              ridge_solve.solve_lambda_grid(q, ev, a, lams),
                              ref.solve_lambda_grid(q, ev, a, lams))
        print(f"[seed-kernels] solve_lambda_grid non-finite A {dn}: NaN where "
              f"plain NaN, non-finite where plain ±Inf, finite max abs err "
              f"{err:.3e} ok")
        for n, t in [(50, 17), (1000, 128), (333, 257), (1, 5), (7, 3)]:
            yt, yp = _pearson_pair(n, t, g)
            yt, yp = yt.to(dt), yp.to(dt)
            got = pearsonr.pearson_r(yt, yp)
            err, _ = _compare(f"pearson_r{(n, t)}", got,
                              ref.pearson_r(yt, yp), dn)
            check(torch.equal(got, pearsonr.pearson_r(yt, yp)),
                  f"pearson_r{(n, t)}: repeated launches differ")
            check(got[0].item() == 0.0, f"constant column: r={got[0]}")
            check(n == 1 or abs(got[1].item() + 1.0) <= 1e-4,
                  f"anti-correlated column: r={got[1]}")
            print(f"[seed-kernels] pearson_r n={n} t={t} {dn}: max abs err "
                  f"{err:.3e}, constant column r=0, anti-correlated r="
                  f"{got[1].item():.6f}, repeated launch bitwise equal ok")
    # The wrappers refuse what the kernels do not take.
    q, e, a, lm = (torch.eye(4, device="cuda"), torch.ones(4, device="cuda"),
                   torch.ones(4, 3, device="cuda"),
                   torch.ones(2, device="cuda"))
    for bad in ((q.cpu(), e, a, lm), (q[:3], e, a, lm), (q.double(), e, a, lm),
                (q, e.bfloat16(), a, lm), (q, e, a.T.contiguous().T, lm),
                (q.bfloat16(), e, a, lm)):
        check(_refuses(ridge_solve.solve_lambda_grid, *bad),
              "solve_lambda_grid accepted an operand it must refuse")
    y = torch.ones(8, 4, device="cuda")
    for bad in ((y, y[:7]), (y, y.T.contiguous().T), (y.double(), y.double()),
                (y, y.bfloat16()), (y.cpu(), y.cpu())):
        check(_refuses(pearsonr.pearson_r, *bad),
              "pearson_r accepted an operand it must refuse")


def phase_seed_kernels_full(card: str, heldout, reps: int
                            ) -> tuple[dict, int]:
    import torch
    from repro_torch.core import complexity, ridge, scoring
    from repro_torch.kernels import ops, pearsonr, ref, ridge_solve
    from repro_torch.kernels import split_engine

    g = torch.Generator("cuda").manual_seed(15)
    rec = {}
    # solve_lambda_grid at one primal split of the parcels fit: Q and Λ of
    # an eigh (as the seed path's factorize gives them), A = Qᵀ·XᵀY (p, t).
    w = complexity.PAPER_WORKLOADS["parcels"]
    p, t = w.p, w.t
    lams = torch.tensor(ridge.PAPER_LAMBDA_GRID, device="cuda")
    r = lams.numel()
    B = torch.randn(p, p, device="cuda", generator=g)
    M = B @ B.T / p
    del B
    M.diagonal().add_(1.0)
    ev, Q = torch.linalg.eigh(M)
    del M
    eigh_strides = Q.stride()
    if Q.stride() != (1, p):
        Q = Q.T.contiguous().T
    a = torch.matmul(Q.T, torch.randn(p, t, device="cuda", generator=g))

    def lib_solve(q, e, a_, lm):
        return torch.matmul(q, a_[None] * (1.0 / (e[None] + lm[:, None])
                                           )[:, :, None])

    flops = 2.0 * r * p * p * t
    nbytes = 4.0 * (p * p + p * t + r * p * t + p + r)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ridge_solve.solve_lambda_grid(Q, ev, a, lams)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    rec["solve_lambda_grid"] = _measure(
        f"solve_lambda_grid r={r} p={p} t={t} column-major Q",
        ridge_solve.solve_lambda_grid, ref.solve_lambda_grid, lib_solve,
        (Q, ev, a, lams), flops, nbytes, card, reps, cast_args=(0, 2),
        products=len(split_engine.pairs(*split_engine.solve_planes(
            Q.dtype))))
    print(f"[seed-kernels] solve_lambda_grid: one launch allocates "
          f"{extra / 2**30:.2f} GiB (output, reciprocals and the engine's "
          f"scratch) [{card}]")
    Qr = Q.contiguous()
    err_r, _ = _compare("solve_lambda_grid row-major Q",
                        ridge_solve.solve_lambda_grid(Qr, ev, a, lams),
                        ref.solve_lambda_grid(Q, ev, a, lams), "float32")
    row_ms = time_ms(lambda: ridge_solve.solve_lambda_grid(Qr, ev, a, lams),
                     reps)
    print(f"[seed-kernels] solve_lambda_grid: eigh returned Q with strides "
          f"{eigh_strides}; on a row-major copy {row_ms:.3f} ms (max abs err "
          f"{err_r:.3e}) against {rec['solve_lambda_grid']['ms']:.3f} ms read "
          f"in place column-major [{card}]")
    del Q, Qr, ev, a, lams
    free()

    # pearson_r at the whole-brain evaluation: the held-out 10% of the rows
    # rows_before_split(69,202) generates × the paper's 264,805 targets.
    n, T = rows_before_split(w.n) - w.n, WHOLE_BRAIN_T
    yt, yp = _pearson_pair(n, T, g)
    torch.cuda.synchronize()
    # The entry point a user calls, counted alone.
    _reset_counters()
    got = ops.pearson_r(yt, yp)
    torch.cuda.synchronize()
    launches = _counters()
    check(launches["pearson_r"] == 1 and sum(launches.values()) == 1,
          f"ops.pearson_r launches {launches}")
    want = ref.pearson_r(yt, yp)
    err, scale = _compare(f"pearson_r n={n} t={T}", got, want, "float32")
    del want
    check(got[0].item() == 0.0 and abs(got[1].item() + 1.0) <= 1e-4,
          f"constant / anti-correlated columns: r={got[:2].tolist()}")
    check(torch.equal(got, pearsonr.pearson_r(yt, yp)),
          "pearson_r: repeated launches differ")
    ms = time_ms(lambda: pearsonr.pearson_r(yt, yp), reps * 10)
    plain_ms = time_ms(lambda: ref.pearson_r(yt, yp), reps)
    bound, by = _bound_ms(8.0 * n * T, 4.0 * (2 * n * T + T), card)
    # bf16 inputs: rounded copies, the f32 ones freed first.
    yt16, yp16 = yt.bfloat16(), yp.bfloat16()
    del yt, yp, got
    free()
    err16, _ = _compare(f"pearson_r n={n} t={T}",
                        pearsonr.pearson_r(yt16, yp16),
                        ref.pearson_r(yt16, yp16), "bfloat16")
    ms16 = time_ms(lambda: pearsonr.pearson_r(yt16, yp16), reps * 10)
    bound16, _ = _bound_ms(8.0 * n * T, 2.0 * 2 * n * T + 4.0 * T, card)
    del yt16, yp16
    free()
    print(f"[seed-kernels] pearson_r n={n} t={T}: max abs err f32 {err:.3e}, "
          f"bf16 {err16:.3e} (tol {REL_TOL:g}·max|plain|, max|plain| "
          f"{scale:.4e}); kernel {ms:.3f} ms ({2 * 4 * n * T / ms / 1e6:.1f} "
          f"GB/s; bf16 inputs {ms16:.3f} ms, bound {bound16:.3f} ms), plain "
          f"{plain_ms:.3f} ms, library none, bound {bound:.3f} ms ({by}) "
          f"[{card}]")
    rec["pearson_r"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                        "bound_ms": bound, "bound_by": by, "max_abs_err": err}

    # Phase 3's held-out rows: the kernel against the centred formula the
    # estimator scores with, at the reference test's tolerance.
    Y_test, Y_pred = (v.contiguous() for v in heldout)
    r_k = pearsonr.pearson_r(Y_test, Y_pred)
    r_c = scoring.pearson_r(Y_test, Y_pred)
    err_p, _ = _compare(f"pearson_r held-out {tuple(Y_test.shape)}", r_k,
                        ref.pearson_r(Y_test, Y_pred), "float32")
    d = (r_k - r_c).abs().max().item()
    print(f"[seed-kernels] pearson_r on phase 3's held-out rows "
          f"{tuple(Y_test.shape)}: mean r {r_k.mean().item():.4f}; max "
          f"|kernel − centred scoring.pearson_r| {d:.3e} (rtol/atol "
          f"{PEARSON_CENTRED_TOL:g}), max |kernel − plain| {err_p:.3e} ok "
          f"[{card}]")
    check(bool(torch.allclose(r_k, r_c, rtol=PEARSON_CENTRED_TOL,
                              atol=PEARSON_CENTRED_TOL)),
          f"held-out r: kernel vs centred formula max|Δ| {d:.3e}")
    return rec, launches["pearson_r"]


# --------------------------------------------------------------------------
# Phase 11
# --------------------------------------------------------------------------
def _seed_breakdown(X, Y, cfg):
    """``ridge_cv_reference``'s steps with the port's own functions, the
    device synchronised after each → (seconds by stage, CV curve, W)."""
    import torch
    from repro_torch.core import foldstats, ridge

    sec = dict.fromkeys(("gram+eigh", "XtY", "solve_lambda_grid",
                         "predict+score", "refit"), 0.0)

    def lap(key, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sec[key] += now - t0
        return now

    scores = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi in foldstats.fold_bounds(X.shape[0], cfg.n_folds):
        X_tr = torch.cat([X[:lo], X[hi:]])
        factors = ridge.factorize(X_tr, cfg)
        t0 = lap("gram+eigh", t0)
        rhs = ridge.gram_xty(X_tr, torch.cat([Y[:lo], Y[hi:]]))
        del X_tr
        t0 = lap("XtY", t0)
        Ws = ridge.solve_lambda_grid(factors, rhs, cfg.lambdas,
                                     use_pallas=cfg.use_pallas)
        del factors, rhs
        t0 = lap("solve_lambda_grid", t0)
        preds = torch.einsum("np,rpt->rnt", X[lo:hi].float(), Ws)
        scores.append(ridge._score(Y[lo:hi], preds, cfg.scoring))
        del Ws, preds
        t0 = lap("predict+score", t0)
    cv = torch.stack(scores).mean(0)
    lam = ridge._lambda_grid(cfg, X.device)[torch.argmax(cv)]
    W = ridge.solve(ridge.factorize(X, cfg), ridge.gram_xty(X, Y), lam)
    lap("refit", t0)
    return sec, cv, W


def phase_seed_primal(card: str) -> int:
    import numpy as np
    import torch
    from repro_torch.core import complexity, ridge
    from repro_torch.data import fmri
    from repro_torch.kernels import ops, ref

    w = complexity.PAPER_WORKLOADS["parcels"]
    g = torch.Generator("cuda").manual_seed(16)
    X, Y, _ = fmri.generate(fmri.SubjectSpec(n=w.n, p=w.p, t=w.t), g,
                            device="cuda")
    cfg = ridge.RidgeCVConfig(use_pallas=True)
    # Keep the operands and output of the first solve launch: it is held
    # against the plain version after the run.
    first = {}
    solve = ops.solve_lambda_grid

    def keep_first(q, evals, a, lambdas):
        out = solve(q, evals, a, lambdas)
        if not first:
            first.update(args=(q, evals, a, lambdas), out=out)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    ops.solve_lambda_grid = keep_first
    try:
        t0 = time.perf_counter()
        seed = ridge.ridge_cv_reference(X, Y, cfg)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
    finally:
        ops.solve_lambda_grid = solve
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    want = {"solve_lambda_grid": cfg.n_folds, "xty": cfg.n_folds + 1}
    check(launches == {**dict.fromkeys(launches, 0), **want},
          f"seed path launches {launches}, want {want}")
    err, scale = _compare("the seed path's first solve_lambda_grid launch",
                          first["out"], ref.solve_lambda_grid(*first["args"]),
                          "float32")
    q_strides = first["args"][0].stride()
    first.clear()
    free()
    _reset_counters()
    t0 = time.perf_counter()
    new = ridge.ridge_cv(X, Y, cfg)
    torch.cuda.synchronize()
    new_s = time.perf_counter() - t0
    new_launches = _counters()
    check(new_launches["xty_folds"] == 1, f"ridge_cv launches {new_launches}")
    lam_s, lam_n = float(seed.best_lambda), float(new.best_lambda)
    dw = (seed.weights - new.weights).abs().max().item()
    dcv = (seed.cv_scores - new.cv_scores).abs().max().item()
    print(f"[seed-primal] ridge_cv_reference n={w.n} p={w.p} t={w.t} "
          f"use_pallas: {seed_s:.2f} s, launches {launches}, λ={lam_s:g}, "
          f"peak device memory {peak / 2**30:.2f} GiB; its first "
          f"solve_lambda_grid (Q strides {q_strides}) against "
          f"ref.solve_lambda_grid on its operands: max abs err {err:.3e} "
          f"(tol {REL_TOL:g}·max|plain|, max|plain| {scale:.4e}) [{card}]")
    print(f"[seed-primal] ridge_cv (downdated fold statistics) on the same "
          f"tensors: {new_s:.2f} s, launches {new_launches}, λ={lam_n:g}; "
          f"seed − downdate {seed_s - new_s:.2f} s; max|ΔW| {dw:.3e} (rtol/"
          f"atol {SEED_W_TOL:g}), max|Δcv| {dcv:.3e} (rtol/atol "
          f"{SEED_CV_TOL:g}) [{card}]")
    check(lam_s == lam_n, f"λ seed {lam_s} != ridge_cv {lam_n}")
    np.testing.assert_allclose(seed.cv_scores.cpu().numpy(),
                               new.cv_scores.cpu().numpy(), rtol=SEED_CV_TOL,
                               atol=SEED_CV_TOL)
    np.testing.assert_allclose(seed.weights.cpu().numpy(),
                               new.weights.cpu().numpy(), rtol=SEED_W_TOL,
                               atol=SEED_W_TOL)
    check(bool(torch.isfinite(seed.weights).all()), "seed W non-finite")
    del new
    free()
    sec, cv_b, W_b = _seed_breakdown(X, Y, cfg)
    total = sum(sec.values())
    same = (torch.equal(cv_b, seed.cv_scores)
            and torch.equal(W_b, seed.weights))
    print(f"[seed-primal] time split (the same steps, synchronised after "
          f"each; {total:.2f} s in all, result bitwise equal to the entry "
          f"point's: {same}): " + ", ".join(
              f"{k} {v:.2f} s ({100 * v / total:.1f}%)"
              for k, v in sec.items()) + f" [{card}]")
    check(torch.allclose(cv_b, seed.cv_scores, rtol=1e-5, atol=1e-6),
          "the timed steps give another CV curve than the entry point")
    del X, Y, seed, W_b
    free()
    return launches["solve_lambda_grid"]


def phase_seed_dual(card: str) -> None:
    import numpy as np
    import torch
    from repro_torch.core import complexity, ridge
    from repro_torch.data import fmri

    w = complexity.PAPER_WORKLOADS["whole_brain_mor"]
    g = torch.Generator("cuda").manual_seed(17)
    X, Y, _ = fmri.generate(fmri.SubjectSpec(n=w.n, p=w.p, t=w.t), g,
                            device="cuda")
    cfg = ridge.RidgeCVConfig(use_pallas=True)
    _reset_counters()
    t0 = time.perf_counter()
    kern = ridge.ridge_cv_reference(X, Y, cfg)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    launches = _counters()
    t0 = time.perf_counter()
    plain = ridge.ridge_cv_reference(X, Y, ridge.RidgeCVConfig())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # Per split one XXᵀ and one Xᵀα per λ; then the refit's XXᵀ.
    want = cfg.n_folds * (1 + len(cfg.lambdas)) + 1
    dw = (kern.weights - plain.weights).abs().max().item()
    print(f"[seed-dual] ridge_cv_reference n={w.n} p={w.p} t={w.t}: kernel "
          f"tier {kern_s:.3f} s, launches {launches}; plain {plain_s:.3f} s; "
          f"λ {float(kern.best_lambda):g} vs {float(plain.best_lambda):g}, "
          f"max|ΔW| {dw:.3e} (rtol 1e-4, atol 2e-4) [{card}]")
    check(launches == {**dict.fromkeys(launches, 0), "xty": want},
          f"dual seed path launches {launches}, want xty={want}")
    check(float(kern.best_lambda) == float(plain.best_lambda),
          "dual seed path: λ kernel tier != plain")
    np.testing.assert_allclose(kern.weights.cpu().numpy(),
                               plain.weights.cpu().numpy(), rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(kern.cv_scores.cpu().numpy(),
                               plain.cv_scores.cpu().numpy(), rtol=1e-4,
                               atol=2e-4)
    del X, Y, kern, plain
    free()


# --------------------------------------------------------------------------
# Phases 12 and 13
# --------------------------------------------------------------------------
def _mem_available() -> int:
    """Host memory available to new allocations, bytes (/proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


@contextlib.contextmanager
def _patched(*patches):
    """Set ``(obj, name, value)`` attributes for the block, then restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _timed(fn, timers: dict, key: str):
    """``fn`` with its synchronised wall time added to ``timers[key]``."""
    import torch

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        timers[key] += time.perf_counter() - t0
        return out
    return wrapper


def phase_wholebrain(card: str) -> int:
    import resource
    import numpy as np
    import torch
    from repro_torch.core import complexity, foldstats, ridge
    from repro_torch.data import fmri
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder, EncoderConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.serving_encoders import EncoderBundle
    from repro_torch.wholebrain import column_blocks, solver
    from repro_torch.wholebrain import stats as wstats

    w = complexity.PAPER_WORKLOADS["whole_brain_bmor"]
    n, p, t = w.n, w.p, w.t
    cfg = EncoderConfig(device_memory_budget=WB_BUDGET,
                        target_block=WB_TARGET_BLOCK, chunk_rows=CHUNK_ROWS)
    k = cfg.n_folds
    blocks = column_blocks(t, WB_TARGET_BLOCK)
    n_chunks = -(-n // CHUNK_ROWS)
    want = n_chunks * (1 + len(blocks))
    # Resources, reckoned first: the store, then the fit's Â scratch or the
    # bundle (the scratch is deleted when the fit ends); on the host the
    # collected W and the copy save() makes of it.
    store_b, wt_b = n * (p + t) * 4, p * t * 4
    disk_need = store_b + wt_b + (2 << 30)
    ram_need = 2 * wt_b + n * p * 4 + (4 << 30)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    disk_free, ram_free = shutil.disk_usage(build).free, _mem_available()
    print(f"[wholebrain] n={n} p={p} t={t}: store {store_b / 1e9:.2f} GB, "
          f"Â scratch {wt_b / 1e9:.2f} GB, bundle {wt_b / 1e9:.2f} GB on "
          f"disk (need {disk_need / 1e9:.1f} GB, {disk_free / 1e9:.1f} GB "
          f"free under {build}); host RAM need {ram_need / 1e9:.1f} GB, "
          f"{ram_free / 1e9:.1f} GB available")
    check(disk_free > disk_need,
          f"phase 12 needs {disk_need / 1e9:.1f} GB of disk under {build} "
          f"(store, then the Â scratch or the bundle), which has "
          f"{disk_free / 1e9:.1f} GB free: free disk space and rerun")
    check(ram_free > ram_need,
          f"phase 12 needs {ram_need / 1e9:.1f} GB of host RAM (W collected "
          f"once, then copied by save), {ram_free / 1e9:.1f} GB available: "
          f"free memory and rerun")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_wb_", dir=build))
    (root / "tmp").mkdir()
    saved_tempdir = tempfile.tempdir
    try:
        # The fit's scratch goes to the default temporary directory: keep
        # it on the disk checked above.
        tempfile.tempdir = str(root / "tmp")
        t0 = time.perf_counter()
        RunStore.create(str(root / "store"), n_folds=k).materialize_synthetic(
            fmri.SubjectSpec(n=n, p=p, t=t), seed=18, rows_per_run=RUN_ROWS,
            device="cuda")
        store = RunStore.open(str(root / "store"))
        write_s = time.perf_counter() - t0
        print(f"[wholebrain] store: {len(store.runs)} runs of {RUN_ROWS} "
              f"rows written by materialize_synthetic in {write_s:.2f} s")
        free()

        timers = dict.fromkeys(("stats", "check", "eighs", "scoring",
                                "solve", "fit_wholebrain"), 0.0)
        first = {}
        inside = []
        update = foldstats.FoldStatsAccumulator.update
        colblock_call = wstats._ColumnBlockUpdate.__call__
        masked = ops.xty_folds_masked

        def timed_update(*args, **kwargs):
            c0 = timers["check"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            update(*args, **kwargs)
            torch.cuda.synchronize()
            timers["stats"] += (time.perf_counter() - t1
                                - (timers["check"] - c0))

        def in_colblock(*args, **kwargs):
            inside.append(True)
            try:
                return colblock_call(*args, **kwargs)
            finally:
                inside.pop()

        def keep_first(x, z, onehot):
            out = masked(x, z, onehot)
            if inside and not first:
                # The first column-block launch against the plain version
                # on its own operands, at once (its timing excluded).
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                first["err"], first["scale"] = _compare(
                    f"phase 12's first column-block xty_folds_masked x="
                    f"{tuple(x.shape)} z={tuple(z.shape)} "
                    f"s={onehot.shape[1]}", out,
                    ref.xty_folds_masked(x, z, onehot), "float32")
                free()
                timers["check"] += time.perf_counter() - t1
            return out

        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        with _patched(
                (foldstats.FoldStatsAccumulator, "update", timed_update),
                (wstats._ColumnBlockUpdate, "__call__", in_colblock),
                (ops, "xty_folds_masked", keep_first),
                (torch.linalg, "eigh",
                 _timed(torch.linalg.eigh, timers, "eighs")),
                (foldstats, "eigenbasis_x_terms",
                 _timed(foldstats.eigenbasis_x_terms, timers, "scoring")),
                (foldstats, "validation_scores_from_terms",
                 _timed(foldstats.validation_scores_from_terms, timers,
                        "scoring")),
                (solver, "_project", _timed(solver._project, timers,
                                            "solve")),
                (solver, "_solve_projected",
                 _timed(solver._solve_projected, timers, "solve")),
                (solver, "fit_wholebrain",
                 _timed(solver.fit_wholebrain, timers, "fit_wholebrain"))):
            t0 = time.perf_counter()
            enc = BrainEncoder(cfg, device="cuda").fit(store=store)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        rep, ss, d = enc.report_, enc.stream_stats_, enc.report_.decision
        check_s = timers.pop("check")
        fit_s -= check_s
        solver_s = timers.pop("fit_wholebrain") - check_s
        # The estimator's own work around fit_wholebrain: moving W (p, t)
        # to the card for report_.
        to_card = fit_s - solver_s
        other = solver_s - sum(timers.values())
        print(f"[wholebrain] fit(store=) with device_memory_budget="
              f"{WB_BUDGET / 2**30:g} GiB, target_block={WB_TARGET_BLOCK}: "
              f"decision {d.solver}/{d.method} t_block {d.target_block} "
              f"kernel tier {d.use_pallas}; {ss['n_blocks']} blocks, t_pad "
              f"{ss['t_pad']}; launches {launches}; signatures "
              f"{ss['gram_compile_delta']}/{ss['colblock_compile_delta']}; "
              f"row_passes_x {ss['row_passes_x']} (X cache "
              f"{ss['x_cache_bytes'] / 1e9:.3f} GB); λ={rep.best_lambda[0]:g}")
        print(f"[wholebrain] fit {fit_s:.2f} s: stats pass "
              f"{timers['stats']:.2f} s, eighs {timers['eighs']:.2f} s, "
              f"scoring {timers['scoring']:.2f} s, Â and solve "
              f"{timers['solve']:.2f} s, W to the card {to_card:.2f} s, "
              f"the rest (read stall, Â scratch and W host copies and I/O) "
              f"{other:.2f} s; {ss['bytes_staged'] / 1e9:.2f}"
              f" GB staged, read_stall {ss['read_stall_s']:.3f} s, "
              f"compute_stall {ss['compute_stall_s']:.3f} s; peak device "
              f"memory {peak / 2**30:.2f} GiB [{card}]")
        check(d.method == "colblocked" and d.use_pallas
              and ss["t_pad"] == WB_TARGET_BLOCK, f"decision {d}, {ss}")
        check(ss["gram_compile_delta"] == 1 and ss["colblock_compile_delta"]
              == 1 and ss["row_passes_x"] == 1, f"stream stats {ss}")
        check(launches == {**dict.fromkeys(launches, 0),
                           "xty_folds_masked": want},
              f"launches {launches}, want {want} xty_folds_masked")
        check("err" in first, "no column-block launch was captured")
        print(f"[wholebrain] first column-block launch against "
              f"ref.xty_folds_masked on its operands: max abs err "
              f"{first['err']:.3e} (tol {REL_TOL:g}·max|plain|, max|plain| "
              f"{first['scale']:.4e}) [{card}]")
        check(float(rep.best_lambda[0]) in rep.lambdas, "λ not in the grid")
        check(tuple(rep.weights.shape) == (p, t), "W shape")
        check(bool(torch.isfinite(rep.weights).all()), "W non-finite")
        check(bool(np.isfinite(rep.cv_scores).all()), "CV curve non-finite")

        t0 = time.perf_counter()
        enc.save(str(root / "bundle"), weight_shards=len(blocks))
        save_s = time.perf_counter() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        print(f"[wholebrain] save: {len(blocks)} shards, "
              f"{wt_b / 1e9:.2f} GB in {save_s:.2f} s; fit + save "
              f"{fit_s + save_s:.2f} s; peak host RSS of the process (mapped "
              f"scratch pages included) "
              f"{rss / 1e9:.2f} GB [{card}]")
        bundle = EncoderBundle.open(str(root / "bundle"))
        shards = bundle.weight_shard_bounds()
        for i in (0, len(shards) - 1):
            lo, hi = shards[i]
            check(np.array_equal(bundle.load_weight_shard(i, mmap=True),
                                 rep.weights[:, lo:hi].cpu().numpy()),
                  f"reopened shard {i} [{lo}, {hi}) differs from W")
        print(f"[wholebrain] reopened shards 0 and {len(shards) - 1} "
              f"bitwise equal to the weights")
        # The first and the ragged last block against the unblocked
        # statistics solve of their columns at the fit's λ.
        lam = torch.tensor(rep.best_lambda[0], dtype=torch.float32,
                           device="cuda")
        factors = None
        for lo, hi in (blocks[0], blocks[-1]):
            stream = store.iter_chunks(CHUNK_ROWS, col_range=(lo, hi),
                                       prefetch=True, pin_memory=True)
            st = foldstats.compute_chunked(
                stream, n, k, chunk_rows=CHUNK_ROWS, use_pallas=True,
                device="cuda")
            if factors is None:
                G = st.G_total
                G.diagonal().add_(cfg.jitter)
                evals, Q = torch.linalg.eigh(G)
                factors = ridge.RidgeFactors(basis=Q, evals=evals,
                                             primal=True)
                del G
            W_un = ridge.solve(factors, st.C_total, lam).cpu().numpy()
            W_bl = rep.weights[:, lo:hi].cpu().numpy()
            del st
            free()
            dw = float(np.abs(W_bl - W_un).max())
            print(f"[wholebrain] block [{lo}, {hi}) against the unblocked "
                  f"solve of its columns: max|ΔW| {dw:.3e} (rtol 1e-4, "
                  f"atol 2e-4, max|W| {np.abs(W_un).max():.4e}) [{card}]")
            np.testing.assert_allclose(W_bl, W_un, rtol=1e-4, atol=2e-4)
        del enc, rep, factors
        free()
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)
    return launches["xty_folds_masked"]


def phase_wholebrain_parity(card: str) -> None:
    import numpy as np
    import torch
    from repro_torch.core import foldstats, ridge
    from repro_torch.data import fmri
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder, EncoderConfig
    from repro_torch.encoding.dispatch import resolve
    from repro_torch.encoding.estimator import EncodingReport
    from repro_torch.serving_encoders import EncoderBundle
    from repro_torch.wholebrain import BundleWriter, fit_wholebrain

    n, p, t = WB_SMALL["n"], WB_SMALL["p"], WB_SMALL["t"]
    rows, tb = WB_SMALL["chunk_rows"], WB_SMALL["t_block"]
    tol = dict(rtol=1e-4, atol=2e-4)
    # Under the resident set n·(p + t) but too small for even 2-wide
    # column blocks → the chunked tier; under 4·n·p → X is not cached.
    chunked_budget = n * (p + t) * 4 * 3 // 4
    spill_budget = 2 * n * p * 4
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_wb13_", dir=build))
    try:
        t0 = time.perf_counter()
        RunStore.create(str(root / "store"), n_folds=5).materialize_synthetic(
            fmri.SubjectSpec(n=n, p=p, t=t), seed=19, rows_per_run=RUN_ROWS,
            device="cuda")
        store = RunStore.open(str(root / "store"))
        cfg = EncoderConfig(chunk_rows=rows)
        kern = fit_wholebrain(store, cfg, t_block=tb, device="cuda",
                              scratch_dir=str(root))
        check(kern.block_bounds[-1] == (3 * tb, t)
              and kern.telemetry["use_pallas"], f"{kern.block_bounds}")
        # (a) the kernel tier against the plain tier.
        plain = fit_wholebrain(
            store, EncoderConfig(chunk_rows=rows, use_pallas=False),
            t_block=tb, device="cuda", scratch_dir=str(root))
        check(np.array_equal(kern.best_lambda, plain.best_lambda),
              f"λ kernel {kern.best_lambda} vs plain {plain.best_lambda}")
        np.testing.assert_allclose(kern.weights, plain.weights, **tol)
        np.testing.assert_allclose(kern.cv_scores, plain.cv_scores, **tol)
        # (b) global mode against the unblocked chunked tier.
        chunked = BrainEncoder(EncoderConfig(
            chunk_rows=rows, device_memory_budget=chunked_budget),
            device="cuda").fit(store=store)
        check(chunked.report_.decision.method == "chunked",
              f"decision {chunked.report_.decision}")
        check(float(chunked.report_.best_lambda[0]) == kern.best_lambda[0],
              f"λ chunked {chunked.report_.best_lambda} vs blocked "
              f"{kern.best_lambda}")
        np.testing.assert_allclose(kern.weights,
                                   chunked.weights_.cpu().numpy(), **tol)
        dw_c = float(np.abs(kern.weights
                            - chunked.weights_.cpu().numpy()).max())
        del chunked
        # (c) per-block mode against ridge_cv_from_stats on each block's
        # restricted statistics.
        per = fit_wholebrain(store, cfg, t_block=tb, lambda_mode="per_block",
                             device="cuda")
        stats = foldstats.compute_chunked(
            store.iter_chunks(rows), n, 5, chunk_rows=rows, use_pallas=True,
            device="cuda")
        for b, (lo, hi) in enumerate(per.block_bounds):
            sub = foldstats.FoldStats(
                G=stats.G, C=stats.C[:, :, lo:hi], xsum=stats.xsum,
                ysum=stats.ysum[:, lo:hi], ysq=stats.ysq[:, lo:hi],
                count=stats.count)
            rr = ridge.ridge_cv_from_stats(
                sub, cfg.ridge_cv_config("eigh", device="cuda"))
            check(per.best_lambda[b] == float(rr.best_lambda),
                  f"block {b}: λ {per.best_lambda[b]} vs "
                  f"{float(rr.best_lambda)}")
            np.testing.assert_allclose(per.weights[:, lo:hi],
                                       rr.weights.cpu().numpy(), **tol)
            np.testing.assert_allclose(per.cv_scores[b],
                                       rr.cv_scores.cpu().numpy(), **tol)
        del stats
        # (d) the spill path: a budget too small for the X cache.
        spill = fit_wholebrain(
            store, EncoderConfig(chunk_rows=rows,
                                 device_memory_budget=spill_budget),
            t_block=tb, device="cuda", scratch_dir=str(root))
        check(spill.telemetry["row_passes_x"] == len(spill.block_bounds)
              == 4 and kern.telemetry["row_passes_x"] == 1,
              f"row passes {spill.telemetry['row_passes_x']}, cached "
              f"{kern.telemetry['row_passes_x']}")
        check(np.array_equal(spill.best_lambda, kern.best_lambda)
              and np.array_equal(spill.weights, kern.weights),
              "spill path λ/W not bitwise equal to the cached run")
        # (e) shards streamed to a BundleWriter during the fit.
        decision = resolve(EncoderConfig(chunk_rows=rows, target_block=tb,
                                         device_memory_budget=spill_budget),
                           n, p, t, device="cuda")
        for dtype in ("float32", "bfloat16"):
            path = str(root / f"bundle_{dtype}")
            with BundleWriter(path, p=p, t=t, weight_dtype=dtype) as wr:
                res = fit_wholebrain(store, cfg, t_block=tb, writer=wr,
                                     collect=False, device="cuda")
                wr.commit(config=cfg, report=EncodingReport(
                    weights=None, best_lambda=res.best_lambda,
                    cv_scores=res.cv_scores, lambdas=cfg.lambdas,
                    decision=decision), lambda_by_target=res.lambda_by_target)
            b = EncoderBundle.open(path)
            want = torch.from_numpy(kern.weights).to(getattr(torch, dtype))
            if dtype == "bfloat16":     # as stored: the u16 bit patterns
                want = torch.from_numpy(
                    want.view(torch.int16).numpy().view(np.uint16))
            for i, (lo, hi) in enumerate(b.weight_shard_bounds()):
                check(np.array_equal(b.load_weight_shard(i),
                                     want[:, lo:hi].numpy()),
                      f"{dtype} shard {i} differs from the collected W")
            check(np.array_equal(
                b.load_arrays(["lambda_by_target"])["lambda_by_target"],
                kern.lambda_by_target), f"{dtype} lambda_by_target")
        print(f"[wholebrain-parity] n={n} p={p} t={t} chunk_rows={rows} "
              f"t_block={tb} ({len(kern.block_bounds)} blocks, tail "
              f"{t - 3 * tb}): kernel tier = plain tier (λ "
              f"{kern.best_lambda[0]:g}, max|ΔW| "
              f"{np.abs(kern.weights - plain.weights).max():.3e}), = "
              f"chunked tier (max|ΔW| {dw_c:.3e}); per-block λ "
              f"{per.best_lambda.tolist()} = ridge_cv_from_stats per block; "
              f"spill path ({spill.telemetry['row_passes_x']} X passes) "
              f"bitwise; BundleWriter f32/bf16 shards bitwise; "
              f"{time.perf_counter() - t0:.2f} s [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    env = phase_env()
    card = env["card"]
    phase_kernels_small()
    phase_backbone_kernels_small()
    phase_seed_kernels_small()
    rec = phase_kernels_full(card, reps=3)
    launches = {}
    launches["xty_folds"], heldout = phase_primal(card)
    launches["xty"] = phase_dual(card)
    phase_paths()
    launches["xty_folds_masked"] = phase_streamed(card)
    rec.update(phase_backbone_kernels_full(card, reps=3))
    phase_backbone_f32_paths(card)
    backbone = phase_backbone(card)
    launches.update(flash_attention=backbone["flash_attention"],
                    ssd_intra=backbone["ssd_intra"])
    seed_rec, launches["pearson_r"] = phase_seed_kernels_full(card, heldout,
                                                              reps=3)
    rec.update(seed_rec)
    del heldout
    launches["solve_lambda_grid"] = phase_seed_primal(card)
    phase_seed_dual(card)
    launches["xty_folds_masked"] += phase_wholebrain(card)
    phase_wholebrain_parity(card)
    csrc = "src/repro_torch/kernels/csrc/"
    where = {"xty_folds": ("split_engine.cu",
                           "src/repro/kernels/gram.py:158"),
             "xty": ("gram.cu", "src/repro/kernels/gram.py:72"),
             "xty_folds_masked": ("split_engine.cu",
                                  "src/repro/kernels/gram.py:233"),
             "flash_attention": ("flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:124"),
             "ssd_intra": ("ssd.cu", "src/repro/kernels/ssd.py:69"),
             "pearson_r": ("pearsonr.cu", "src/repro/kernels/pearsonr.py:71"),
             "solve_lambda_grid": ("split_engine.cu",
                                   "src/repro/kernels/ridge_solve.py:72")}
    kernels = [{"name": name, "route": "cuda", "source": csrc + src,
                "replaces": replaces, "launches": launches[name],
                **{k: rec[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms", "bound_f32_ms")
                   if k in rec[name]}}
               for name, (src, replaces) in where.items()]
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
