#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card (Hopper, sm_90a)

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
nvcc into ``build/kernels/``, then runs seventeen phases, each of which
raises (exit code 1) on a failed check (``--only 14,16`` runs the build
and just the listed phases, 6 and 12 to 17, and prints no result lines):

1. Environment: versions, TF32 switches (all off), card name and power
   limit, kernel build time (one nvcc per source, in parallel) and the
   compiler's register/spill report.
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
   and by the budgeted ``BrainEncoder.fit(store=)`` of the driver a lab
   runs, ``launch/encode.py --store`` (``main`` in this process, with
   ``--save-bundle`` and ``--trace-out``).  Each must launch
   ``xty_folds_masked`` 9 times (8,192-row chunks); the first must come out
   significant on the 7,689 held-out rows, the second must resolve to the
   ``chunked`` plan and equal the in-memory fit of the same rows.  The
   second runs with ``REPRO_OBS_STRICT=1``: the span table of its trace
   through ``launch/obs_report.py``, the fit root's coverage by its phase
   spans (at least 95%), and ``prefetch.stage`` against
   ``prefetch.wait``; its weights come from its bundle (``bundle.json``
   and ``report.json`` written, 29 MB besides the store).  Then the same
   budgeted fit called directly, through ``faultsim.wrap_store`` with
   transient faults planned on one shard mmap and two chunk reads: λ
   equal, W within rtol 1e-4/atol 2e-4 and λ, W and the CV curve bitwise
   equal to the driver's unfaulted fit, 9 launches and no new signature,
   ``io_retries{op}`` equal to the plan (1 ``store.mmap``, 2
   ``prefetch.read``); the driver's reloaded bundle predicts the held-out
   rows as this fit does.

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
    ``colblocked`` itself (17 blocks, the last of 2,661 targets).  The fit
    is killed and resumed: a child process (this script with a private
    flag) fits with a ``FitJournal`` wrapped in
    ``faultsim.KillAfterBlock`` and must exit 42 right after block 8
    commits (20 launches); its scratch is deleted, and this process
    resumes from the journal under a tracer with ``REPRO_OBS_STRICT=1``:
    9 blocks replayed, 8 streamed (16 launches: 36 in all, 2 chunks × (the
    X-only pass + 17 blocks)), one new column-block signature, one pass
    over X (the cache rebuilt), the journal deleted; the child's and the
    resume's seconds beside PR 19's uninterrupted 310.44 s, the span
    table, and the split of ``fit.wholebrain`` by its spans.  The resume's
    first column-block launch is held against the plain
    version on its operands, the first and the ragged last block's
    weights against the unblocked statistics solve of their columns (rtol
    1e-4, atol 2e-4).  Then ``save`` (17 shards, 17.4 GB), reopened with
    ``EncoderBundle.open``: two shards, the last among them, bitwise equal
    to the weights.  Prints the fit's time split (stats pass, eighs,
    scoring, Â and solve, the rest; save), peak device memory, staging.
    Then one 128-row wave through ``EncoderService.predict_columns`` over
    columns 10,000–30,000 of the saved bundle, under a registry budget
    that holds only the two weight shards they touch (2 shard loads, no
    whole-bundle residency), held against ``X·W[:, window]``.
    Free disk under ``build/`` (~31 GB: the store, then the bundle), free
    space in ``/dev/shm`` (~42 GB: the 22.7 GB journal and the Â scratch,
    kept off the disk because the card's machine caps a run's disk writes
    at 45 GiB) and host RAM (~62 GB) are checked first; everything is
    deleted at the end.
13. The tier's parity on the card at n=4,000, p=2,048, t=6,728, 1,024-row
    chunks, t_block=2,048: kernel tier = plain tier, global mode = the
    unblocked ``chunked`` tier, per-block mode = ``ridge_cv_from_stats``
    per block, the spill path (X re-streamed per block) bitwise equal to
    the cached run, and ``BundleWriter`` shards (f32, bf16) bitwise equal
    to the collected weights (bf16 rounded to nearest even).  Then, in both
    λ modes, a child killed by ``KillAfterBlock`` after block 1 and a
    resume in this process: λ, CV curve, W and ``lambda_by_target``
    bitwise equal to the uninterrupted fit; a journal of another
    ``t_block`` is refused (``JournalError``).
14. The MOR baseline at the ``whole_brain_mor`` width (n=1,000,
    p=16,384; t cut from 2,000 to 256): ``resolve`` gives plan ``mor``,
    method ``dual``, one target shard; ``BrainEncoder(solver="mor").fit``
    must launch ``xty`` t times the count of one target's fit, equal the
    plain tier (rtol 1e-4, atol 2e-4), and ``mor_fit_taskwise`` must equal
    it bitwise on 64 targets.  Prints per-target seconds, the mutualised
    ``ridge_cv`` on the same targets and the measured MOR/mutualised
    factor beside ``complexity.mor_overhead_factor``.
15. Banded ridge on the ``parcels`` cell (n=69,202, p=16,384 as the
    paper's 4 TR lags × 4,096 VGG16-FC2 features, t=444, 3 folds; 4 band
    candidates instead of 16): dispatch picks ``banded``, W finite, the
    winning band λ among the drawn candidates, no kernel launched; the
    fit split into Grams, eighs and the rest; then equal band λ against
    ``ridge.solve`` on the full Gram (rtol 1e-4, atol 2e-4).
16. Serving: four parcels-width bundles (seeded W and standardizers,
    29 MB of W each) written by the port, a 64-request mixed trace
    (``make_mixed_trace``) replayed through ``FleetFrontend`` →
    ``EncoderService(wave_buckets=(32, 128), score_slots=4)`` over a
    registry whose budget holds two bundles: packed = ``reference_serve``
    bitwise (predictions and r), a row's bits equal at every offset of
    every bucket, ``compile_count`` = buckets flown, evictions > 0,
    predictions within rtol 1e-4/atol 2e-4 of a float64 host product,
    served r within 1e-4 of ``ops.pearson_r``; rows/s and wave times by
    bucket with the Pearson row loop's share.  Both replays run with
    ``REPRO_OBS_STRICT=1``; a second replay on a fresh stack runs under a
    tracer: the host time split by ``serve.wave.build``,
    ``serve.wave.execute``, ``registry.load`` and ``fleet.flush``, the
    counters ``waves``, ``wave_rows``, ``wave_pad_rows`` and
    ``admitted_rows`` equal to ``ServiceStats``, and its results bitwise
    equal to the untraced replay's.
17. The drivers, from their command lines (``--only 17`` runs it alone).
    (a) ``ssd_intra`` at the encode driver's 16-token chunk (N=512, Q=16,
    H=80, P=64; f32 and bf16 operands) against its plain version, then in
    this process ``encode.main`` with ``--backbone zamba2-2.7b --n 8192
    --targets 444`` (full width and depth: X (8,192, 2,560)), which must
    launch ``ssd_intra`` once per Mamba layer (54) and ``xty_folds`` once
    and come out significant, and with the defaults (``--backbone vgg16``,
    n 512, t 256, p 128: one ``xty_folds``); each run's ``xty_folds``
    launch is held against ``ref.xty_folds`` on its own operands.  (b) ``python -m
    repro_torch.launch.wholebrain --device cuda`` at the reference's full
    shape (n 1,024, p 128, t 262,144, 8 folds, t_block 16,384 and the
    ragged 20,480; the A/B at 512 × 128 × 2,048; the crash gate killed
    after block 1) with per-phase traces; every gate of the driver, the
    A/B's ``kernel_tier`` ``cuda`` with λ equal, the fit trace's coverage
    through ``launch/obs_report.py``; fit seconds, device and RSS peaks
    (and the RSS right after CUDA initialisation) under ``--cap-mb``, the
    A/B's roofline placement at the H100's peaks; the children's launches
    come back in their result lines.  Then both fits again in this process
    on the driver's store with its configuration, every
    ``xty_folds_masked`` launch (68 and 56) held against
    ``ref.xty_folds_masked`` on its own operands, λ equal to the driver's
    and W bitwise equal to the driver's bundle (these launches are checks
    and do not count).  ~1.3 GB of disk under ``build/``, deleted at the
    end.  (c) ``python -m repro_torch.launch.serve`` on the
    checked-in trace (6 bundles, p 64, t 96), then with two workers and
    worker 0 killed after its first flush: the lease gate and the drain.

The last two lines are the kernels' JSON record and the ``{"ok": true, ...}``
line.  Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
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
# Phase 12's column serve: one 128-row wave over a 20,000-column window
# that spans two of the bundle's 17 weight shards.
WB_WINDOW = (10_000, 30_000)
# Phase 14: MOR pays one RidgeCV per target, so the whole_brain_mor cell's
# 2,000 targets are cut to the first 256; the taskwise loop is held
# bitwise against mor_fit on the first 64 of them.
MOR_TARGETS, MOR_TASKWISE = 256, 64
# Phase 15: banded ridge on the parcels cell, the paper's VGG16-FC2 at
# 4 TR lags (bands of 4,096), 3 folds; 4 band candidates instead of the
# default 16 (each candidate pays 3 eighs of 16,384², ~2.5 s each).
BANDS = (4096,) * 4
BANDED_CANDIDATES = 4
# Phase 16: four parcels-width bundles served through the fleet tier.
SERVE_BUCKETS = (32, 128)
SERVE_MODELS, SERVE_REQUESTS, SERVE_SLOTS = 4, 64, 4
# Served r (five f32 sums chained over a request's rows, finalised in f64)
# against the pearson_r kernel on the same rows (its sums in another
# order, finalised in f32): summation order and the f32 finalise alone.
PEARSON_TOL = 1e-4
# Phases 6, 12 and 13: the traced fit's root must attribute this share of
# its wall time to its phase spans (the reference's coverage gate); the
# whole-brain fit is killed after this block and resumed (exit code of
# faultsim.KillAfterBlock); phase 12's uninterrupted fit in PR 19's run.
COVERAGE_GATE = 0.95
WB_KILL_AFTER, WB13_KILL_AFTER, KILLED = 8, 1, 42
WB_UNINTERRUPTED_S = 310.44
# Phase 17: the encode driver's backbone mode at zamba2-2.7b's full width
# and depth (n rows of 16-token sequences: launch/encode.py's seq), and the
# whole-brain driver's cap (--cap-mb): 1,280 MB, the cap of the
# reference's own run at this shape (BENCH_wholebrain.json, whose fits
# peaked at 1,119.7 and 1,256.5 MB of RSS), still below the ~1,408 MB the
# unblocked path needs.  On the card it caps the device peak and the RSS a
# child adds after initialising the CUDA stack (5,038 MB of RSS on its
# own on the card's host, which counts mapped library pages as resident).
DRV_BACKBONE, DRV_N, DRV_SEQ = "zamba2-2.7b", 8192, 16
WB_DRIVER_CAP_MB = 1280.0


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


@contextlib.contextmanager
def _strict():
    """``REPRO_OBS_STRICT=1`` (the recompile sentinel armed) for the block
    only; the previous value is restored."""
    saved = os.environ.get("REPRO_OBS_STRICT")
    os.environ["REPRO_OBS_STRICT"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("REPRO_OBS_STRICT", None)
        else:
            os.environ["REPRO_OBS_STRICT"] = saved


@contextlib.contextmanager
def _traced():
    """A tracer installed for the block only; yields it."""
    from repro_torch import obs
    tracer = obs.install()
    try:
        yield tracer
    finally:
        obs.uninstall()


def _span_s(events, name: str, **attrs) -> tuple[int, float]:
    """(count, total seconds) of the spans called ``name`` whose attributes
    include ``attrs``."""
    durs = [e["dur_us"] for e in events
            if e["name"] == name and not e.get("instant")
            and all(e["attrs"].get(k) == v for k, v in attrs.items())]
    return len(durs), sum(durs) / 1e6


def _print_spans(tag: str, events, card: str) -> tuple[dict, float]:
    """The per-span table of ``launch/obs_report.py`` and the root's
    coverage by its direct children."""
    from repro_torch.launch import obs_report
    for line in obs_report.render(events).splitlines():
        print(f"[{tag}]   {line}")
    root, cov = obs_report.root_coverage(events)
    print(f"[{tag}] spans on the host clock [{card}]")
    return root, cov


def _counter_deltas(before: dict, prefix: str) -> dict:
    from repro_torch import obs
    after = obs.snapshot()["counters"]
    return {k: after[k] - before.get(k, 0.0) for k in after
            if k.startswith(prefix) and after[k] != before.get(k, 0.0)}


class _RecordBlocks:
    """``FitJournal`` wrapper of the killed child: after each block commits,
    write the launches and seconds so far to ``out`` (the kill that follows
    leaves no later moment to report them)."""

    def __init__(self, journal, out: str, t0: float):
        self._journal, self._out, self._t0 = journal, out, t0

    def put_block(self, bi: int, **kwargs) -> None:
        self._journal.put_block(bi, **kwargs)
        with open(self._out, "w") as f:
            json.dump({"block": bi, "launches": _counters(),
                       "seconds": time.perf_counter() - self._t0}, f)

    def __getattr__(self, name):
        return getattr(self._journal, name)


def _kill_child(spec_path: str) -> int:
    """The child process of phases 12 and 13: fit ``spec["store"]`` with a
    ``FitJournal`` wrapped in ``faultsim.KillAfterBlock``, so the process
    ends with ``os._exit(42)`` right after block ``spec["kill_after"]``
    commits.  Phase 12 fits through ``BrainEncoder.fit(store=)``, phase 13
    through ``fit_wholebrain``."""
    import torch
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder, EncoderConfig
    from repro_torch.kernels import _build
    from repro_torch.resilience import FitJournal
    from repro_torch.resilience.faultsim import KillAfterBlock
    from repro_torch.wholebrain import solver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(spec_path) as f:
        spec = json.load(f)
    dev = spec["device"]
    if dev == "cuda":
        _build.load()
    tempfile.tempdir = spec["tmpdir"]
    store = RunStore.open(spec["store"])
    cfg = EncoderConfig(**spec["cfg"])
    kw = dict(t_block=spec["t_block"], lambda_mode=spec["lambda_mode"])
    sig = solver.journal_signature(store, cfg, device=dev, **kw)
    t0 = time.perf_counter()
    journal = KillAfterBlock(
        _RecordBlocks(FitJournal.attach(spec["journal"], sig), spec["out"],
                      t0), spec["kill_after"], exit_code=KILLED)
    _reset_counters()
    if spec["route"] == "encoder":
        fit = functools.partial(solver.fit_wholebrain, journal=journal)
        with _patched((solver, "fit_wholebrain", fit)):
            BrainEncoder(cfg, device=dev).fit(store=store)
    else:
        solver.fit_wholebrain(store, cfg, journal=journal, device=dev,
                              scratch_dir=spec["tmpdir"], **kw)
    print("chip_smoke child: the fit ended without being killed",
          file=sys.stderr)
    return 1


def _run_killed_child(tag: str, spec: dict, card: str) -> dict:
    """Run ``_kill_child`` in a new process (strict mode on); it must exit
    with ``KILLED``.  Returns what it recorded, with its wall seconds."""
    path = Path(spec["tmpdir"]) / "child_spec.json"
    Path(spec["tmpdir"]).mkdir(parents=True, exist_ok=True)
    spec = dict({"device": "cuda"}, **spec,
                out=str(Path(spec["tmpdir"]) / "child_record.json"))
    path.write_text(json.dumps(spec))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--kill-child",
         str(path)], env=dict(os.environ, REPRO_OBS_STRICT="1"),
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if out.returncode != KILLED:
        print(out.stdout[-4000:])
        print(out.stderr[-4000:], file=sys.stderr)
    check(out.returncode == KILLED,
          f"{tag}: the killed child exited {out.returncode}, want {KILLED}")
    rec = json.loads(Path(spec["out"]).read_text())
    check(rec["block"] == spec["kill_after"],
          f"{tag}: the child's last block {rec['block']}")
    print(f"[{tag}] child killed after block {spec['kill_after']} (exit "
          f"{out.returncode}): {wall:.2f} s wall, {rec['seconds']:.2f} s in "
          f"its fit; launches {rec['launches']} [{card}]")
    return dict(rec, wall=wall)


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
    from repro_torch import obs
    from repro_torch.core import complexity
    from repro_torch.data import fmri
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder, EncoderConfig, pipeline
    from repro_torch.encoding.estimator import EncodingReport
    from repro_torch.kernels import gram
    from repro_torch.launch import obs_report
    from repro_torch.resilience import FaultPolicy
    from repro_torch.resilience import faultsim

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

        # (b) the budgeted fit(store=) through the driver a lab runs,
        # ``launch/encode.py --store``, in this process: chunked, traced,
        # with the recompile sentinel armed; its weights from its bundle.
        budget = 4 << 30
        cfg_b = EncoderConfig(device_memory_budget=budget)
        bundle = os.path.join(root, "driver_bundle")
        trace = os.path.join(root, "driver_trace.jsonl")
        with _strict():
            out, launches_b, fit_s = _encode_in_process(
                "encode", ["--store", root, "--budget-mb",
                             str(budget / 2**20), "--save-bundle", bundle,
                             "--trace-out", trace, "--device", "cuda"], card,
                phase="streamed")
        for name in ("bundle.json", "report.json"):
            check(os.path.exists(os.path.join(bundle, name)),
                  f"encode --save-bundle wrote no {name}")
        with open(os.path.join(bundle, "report.json")) as f:
            rep_b = EncodingReport.from_json(f.read())
        d = rep_b.decision
        print(f"[streamed] encode --store with device_memory_budget="
              f"{budget / 2**30:g} GiB (resident set "
              f"{store.nbytes_resident() / 2**30:.2f} GiB): decision "
              f"{d.solver}/{d.method} kernel tier {d.use_pallas}; launches "
              f"{launches_b}; {fit_s:.2f} s traced, REPRO_OBS_STRICT=1 "
              f"[{card}]")
        check(d.method == "chunked" and d.use_pallas
              and "method=chunked" in out, f"budgeted decision {d}")
        check(launches_b["xty_folds_masked"] == n_chunks
              and sum(launches_b.values()) == n_chunks,
              f"encode --store launches {launches_b}, want {n_chunks} masked")
        events = obs_report.load_events(trace)
        root_ev, cov = _print_spans("streamed", events, card)
        n_st, stage_s = _span_s(events, "prefetch.stage")
        n_wt, wait_s = _span_s(events, "prefetch.wait")
        print(f"[streamed] root {root_ev['name']!r} {root_ev['dur_us'] / 1e6:.3f}"
              f" s, {100 * cov:.1f}% attributed to its phases (gate "
              f"{100 * COVERAGE_GATE:.0f}%); read side: prefetch.stage "
              f"{stage_s:.3f} s in {n_st} staging copies (reader thread, "
              f"memmap page-in + copy into pinned buffers) against "
              f"prefetch.wait {wait_s:.3f} s in {n_wt} waits (the fit "
              f"blocked on the reader) [{card}]")
        check(root_ev["name"] == "fit" and cov >= COVERAGE_GATE,
              f"fit root coverage {cov:.3f} < {COVERAGE_GATE}")
        check(n_st == n_chunks, f"{n_st} prefetch.stage spans")
        loaded = BrainEncoder.load(bundle, device="cuda")
        W_s, lam_s = loaded.weights_.cpu(), rep_b.best_lambda[0]
        cv_s = rep_b.cv_scores

        # (c) the same budgeted fit(store=), called directly, through
        # faultsim.wrap_store, with transient faults planned on a shard
        # mmap and on two chunk reads: retried (virtual-time backoff),
        # bitwise the driver's fit, no new signature.
        store.fault_policy = FaultPolicy(max_attempts=3,
                                         seed=6).with_virtual_time()
        inj = faultsim.FaultInjector(seed=6)
        inj.plan("store.mmap", 1)
        inj.plan("store.chunk", 2)
        inj.plan("store.chunk", 7)
        before = obs.snapshot()["counters"]
        gram.reset_launches()
        with _strict():
            t0 = time.perf_counter()
            enc = BrainEncoder(cfg_b, device="cuda").fit(
                store=faultsim.wrap_store(store, inj))
            torch.cuda.synchronize()
            fault_s = time.perf_counter() - t0
        store.fault_policy = None
        launches_c = dict(gram.LAUNCHES)
        retries = _counter_deltas(before, "io_retries")
        giveups = _counter_deltas(before, "io_giveups")
        fired = {op: inj.fired(op) for op in ("store.mmap", "store.chunk")}
        W_c = enc.weights_.cpu()
        dw = float((W_c - W_s).abs().max())
        tol = 2e-4 + 1e-4 * float(W_c.abs().max())
        same = (torch.equal(W_c, W_s)
                and enc.report_.best_lambda[0] == lam_s
                and np.array_equal(enc.report_.cv_scores, cv_s))
        print(f"[streamed] fit(store=) under injected faults {fired}: "
              f"{retries} retried, {giveups or 'no'} give-ups; launches "
              f"{launches_c}; new signatures "
              f"{enc.stream_stats_['compile_count']}; {fault_s:.2f} s "
              f"[{card}]")
        print(f"[streamed] the driver against the faulted budgeted "
              f"fit(store=): λ {lam_s:g} vs {enc.report_.best_lambda[0]:g}, "
              f"max|ΔW| {dw:.3e} (limit {tol:.3e} = 2e-4 + 1e-4·max|W|); λ, "
              f"W and CV curve bitwise equal: {same} [{card}]")
        check(fired == {"store.mmap": 1, "store.chunk": 2}, f"fired {fired}")
        check(retries == {"io_retries{op=store.mmap}": 1.0,
                          "io_retries{op=prefetch.read}": 2.0} and not giveups,
              f"retries {retries}, give-ups {giveups}")
        check(launches_c["xty_folds_masked"] == n_chunks
              and enc.stream_stats_["compile_count"] == 0,
              f"faulted fit launches {launches_c}, "
              f"{enc.stream_stats_['compile_count']} new signatures")
        check(enc.report_.best_lambda[0] == lam_s,
              f"λ driver {lam_s} != budgeted fit {enc.report_.best_lambda[0]}")
        check(np.isfinite(dw) and dw <= tol, f"driver max|ΔW| {dw} > {tol}")
        check(same, "the faulted fit differs from the driver's unfaulted one")
        # The driver's bundle predicts the held-out rows as the fit does.
        got, want = loaded.predict(X_test), enc.predict(X_test)
        dp = float((got - want).abs().max())
        ptol = 2e-4 + 1e-4 * float(want.abs().max())
        print(f"[streamed] the driver's bundle against the fit on the "
              f"{X_test.shape[0]} held-out rows: max|Δ| {dp:.3e} (limit "
              f"{ptol:.3e}; bitwise {bool(torch.equal(got, want))}) [{card}]")
        check(np.isfinite(dp) and dp <= ptol, f"bundle predictions max|Δ| "
              f"{dp} > {ptol}")
        del enc, loaded, got, want, W_c
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
    return launches["xty_folds_masked"] + launches_b["xty_folds_masked"]


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
    from repro_torch.resilience import FitJournal
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
    # Launches: the killed child makes the X-only pass and blocks 0..8 (one
    # launch per chunk each, block 0's riding the X-only pass's stream); the
    # resume streams the other 8 blocks — together an uninterrupted fit's.
    want = n_chunks * (1 + len(blocks))
    want_child = n_chunks * (2 + WB_KILL_AFTER)
    n_replayed = WB_KILL_AFTER + 1
    # Resources, reckoned first.  On disk under build/: the store, then the
    # bundle.  In RAM: the fit's journal (the X-only Grams and every
    # block's Â) and Â scratch go to /dev/shm, not the disk: the card's
    # machine caps what one run writes to its disk at 45 GiB, and the
    # store, the bundle and phase 6's store take ~34 GB of it.  Both are
    # deleted when the fit ends (the killed child's scratch before the
    # resume).  On the host the fit holds them beside the collected W;
    # save() then copies W.
    store_b, wt_b = n * (p + t) * 4, p * t * 4
    journal_b = k * p * p * 4 + wt_b
    disk_need = store_b + wt_b + (2 << 30)
    shm_need = journal_b + wt_b + (2 << 30)
    ram_need = journal_b + 2 * wt_b + n * p * 4 + (4 << 30)
    build, shm = ROOT / "build", Path("/dev/shm")
    build.mkdir(exist_ok=True)
    disk_free, ram_free = shutil.disk_usage(build).free, _mem_available()
    shm_free = shutil.disk_usage(shm).free if shm.is_dir() else 0
    print(f"[wholebrain] n={n} p={p} t={t}: store {store_b / 1e9:.2f} GB "
          f"and bundle {wt_b / 1e9:.2f} GB on disk (need "
          f"{disk_need / 1e9:.1f} GB, {disk_free / 1e9:.1f} GB free under "
          f"{build}); journal {journal_b / 1e9:.2f} GB and Â scratch "
          f"{wt_b / 1e9:.2f} GB in {shm} (need {shm_need / 1e9:.1f} GB, "
          f"{shm_free / 1e9:.1f} GB free); host RAM need "
          f"{ram_need / 1e9:.1f} GB, {ram_free / 1e9:.1f} GB available")
    check(disk_free > disk_need,
          f"phase 12 needs {disk_need / 1e9:.1f} GB of disk under {build} "
          f"(the store, then the bundle), which has {disk_free / 1e9:.1f} "
          f"GB free: free disk space and rerun")
    check(shm_free > shm_need,
          f"phase 12 needs {shm_need / 1e9:.1f} GB free in {shm} for "
          f"the journal and the Â scratch, {shm_free / 1e9:.1f} GB free")
    check(ram_free > ram_need,
          f"phase 12 needs {ram_need / 1e9:.1f} GB of host RAM (the "
          f"journal, the scratch and the collected W), "
          f"{ram_free / 1e9:.1f} GB available: free memory and rerun")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_wb_", dir=build))
    fast = Path(tempfile.mkdtemp(prefix="chip_smoke_wb_", dir=shm))
    (fast / "tmp").mkdir()
    saved_tempdir = tempfile.tempdir
    try:
        # The fit's scratch goes to the default temporary directory: keep
        # it in /dev/shm, checked above.
        tempfile.tempdir = str(fast / "tmp")
        t0 = time.perf_counter()
        RunStore.create(str(root / "store"), n_folds=k).materialize_synthetic(
            fmri.SubjectSpec(n=n, p=p, t=t), seed=18, rows_per_run=RUN_ROWS,
            device="cuda")
        store = RunStore.open(str(root / "store"))
        write_s = time.perf_counter() - t0
        print(f"[wholebrain] store: {len(store.runs)} runs of {RUN_ROWS} "
              f"rows written by materialize_synthetic in {write_s:.2f} s")
        free()

        # A child process fits through BrainEncoder.fit(store=) with a
        # journal and is killed right after block 8 commits; its scratch
        # is deleted, and this process resumes from the journal.
        jdir = fast / "journal"
        # The child's fit peaks at ~53 GiB of the card (PR 19's in-process
        # fit), beside what this process still holds.
        card_free = torch.cuda.mem_get_info()[0]
        print(f"[wholebrain] before the child this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the "
              f"card has {card_free / 2**30:.2f} GiB free")
        check(card_free > 56 << 30, f"the child needs ~56 GiB of the card, "
              f"{card_free / 2**30:.2f} GiB free")
        child = _run_killed_child("wholebrain", dict(
            store=str(root / "store"), journal=str(jdir),
            tmpdir=str(fast / "child_tmp"), kill_after=WB_KILL_AFTER,
            route="encoder", t_block=WB_TARGET_BLOCK, lambda_mode="global",
            cfg=dict(device_memory_budget=WB_BUDGET,
                     target_block=WB_TARGET_BLOCK, chunk_rows=CHUNK_ROWS)),
            card)
        check(child["launches"].get("xty_folds_masked") == want_child,
              f"child launches {child['launches']}, want {want_child}")
        ledger = json.loads((jdir / "ledger.json").read_text())
        journal_size = sum(f.stat().st_size for f in jdir.iterdir())
        scratch_size = sum(f.stat().st_blocks * 512
                           for f in (fast / "child_tmp").rglob("*")
                           if f.is_file())
        print(f"[wholebrain] journal after the kill: X statistics "
              f"{ledger['xstats']}, blocks {sorted(map(int, ledger['blocks']))}"
              f", {journal_size / 1e9:.2f} GB; the child's scratch "
              f"{scratch_size / 1e9:.2f} GB deleted before the resume")
        check(ledger["xstats"] and set(map(int, ledger["blocks"]))
              == set(range(n_replayed)), f"ledger blocks {ledger['blocks']}")
        shutil.rmtree(fast / "child_tmp")

        timers = dict.fromkeys(("stats", "check", "eighs", "scoring",
                                "solve", "journal", "fit_wholebrain"), 0.0)
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
        resume = functools.partial(solver.fit_wholebrain, journal=str(jdir))
        with _strict(), _traced() as tracer, _patched(
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
                *((FitJournal, m, _timed(getattr(FitJournal, m), timers,
                                         "journal"))
                  for m in ("put_block", "load_block", "load_xstats",
                            "finish")),
                (solver, "fit_wholebrain",
                 _timed(resume, timers, "fit_wholebrain"))):
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
        print(f"[wholebrain] resumed fit {fit_s:.2f} s: stats pass "
              f"{timers['stats']:.2f} s, eighs {timers['eighs']:.2f} s, "
              f"scoring {timers['scoring']:.2f} s, Â and solve "
              f"{timers['solve']:.2f} s, journal reads and writes "
              f"{timers['journal']:.2f} s, W to the card {to_card:.2f} s, "
              f"the rest (read stall, Â scratch and W host copies and I/O) "
              f"{other:.2f} s; {ss['bytes_staged'] / 1e9:.2f}"
              f" GB staged, read_stall {ss['read_stall_s']:.3f} s, "
              f"compute_stall {ss['compute_stall_s']:.3f} s; peak device "
              f"memory {peak / 2**30:.2f} GiB [{card}]")
        print(f"[wholebrain] a crash after block {WB_KILL_AFTER}: the killed "
              f"child {child['wall']:.2f} s (its fit {child['seconds']:.2f} "
              f"s) + the resume {fit_s:.2f} s = "
              f"{child['wall'] + fit_s:.2f} s, against the uninterrupted "
              f"fit's {WB_UNINTERRUPTED_S} s (PR 19's run) [{card}]")
        events = tracer.events()
        _print_spans("wholebrain", events, card)
        n_rb, replay_s = _span_s(events, "wholebrain.block", replayed=True)
        n_b, block_all_s = _span_s(events, "wholebrain.block")
        _, wb_s = _span_s(events, "fit.wholebrain")
        _, x_s = _span_s(events, "wholebrain.xstats")
        _, eigh_s = _span_s(events, "fit.eigh")
        _, solve_s = _span_s(events, "fit.solve")
        streamed_s = block_all_s - replay_s
        in_blocks = streamed_s - timers["stats"] - timers["scoring"]
        print(f"[wholebrain] fit.wholebrain {wb_s:.2f} s = X statistics "
              f"replayed {x_s:.2f} s + fit.eigh {eigh_s:.2f} s + "
              f"{n_rb} replayed blocks {replay_s:.2f} s + {n_b - n_rb} "
              f"streamed blocks {streamed_s:.2f} s (of which stats pass and "
              f"scoring {timers['stats'] + timers['scoring']:.2f} s, the "
              f"rest {in_blocks:.2f} s: Â projection and its host copy, the "
              f"scratch and journal writes, read stall) + fit.solve "
              f"{solve_s:.2f} s + unattributed "
              f"{wb_s - x_s - eigh_s - block_all_s - solve_s:.2f} s [{card}]")
        check(d.method == "colblocked" and d.use_pallas
              and ss["t_pad"] == WB_TARGET_BLOCK, f"decision {d}, {ss}")
        check(ss["resumed"] and ss["blocks_replayed"] == n_replayed
              and ss["blocks_streamed"] == len(blocks) - n_replayed
              and n_rb == n_replayed and n_b == len(blocks),
              f"resume telemetry {ss}, {n_rb}/{n_b} block spans")
        check(not jdir.exists(), "the finished fit left its journal")
        # The resume makes no X-only pass: one new column-block signature,
        # none for the X-only update, one pass over X (the cache rebuilt
        # by the first streamed block).
        check(ss["gram_compile_delta"] == 0 and ss["colblock_compile_delta"]
              == 1 and ss["row_passes_x"] == 1, f"stream stats {ss}")
        check(launches == {**dict.fromkeys(launches, 0),
                           "xty_folds_masked": want - want_child},
              f"launches {launches}, want {want - want_child} "
              f"xty_folds_masked")
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
        del factors
        free()
        _serve_columns(card, str(root / "bundle"), rep.weights)
        del enc, rep
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(fast, ignore_errors=True)
    return launches["xty_folds_masked"] + want_child


def _serve_columns(card: str, path: str, W) -> None:
    """Phase 12's whole-brain column serve: one 128-row wave through
    ``EncoderService.predict_columns`` over ``WB_WINDOW`` of the saved
    bundle, under a registry budget that holds the two touched weight
    shards and nothing more — shard-level residency, never the 17 GB
    bundle — held against ``X·W[:, window]`` on the card."""
    import numpy as np
    import torch
    from repro_torch.serving_encoders import (EncoderBundle,
                                              EncoderRegistry,
                                              EncoderService)
    from repro_torch.serving_encoders.registry import (bundle_resident_bytes,
                                                       shard_resident_bytes)

    lo, hi = WB_WINDOW
    rows = SERVE_BUCKETS[-1]
    bundle = EncoderBundle.open(path)
    p = bundle.shape[0]
    bounds = bundle.weight_shard_bounds()
    touched = bundle.shards_for_columns(lo, hi)
    check(len(touched) == 2, f"window {WB_WINDOW} touches shards {touched}")
    budget = sum(shard_resident_bytes(bundle, bounds[i][1] - bounds[i][0],
                                      rows) for i in touched)
    check(budget < bundle_resident_bytes(bundle, rows),
          "the column-serve budget would hold the whole bundle")
    reg = EncoderRegistry(device_memory_budget=budget, device="cuda")
    reg.add("wholebrain", path)
    svc = EncoderService(reg, wave_buckets=SERVE_BUCKETS)
    g = torch.Generator("cuda").manual_seed(12)
    Xq = torch.randn(rows, p, device="cuda", generator=g)
    Xh = Xq.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = svc.predict_columns("wholebrain", Xh, (lo, hi))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = svc.predict_columns("wholebrain", Xh, (lo, hi))
    hit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = reg.stats()
    check(st["shard_loads"] == 2 and st["loaded"] == 0
          and st["shard_hits"] == 2, f"registry {st}")
    check(np.array_equal(out, again), "a resident re-serve differs")
    want = torch.matmul(Xq, W[:, lo:hi]).cpu().numpy()
    err = float(np.abs(out - want).max())
    print(f"[wholebrain-serve] predict_columns: {rows} rows × columns "
          f"[{lo}, {hi}) over shards {touched} ({[bounds[i] for i in touched]})"
          f" under a {budget / 2**30:.2f} GiB budget (whole bundle "
          f"{bundle.weight_nbytes() / 2**30:.2f} GiB): first call "
          f"{first_s * 1e3:.1f} ms (2 mmap'd shard loads), resident "
          f"{hit_s * 1e3:.1f} ms; registry {st}; max|Δ| vs X·W[:, window] "
          f"{err:.3e} (rtol 1e-4, atol 2e-4); peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]")
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=2e-4)
    del reg, svc
    free()


def phase_wholebrain_parity(card: str) -> None:
    import numpy as np
    import torch
    from repro_torch.core import foldstats, ridge
    from repro_torch.data import fmri
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder, EncoderConfig
    from repro_torch.encoding.dispatch import resolve
    from repro_torch.encoding.estimator import EncodingReport
    from repro_torch.resilience import FitJournal, JournalError
    from repro_torch.serving_encoders import EncoderBundle
    from repro_torch.wholebrain import BundleWriter, fit_wholebrain
    from repro_torch.wholebrain.solver import journal_signature

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
        # (f) crash and resume: a child killed by KillAfterBlock right after
        # block 1 commits, then a resume in this process, bitwise equal to
        # the uninterrupted fits above, in both λ modes.
        for mode, whole in (("global", kern), ("per_block", per)):
            jdir = root / f"journal_{mode}"
            child = _run_killed_child(f"wholebrain-parity {mode}", dict(
                store=str(root / "store"), journal=str(jdir),
                tmpdir=str(root / f"child_{mode}"),
                kill_after=WB13_KILL_AFTER, route="solver", t_block=tb,
                lambda_mode=mode, cfg=dict(chunk_rows=rows)), card)
            shutil.rmtree(root / f"child_{mode}")
            with _strict():
                t1 = time.perf_counter()
                res = fit_wholebrain(store, cfg, t_block=tb,
                                     lambda_mode=mode, journal=str(jdir),
                                     device="cuda", scratch_dir=str(root))
                resume_s = time.perf_counter() - t1
            tel = res.telemetry
            same = {key: np.array_equal(getattr(res, key),
                                        getattr(whole, key))
                    for key in ("best_lambda", "cv_scores", "weights",
                                "lambda_by_target")}
            print(f"[wholebrain-parity] {mode}: resumed {tel['resumed']}, "
                  f"{tel['blocks_replayed']} blocks replayed, "
                  f"{tel['blocks_streamed']} streamed in {resume_s:.2f} s "
                  f"(child {child['wall']:.2f} s); bitwise equal to the "
                  f"uninterrupted fit: {same} [{card}]")
            check(tel["resumed"]
                  and tel["blocks_replayed"] == WB13_KILL_AFTER + 1
                  and tel["blocks_streamed"] == 4 - WB13_KILL_AFTER - 1
                  and not jdir.exists(), f"{mode} resume telemetry {tel}")
            check(all(same.values()), f"{mode}: the resumed fit differs "
                  f"from the uninterrupted one: {same}")
        # A journal written for another blocking is refused, by path or
        # attached.
        other = journal_signature(store, cfg, t_block=tb // 2,
                                  device="cuda")
        FitJournal.attach(str(root / "journal_other"), other)
        for journal in (str(root / "journal_other"),
                        FitJournal.attach(str(root / "journal_other"),
                                          other)):
            try:
                fit_wholebrain(store, cfg, t_block=tb, journal=journal,
                               device="cuda")
            except JournalError as e:
                print(f"[wholebrain-parity] a journal of t_block={tb // 2} "
                      f"refused: {str(e)[:100]}…")
            else:
                check(False, "a journal of another t_block was accepted")
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


# --------------------------------------------------------------------------
# Phase 14
# --------------------------------------------------------------------------
def phase_mor(card: str) -> int:
    import numpy as np
    import torch
    from repro_torch.core import complexity, mor, ridge
    from repro_torch.data import fmri
    from repro_torch.encoding import BrainEncoder, EncoderConfig
    from repro_torch.encoding.dispatch import resolve
    from repro_torch.kernels import gram

    w = complexity.PAPER_WORKLOADS["whole_brain_mor"]
    n, p, t = w.n, w.p, MOR_TARGETS
    d = resolve(EncoderConfig(solver="mor"), n, p, w.t, device="cuda")
    check((d.solver, d.method, d.target_shards, d.use_pallas)
          == ("mor", "dual", 1, True), f"MOR decision {d}")
    g = torch.Generator("cuda").manual_seed(14)
    X, Y, _ = fmri.generate(fmri.SubjectSpec(n=n, p=p, t=w.t), g,
                            device="cuda")
    Y = Y[:, :t].contiguous()
    enc = BrainEncoder(solver="mor", device="cuda")
    cfg = enc.config.ridge_cv_config("dual", device="cuda")
    # The launches of one target's fit, counted on the card.
    gram.reset_launches()
    ridge.ridge_cv(X, Y[:, :1].contiguous(), cfg)
    torch.cuda.synchronize()
    per_target = gram.LAUNCHES["xty"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    enc.fit(X, Y)
    torch.cuda.synchronize()
    mor_s = time.perf_counter() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    W = enc.report_.weights
    check(launches == {**dict.fromkeys(launches, 0),
                       "xty": t * per_target},
          f"MOR launches {launches}, want {t} × {per_target} xty")
    check(tuple(W.shape) == (p, t) and bool(torch.isfinite(W).all()),
          "MOR W shape or non-finite values")
    t0 = time.perf_counter()
    plain = BrainEncoder(solver="mor", use_pallas=False,
                         device="cuda").fit(X, Y).report_.weights
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    dw = (W - plain).abs().max().item()
    np.testing.assert_allclose(W.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-4, atol=2e-4)
    t0 = time.perf_counter()
    task = mor.mor_fit_taskwise(X, Y[:, :MOR_TASKWISE].contiguous(), cfg)
    torch.cuda.synchronize()
    task_s = time.perf_counter() - t0
    check(torch.equal(task, W[:, :MOR_TASKWISE]),
          "mor_fit_taskwise differs from mor_fit")
    ridge.ridge_cv(X, Y, cfg)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ridge.ridge_cv(X, Y, cfg)
    torch.cuda.synchronize()
    mutual_s = time.perf_counter() - t0
    model = complexity.mor_overhead_factor(
        complexity.RidgeWorkload(n=n, p=p, t=t), 1)
    print(f"[mor] whole_brain_mor n={n} p={p}, t cut from {w.t} to {t}: "
          f"decision {d.solver}/{d.method} target_shards "
          f"{d.target_shards}; BrainEncoder(solver='mor').fit {mor_s:.2f} s "
          f"= {mor_s / t * 1e3:.1f} ms per target; launches {launches} "
          f"({per_target} xty per target, counted on one target's fit); "
          f"peak device memory {peak / 2**30:.2f} GiB [{card}]")
    print(f"[mor] plain tier (use_pallas=False) {plain_s:.2f} s, max|ΔW| "
          f"{dw:.3e} (rtol 1e-4, atol 2e-4); mor_fit_taskwise on "
          f"{MOR_TASKWISE} targets {task_s:.2f} s, bitwise equal to "
          f"mor_fit; mutualised ridge_cv on the same {t} targets "
          f"{mutual_s:.3f} s: MOR/mutualised {mor_s / mutual_s:.1f}× "
          f"measured, complexity.mor_overhead_factor {model:.1f}× "
          f"[{card}]")
    del X, Y, enc, W, plain, task
    free()
    return launches["xty"]


# --------------------------------------------------------------------------
# Phase 15
# --------------------------------------------------------------------------
def phase_banded(card: str) -> None:
    import numpy as np
    import torch
    from repro_torch.core import banded, complexity, ridge
    from repro_torch.data import fmri
    from repro_torch.encoding import BrainEncoder, EncoderConfig
    from repro_torch.encoding.dispatch import resolve

    w = complexity.PAPER_WORKLOADS["parcels"]
    n, p, t = w.n, w.p, w.t
    check(sum(BANDS) == p, f"bands {BANDS} do not sum to p={p}")
    cfg = EncoderConfig(bands=BANDS, n_folds=3,
                        n_band_candidates=BANDED_CANDIDATES)
    d = resolve(cfg, n, p, t, device="cuda")
    check((d.solver, d.method) == ("banded", "eigh"), f"banded decision {d}")
    g = torch.Generator("cuda").manual_seed(15)
    X, Y, _ = fmri.generate(fmri.SubjectSpec(n=n, p=p, t=t), g,
                            device="cuda")
    timers = dict.fromkeys(("grams", "eighs"), 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _patched((banded, "_gram", _timed(banded._gram, timers, "grams")),
                  (torch.linalg, "eigh",
                   _timed(torch.linalg.eigh, timers, "eighs"))):
        t0 = time.perf_counter()
        enc = BrainEncoder(cfg, device="cuda").fit(X, Y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    rep = enc.report_
    n_eigh = BANDED_CANDIDATES * cfg.n_folds + 1
    cands = banded.draw_candidates(torch.Generator().manual_seed(cfg.seed),
                                   cfg.banded_config()).numpy()
    check(rep.decision.solver == "banded" and rep.solver_label
          == "banded RidgeCV", f"report {rep.decision}")
    check(not any(launches.values()), f"banded launched kernels {launches}")
    check(tuple(rep.weights.shape) == (p, t)
          and bool(torch.isfinite(rep.weights).all()), "banded W")
    check(bool(np.isfinite(rep.cv_scores).all())
          and rep.cv_scores.shape == (1, BANDED_CANDIDATES), "CV curve")
    check(any(np.array_equal(rep.band_lambdas, c) for c in cands),
          f"band λ {rep.band_lambdas} not among the drawn candidates")
    rest = fit_s - timers["grams"] - timers["eighs"]
    print(f"[banded] parcels n={n} p={p} = bands {BANDS} t={t}, "
          f"{cfg.n_folds} folds, {BANDED_CANDIDATES} candidates (cut from "
          f"16): decision {d.solver}/{d.method}; fit {fit_s:.2f} s = Grams "
          f"{timers['grams']:.2f} s + {n_eigh} eighs {timers['eighs']:.2f} s "
          f"+ the rest {rest:.2f} s; band λ {rep.band_lambdas.tolist()}, CV "
          f"R² {rep.cv_scores[0].round(5).tolist()}; peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]")
    # Equal bands reduce to plain ridge (the reference's
    # test_equal_bands_reduce_to_plain_ridge, at full size).
    lam = float(rep.band_lambdas.max())
    t0 = time.perf_counter()
    W_b = banded.solve_banded(X, Y, torch.full((len(BANDS),), lam,
                                               device="cuda"),
                              BANDS, jitter=0.0)
    f = ridge.factorize(X, ridge.RidgeCVConfig(method="eigh", jitter=0.0))
    W_p = ridge.solve(f, ridge.gram_xty(X, Y), torch.tensor(lam,
                                                            device="cuda"))
    torch.cuda.synchronize()
    eq_s = time.perf_counter() - t0
    dw = (W_b - W_p).abs().max().item()
    print(f"[banded] all four band λ = {lam:g}: solve_banded against "
          f"ridge.solve on the full Gram, max|ΔW| {dw:.3e} (rtol 1e-4, atol "
          f"2e-4, max|W| {W_p.abs().max().item():.4e}), {eq_s:.2f} s "
          f"[{card}]")
    np.testing.assert_allclose(W_b.cpu().numpy(), W_p.cpu().numpy(),
                               rtol=1e-4, atol=2e-4)
    del X, Y, enc, rep, W_b, W_p, f
    free()


# --------------------------------------------------------------------------
# Phase 16
# --------------------------------------------------------------------------
def _serving_bundles(root: Path, p: int, t: int) -> list[str]:
    """``SERVE_MODELS`` parcels-width bundles of seeded weights and
    standardizers, written by the port's bundle code."""
    import math
    import numpy as np
    import torch
    from repro_torch.encoding import BrainEncoder
    from repro_torch.encoding.dispatch import resolve
    from repro_torch.encoding.estimator import EncodingReport
    from repro_torch.encoding.pipeline import Standardizer

    g = torch.Generator("cuda").manual_seed(16)
    paths = []
    for i in range(SERVE_MODELS):
        enc = BrainEncoder(device="cuda")
        enc.report_ = EncodingReport(
            weights=torch.randn(p, t, device="cuda", generator=g)
            / math.sqrt(p),
            best_lambda=np.array([enc.config.lambdas[i]]),
            cv_scores=np.zeros((1, len(enc.config.lambdas))),
            lambdas=enc.config.lambdas,
            decision=resolve(enc.config, 69_202, p, t, device="cuda"))
        enc.standardizer_ = Standardizer(
            mu_x=0.1 * torch.randn(p, device="cuda", generator=g),
            sd_x=0.5 + torch.rand(p, device="cuda", generator=g),
            mu_y=0.1 * torch.randn(t, device="cuda", generator=g),
            sd_y=0.5 + torch.rand(t, device="cuda", generator=g))
        paths.append(enc.save(str(root / f"sub-{i + 1:02d}")))
    return paths


def phase_serving(card: str) -> None:
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import complexity
    from repro_torch.kernels import ops
    from repro_torch.serving_encoders import (EncoderBundle,
                                              EncoderRegistry,
                                              EncoderService, FleetFrontend,
                                              reference_serve)
    from repro_torch.serving_encoders import fleet, service, traffic
    from repro_torch.serving_encoders.registry import bundle_resident_bytes

    w = complexity.PAPER_WORKLOADS["parcels"]
    p, t = w.p, w.t
    big = SERVE_BUCKETS[-1]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=build))
    try:
        t0 = time.perf_counter()
        paths = _serving_bundles(root, p, t)
        write_s = time.perf_counter() - t0
        names = [Path(q).name for q in paths]
        one = bundle_resident_bytes(EncoderBundle.open(paths[0]), big, None,
                                    SERVE_SLOTS)
        budget = int(2.5 * one)                 # holds two, never three

        def stack():
            reg = EncoderRegistry(device_memory_budget=budget,
                                  wave_rows=big, device="cuda")
            for name, path in zip(names, paths):
                reg.add(name, path)
            return reg, EncoderService(reg, wave_buckets=SERVE_BUCKETS,
                                       score_slots=SERVE_SLOTS)

        spec = traffic.make_mixed_trace(16, n_models=SERVE_MODELS,
                                        n_requests=SERVE_REQUESTS, p=p, t=t,
                                        wave_rows=big)
        reqs = traffic.replay_requests(spec, names)
        n_rows = sum(q.features.shape[0] for q in reqs)
        reg, svc = stack()
        fe = FleetFrontend(svc, max_pending_rows=8 * big)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _strict():                 # the wave programs' windows armed
            t0 = time.perf_counter()
            results, rejections = fleet.replay(fe, reqs)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ref_reg, ref_svc = stack()
        t0 = time.perf_counter()
        alone = reference_serve(ref_svc, reqs)
        alone_s = time.perf_counter() - t0
        for i, (got, want) in enumerate(zip(results, alone)):
            check(got is not None and got.error is None
                  and want.error is None, f"request {i} failed")
            check(np.array_equal(got.predictions, want.predictions),
                  f"request {i}: packed predictions differ from alone")
            check((got.pearson_r is None) == (want.pearson_r is None)
                  and (got.pearson_r is None
                       or np.array_equal(got.pearson_r, want.pearson_r)),
                  f"request {i}: packed Pearson r differs from alone")
        st = svc.stats.to_dict()
        check(svc.compile_count == len(st["per_bucket"]),
              f"compile_count {svc.compile_count}, buckets "
              f"{list(st['per_bucket'])}")
        check(reg.evictions > 0, f"no eviction under the budget: "
              f"{reg.stats()}")
        # Predictions against a float64 host product of the same bundles,
        # served r against ops.pearson_r on the same rows.
        host = {}
        for name, path in zip(names, paths):
            b = EncoderBundle.open(path)
            a = b.load_arrays()
            host[name] = (b.load_weight_shard(0).astype(np.float64),
                          *(a[k].astype(np.float64) for k in
                            ("mu_x", "sd_x", "mu_y", "sd_y")))
        dp = dr = 0.0
        for q, got in zip(reqs, results):
            W64, mx, sx, my, sy = host[q.model]
            want = ((q.features - mx) / sx) @ W64 * sy + my
            np.testing.assert_allclose(got.predictions, want, rtol=1e-4,
                                       atol=2e-4)
            dp = max(dp, float(np.abs(got.predictions - want).max()))
            if q.targets is not None:
                r = ops.pearson_r(torch.from_numpy(q.targets).cuda(),
                                  torch.from_numpy(got.predictions).cuda())
                r = r.cpu().numpy()
                np.testing.assert_allclose(got.pearson_r, r, rtol=0,
                                           atol=PEARSON_TOL)
                dr = max(dr, float(np.abs(got.pearson_r - r).max()))
        print(f"[serving] {SERVE_MODELS} bundles p={p} t={t} "
              f"({EncoderBundle.open(paths[0]).weight_nbytes() / 1e6:.1f} MB "
              f"of W each) written in {write_s:.2f} s; trace "
              f"{spec.digest()[:12]}: {len(reqs)} requests, {n_rows} rows, "
              f"{sum(q.targets is not None for q in reqs)} scored; "
              f"FleetFrontend → EncoderService(wave_buckets={SERVE_BUCKETS}, "
              f"score_slots={SERVE_SLOTS}) {serve_s:.3f} s = "
              f"{n_rows / serve_s:,.0f} rows/s ({len(rejections)} "
              f"admission rejections), reference_serve {alone_s:.3f} s; "
              f"waves {st['per_bucket']}; registry {reg.stats()} under "
              f"{budget / 1e6:.1f} MB; peak device memory "
              f"{peak / 2**30:.2f} GiB [{card}]")
        print(f"[serving] packed = alone bitwise (predictions and r, "
              f"{len(reqs)} requests); compile_count {svc.compile_count}; "
              f"max|Δ| vs float64 host product {dp:.3e} (rtol 1e-4, atol "
              f"2e-4); max|Δr| vs ops.pearson_r {dr:.3e} (atol "
              f"{PEARSON_TOL:g})")
        # The same replay on a fresh stack under the tracer (and strict):
        # where the host time goes, and the counters against ServiceStats.
        t_reg, t_svc = stack()
        t_fe = FleetFrontend(t_svc, max_pending_rows=8 * big)
        before = obs.snapshot()["counters"]
        with _strict(), _traced() as tracer:
            t0 = time.perf_counter()
            traced, _ = fleet.replay(t_fe, reqs)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        events = tracer.events()
        _print_spans("serving", events, card)
        c = _counter_deltas(before, "")
        t_st = t_svc.stats.to_dict()
        waves_c = sum(v for k, v in c.items() if k.startswith("waves{"))
        got = {"waves": waves_c, "wave_rows": c.get("wave_rows", 0.0),
               "wave_pad_rows": c.get("wave_pad_rows", 0.0),
               "admitted_rows": c.get("admitted_rows", 0.0)}
        want = {"waves": t_st["waves"], "wave_rows": t_st["rows"],
                "wave_pad_rows": t_st["pad_rows"],
                "admitted_rows": t_st["rows"]}
        split = {name: _span_s(events, name)[1] for name in (
            "fleet.flush", "serve.wave.build", "serve.wave.execute",
            "registry.load")}
        inside = split["serve.wave.build"] + split["serve.wave.execute"] \
            + split["registry.load"]
        print(f"[serving] traced replay {traced_s:.3f} s = "
              f"{n_rows / traced_s:,.0f} rows/s (untraced {serve_s:.3f} s): "
              f"fleet.flush {split['fleet.flush']:.3f} s = serve.wave.build "
              f"{split['serve.wave.build']:.3f} s (numpy packing, copies to "
              f"the card) + serve.wave.execute "
              f"{split['serve.wave.execute']:.3f} s (the products and the "
              f"Pearson row loop enqueued; an unscored wave is not waited "
              f"for) + registry.load {split['registry.load']:.3f} s + the "
              f"rest {split['fleet.flush'] - inside:.3f} s (request checks, "
              f"grouping, predictions and r to the host); counters {got} "
              f"[{card}]")
        check(got == want, f"obs counters {got} != ServiceStats {want}")
        for i, (a, b) in enumerate(zip(traced, results)):
            check(np.array_equal(a.predictions, b.predictions)
                  and (a.pearson_r is None) == (b.pearson_r is None)
                  and (a.pearson_r is None
                       or np.array_equal(a.pearson_r, b.pearson_r)),
                  f"request {i}: the traced serve differs")
        execute_ms = {}
        for rows in SERVE_BUCKETS:
            n_e, e_s = _span_s(events, "serve.wave.execute", rows=rows)
            execute_ms[rows] = 1e3 * e_s / max(n_e, 1)
        del t_reg, t_svc, t_fe, traced
        # A row's bits at every bucket of the ladder and every offset.
        e = reg.get(names[0], wave_rows=big, score_slots=SERVE_SLOTS)
        args = (e.weights, e.mu_x, e.sd_x, e.mu_y, e.sd_y)
        x = torch.from_numpy(reqs[0].features[:1]).cuda()
        lone = service.predict_rows(x, *args)[0]
        g = torch.Generator("cuda").manual_seed(17)
        for rows in SERVE_BUCKETS:
            wave = torch.randn(rows, p, device="cuda", generator=g)
            for off in range(rows):
                wv = wave.clone()
                wv[off] = x[0]
                check(torch.equal(service.predict_rows(wv, *args)[off],
                                  lone),
                      f"row bits differ at bucket {rows}, offset {off}")
        print(f"[serving] one row's prediction bits equal at every offset "
              f"of every bucket {SERVE_BUCKETS} "
              f"({sum(SERVE_BUCKETS)} placements)")
        # Wave times by bucket: the unscored program, the mixed program
        # with every slot scored, and its sequential Pearson chain alone.
        for rows in SERVE_BUCKETS:
            X = torch.randn(rows, p, device="cuda", generator=g)
            Yt = torch.randn(rows, t, device="cuda", generator=g)
            oh = torch.zeros(rows, SERVE_SLOTS, device="cuda")
            oh[torch.arange(rows), torch.arange(rows) % SERVE_SLOTS] = 1.0
            sums = torch.zeros(SERVE_SLOTS, 5, t, device="cuda")
            P = service.predict_rows(X, *args)
            plain_ms = time_ms(lambda: service.predict_rows(X, *args), 50, 5)
            # The row loop is launch-bound: time it and the whole scored
            # wave in turns (wave, loop, loop, wave) and average.
            runs = {"mixed": [], "chain": []}
            for key in ("mixed", "chain", "chain", "mixed"):
                fn = ((lambda: service.predict_mixed(X, Yt, oh, sums, *args))
                      if key == "mixed" else
                      (lambda: service.chain_sums(sums, Yt, P, oh)))
                runs[key].append(time_ms(fn, 50, 5))
            mixed_ms = sum(runs["mixed"]) / 2
            chain_ms = sum(runs["chain"]) / 2
            print(f"[serving] bucket {rows}: unscored wave {plain_ms:.3f} "
                  f"ms, scored wave {mixed_ms:.3f} ms of which the row loop "
                  f"of Pearson sums {chain_ms:.3f} ms "
                  f"({100 * chain_ms / mixed_ms:.0f}%) (CUDA events); the "
                  f"replay's serve.wave.execute spans {execute_ms[rows]:.3f} "
                  f"ms a wave, scored and unscored (host clock, the enqueue "
                  f"where nothing waits) [{card}]")
        del reg, svc, fe, ref_reg, ref_svc, results, alone, e, args
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free()


# --------------------------------------------------------------------------
# Phase 17
# --------------------------------------------------------------------------
def _run_driver(tag: str, argv: list[str], card: str) -> str:
    """``python -m repro_torch.launch.<argv>`` in a new process with the
    recompile sentinel armed; it must exit 0.  → its standard output."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", *argv], cwd=ROOT,
        env=dict(os.environ, REPRO_OBS_STRICT="1",
                 PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in out.stdout.splitlines():
        if not line.startswith("WHOLEBRAIN_RESULT"):
            print(f"[drivers]   {tag}: {line}")
    if out.returncode != 0:
        print(out.stderr[-6000:], file=sys.stderr)
    check(out.returncode == 0, f"{tag}: python -m {' '.join(argv)} exited "
          f"{out.returncode}")
    print(f"[drivers] {tag}: python -m {' '.join(argv)} exited 0 in "
          f"{wall:.2f} s [{card}]")
    return out.stdout


def _encode_in_process(tag: str, argv: list[str], card: str,
                       phase: str = "drivers", patches=()
                       ) -> tuple[str, dict, float]:
    """``launch/encode.py``'s ``main(argv)`` in this process, its kernel
    launches counted from zero, under ``patches`` (``_patched``'s
    triples).  → (its output, the launches, its seconds)."""
    import io
    import torch
    from repro_torch.launch import encode

    out = io.StringIO()
    _reset_counters()
    with _patched(*patches), contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        encode.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _counters()
    for line in out.getvalue().splitlines():
        print(f"[{phase}]   {tag}: {line}")
    print(f"[{phase}] {tag}: encode {' '.join(argv)}: {wall:.2f} s, "
          f"launches {launches} [{card}]")
    return out.getvalue(), launches, wall


def phase_drivers(card: str) -> dict:
    """Phase 17: the drivers a lab runs, from their command lines.
    → kernel launches of the runs this process counts."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import EncoderConfig
    from repro_torch.encoding.dispatch import resolve
    from repro_torch.kernels import ops, ref, ssd
    from repro_torch.serving_encoders import EncoderBundle
    from repro_torch.wholebrain import fit_wholebrain

    total = {}
    held = []

    def holding(name, kernel, plain):
        """``kernel`` with each launch's output held against ``plain`` on
        the same operands (``_compare``), its shapes and error kept."""
        def wrapper(x, y, third):
            out = kernel(x, y, third)
            s = len(third) if name == "xty_folds" else third.shape[1]
            shapes = f"{name} x={tuple(x.shape)} z={tuple(y.shape)} s={s}"
            err, scale = _compare(shapes, out, plain(x, y, third), "float32")
            held.append((shapes, err, scale))
            return out
        return wrapper

    def print_held(tag: str, want: int) -> None:
        shapes = sorted({h[0] for h in held})
        worst = max(held, key=lambda h: h[1] / max(h[2], 1e-30))
        print(f"[drivers] {tag}: every one of {len(held)} launches held "
              f"against its plain version on its own operands ({len(shapes)} "
              f"shapes: {'; '.join(shapes)}): worst max abs err "
              f"{worst[1]:.3e} of max|plain| {worst[2]:.3e} (tol "
              f"{REL_TOL:g}·max|plain|) [{card}]")
        check(len(held) == want, f"{tag}: {len(held)} launches held, want "
              f"{want}")
        held.clear()

    hold_folds = (ops, "xty_folds",
                  holding("xty_folds", ops.xty_folds, ref.xty_folds))
    # (a) The backbone mode feeds 16-token sequences: ssd_intra at Q = 16,
    # zamba2-2.7b's H and P, one chunk per sequence, held against its plain
    # version first (f32 operands, as mamba_apply passes them, and bf16).
    cfg = configs.for_device(configs.get_config(DRV_BACKBONE), "cuda")
    check(cfg.ssm.use_kernel and cfg.flash_kernel, "configs.for_device: "
          "the kernel tier is off on a CUDA device")
    h, pd = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    n_seq = DRV_N // DRV_SEQ
    g = torch.Generator("cuda").manual_seed(17)
    cb = torch.randn(n_seq, DRV_SEQ, DRV_SEQ, device="cuda",
                     generator=g) / DRV_SEQ ** 0.5
    la = torch.cumsum(-torch.rand(n_seq, DRV_SEQ, h, device="cuda",
                                  generator=g) * 0.1, dim=1)
    x = torch.randn(n_seq, DRV_SEQ, h, pd, device="cuda", generator=g)
    for dt in (torch.float32, torch.bfloat16):
        ops_ = [a.to(dt) for a in (cb, la, x)]
        err = _close(f"ssd_intra N={n_seq} Q={DRV_SEQ} H={h} P={pd} {dt}",
                     ssd.ssd_intra(*ops_), ref.ssd_intra(*ops_))
        print(f"[drivers] ssd_intra at the driver's chunk (N={n_seq}, "
              f"Q={DRV_SEQ}, H={h}, P={pd}, {str(dt)[6:]} operands) against "
              f"ref.ssd_intra: max abs err {err:.3e} [{card}]")
    del cb, la, x, ops_
    free()
    n_mamba = cfg.n_repeats * sum(k == "mamba" for k in cfg.pattern)
    out, launches, _ = _encode_in_process(
        "zamba2", ["--backbone", DRV_BACKBONE, "--n", str(DRV_N),
                   "--targets", str(PARCELS), "--device", "cuda"], card,
        patches=[hold_folds])
    print_held("zamba2 encode's xty_folds", 1)
    check(f"X({DRV_N}, {cfg.d_model})" in out, "zamba2 feature shape")
    check("aligned encoding is significant" in out,
          "zamba2 features: not significant")
    want = dict({k: 0 for k in launches}, ssd_intra=n_mamba, xty_folds=1)
    check(launches == want and n_mamba == 54,
          f"zamba2 encode launches {launches}, want {want}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    free()
    out, launches, _ = _encode_in_process("vgg16", ["--device", "cuda"],
                                          card, patches=[hold_folds])
    print_held("vgg16 encode's xty_folds", 1)
    check("X(512, 128)" in out and "Y(512, 256)" in out, "vgg16 shapes")
    check(launches == dict({k: 0 for k in launches}, xty_folds=1),
          f"vgg16 encode launches {launches}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    free()

    # (b) The whole-brain driver at the reference's full shape, each phase
    # its own process (their launches come back in the result lines).
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    need = 1024 * (128 + 262_144) * 4 + 128 * 262_144 * 4 + (1 << 30)
    free_b = shutil.disk_usage(build).free
    print(f"[drivers] whole-brain driver: store and bundle "
          f"{(need - (1 << 30)) / 1e9:.2f} GB under {build} "
          f"({free_b / 1e9:.1f} GB free)")
    check(free_b > need, f"phase 17 needs {need / 1e9:.1f} GB of disk "
          f"under {build}, which has {free_b / 1e9:.1f} GB free")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_drivers_", dir=build))
    try:
        wb_out = root / "BENCH_wholebrain_torch.json"
        _run_driver("wholebrain", [
            "repro_torch.launch.wholebrain", "--device", "cuda",
            "--workdir", str(root / "wb"), "--out", str(wb_out),
            "--cap-mb", str(WB_DRIVER_CAP_MB),
            "--trace-out", str(root / "wb.jsonl"),
            "--metrics-out", str(root / "wb.json")], card)
        doc = json.loads(wb_out.read_text())
        _run_driver("obs_report", [
            "repro_torch.launch.obs_report", str(root / "wb.fit16384.jsonl"),
            "--assert-coverage", str(COVERAGE_GATE)], card)
        for fit in doc["fit_vs_t_block"]:
            print(f"[drivers] whole-brain fit t_block={fit['t_block']}: "
                  f"{fit['wall_s']} s, {fit['n_blocks']} blocks, device peak "
                  f"{fit['device_peak_mb']} MB and RSS held "
                  f"{fit['rss_held_mb']} MB (peak {fit['peak_rss_mb']} MB, "
                  f"{fit['cuda_init_rss_mb']} MB of it right after the CUDA "
                  f"stack's initialisation, {fit['cuda_context_rss_mb']} MB "
                  f"right after torch.cuda.init() and the context: "
                  f"{fit['rss_over_context_mb']} MB over the bare context) "
                  f"under the {doc['rss_cap_mb']} MB cap "
                  f"(the unblocked path {fit['unblocked_stats_mb']} MB), "
                  f"launches {fit['kernel_launches']} [{card}]")
            check(fit["use_pallas"]
                  and max(fit["device_peak_mb"], fit["rss_held_mb"])
                  < doc["rss_cap_mb"] < fit["unblocked_stats_mb"],
                  f"whole-brain fit {fit}")
            check(fit["kernel_launches"]["xty_folds_masked"]
                  == -(-doc["n"] // doc["chunk_rows"]) * (1 + fit["n_blocks"]),
                  f"whole-brain fit launches {fit['kernel_launches']}")
        ab, crash = doc["fused_ab"], doc["crash_resume"]
        roof = ab["roofline"]
        print(f"[drivers] whole-brain A/B {ab['n']}x{ab['p']}x{ab['t']} "
              f"(t_block {ab['t_block']}): plain {ab['unfused_runs_s']} s, "
              f"kernel {ab['fused_runs_s']} s, λ equal; the faster "
              f"{min(ab['unfused_s'], ab['fused_s'])} s is "
              f"{roof['peak_fraction']:.3e} of the H100's 67 TFLOP/s f32 "
              f"peak ({roof['model_flops']:.3e} FLOPs, "
              f"{roof['flop_per_byte']:.1f} FLOP/byte: "
              f"{roof['bottleneck']}-bound) [{card}]")
        check(ab["kernel_tier"] == "cuda" and ab["lambda_match"],
              f"whole-brain A/B {ab}")
        print(f"[drivers] whole-brain crash gate: killed after block "
              f"{crash['kill_after_block']} of {crash['n_blocks']}, resumed "
              f"{crash['resumed']['blocks_replayed']} replayed + "
              f"{crash['resumed']['blocks_streamed']} streamed, "
              f"{crash['w_shards_bitwise']} W shards bitwise, faulty run "
              f"{crash['faulty']['io_retries']} retries; fits "
              f"{crash['ref']['wall_s']} / {crash['resumed']['wall_s']} / "
              f"{crash['faulty']['wall_s']} s; serve paged "
              f"{doc['serve']['shards_paged']}/{doc['serve']['weight_shards']}"
              f" shards in {doc['serve']['wall_s']} s [{card}]")
        counted = [*doc["fit_vs_t_block"], ab, crash["ref"],
                   crash["resumed"], crash["faulty"]]
        for res in counted:
            for k, v in res["kernel_launches"].items():
                total[k] = total.get(k, 0) + v
        # The driver's fits again in this process, on its store and with
        # its configuration, every xty_folds_masked launch held against the
        # plain version on its own operands; λ equal to the driver's, and W
        # bitwise equal to the bundle the driver's first fit wrote.  These
        # launches are checks: they do not count.
        n, p, t = doc["n"], doc["p"], doc["t"]
        store = RunStore.open(str(root / "wb" / f"subject_{n}x{p}x{t}"))
        hold_masked = (ops, "xty_folds_masked",
                       holding("xty_folds_masked", ops.xty_folds_masked,
                               ref.xty_folds_masked))
        for fit in doc["fit_vs_t_block"]:
            cfg_f = EncoderConfig(
                n_folds=doc["n_folds"], chunk_rows=doc["chunk_rows"],
                device_memory_budget=int(doc["rss_cap_mb"] * 2**20),
                target_block=fit["t_block"])
            dec = resolve(cfg_f, n, p, t, 1, device="cuda")
            check(dec.method == "colblocked", f"decision {dec}")
            t0 = time.perf_counter()
            with _patched(hold_masked):
                res = fit_wholebrain(store, cfg_f, t_block=dec.target_block,
                                     collect=True, device="cuda")
            refit_s = time.perf_counter() - t0
            print_held(f"whole-brain fit t_block={fit['t_block']} again in "
                       f"this process ({refit_s:.2f} s with the checks)",
                       fit["kernel_launches"]["xty_folds_masked"])
            lam = float(np.asarray(res.best_lambda)[0])
            check(lam == fit["best_lambda"], f"λ {lam} != the driver's "
                  f"{fit['best_lambda']} at t_block {fit['t_block']}")
            if fit["saved_bundle"]:
                bundle = EncoderBundle.open(str(root / "wb" / "bundle"))
                bounds = bundle.weight_shard_bounds()
                same = all(np.array_equal(bundle.load_weight_shard(i),
                                          res.weights[:, lo:hi])
                           for i, (lo, hi) in enumerate(bounds))
                print(f"[drivers] the driver's bundle: {len(bounds)} weight "
                      f"shards bitwise equal to this fit's W: {same} "
                      f"[{card}]")
                check(same, "the driver's bundle differs from the held fit")
            del res
            free()

        # (c) The serving driver: the checked-in trace, then the faults
        # lane's two-worker drain with worker 0 killed.
        trace = ROOT / "benchmarks" / "traces" / "mixed_v1.json"
        out = _run_driver("serve replay", [
            "repro_torch.launch.serve", "--device", "cuda",
            "--replay-trace", str(trace),
            "--bundle-dir", str(root / "fleet_a")], card)
        check("0 backpressure rejections, 0 faults" in out,
              "trace replay rejected or faulted")
        out = _run_driver("serve fleet", [
            "repro_torch.launch.serve", "--device", "cuda", "--encoders",
            "4", "--bundle-dir", str(root / "fleet_b"), "--workers", "2",
            "--kill-worker", "0", "--n", "128", "--targets", "64",
            "--serve-steps", "3", "--requests-per-step", "4"], card)
        check("lease gate: w0 SIGKILLed" in out
              and "2 workers drained cleanly" in out,
              "fleet drain: no lease gate line")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def _selected(argv: list[str]) -> set[int] | None:
    """``--only 14,16`` runs phase 1 and the listed independent phases
    (6 and 12 to 17) and prints no result lines: a quick check while
    working on them.  With no arguments every phase runs."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit("usage: chip_smoke.py [--only N[,N...]] "
                         "(N in 6, 12..17)")
    only = {int(v) for v in argv[1].split(",")}
    if not only <= {6, 12, 13, 14, 15, 16, 17}:
        raise SystemExit(f"--only takes phases 6 and 12 to 17, got "
                         f"{sorted(only)}")
    return only


def main(argv: list[str]) -> int:
    import torch

    if argv[:1] == ["--kill-child"]:
        return _kill_child(argv[1])
    only = _selected(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    env = phase_env()
    card = env["card"]
    if only is not None:
        for n, phase in ((6, phase_streamed), (12, phase_wholebrain),
                         (13, phase_wholebrain_parity),
                         (14, phase_mor), (15, phase_banded),
                         (16, phase_serving), (17, phase_drivers)):
            if n in only:
                t0 = time.perf_counter()
                phase(card)
                print(f"[done] phase {n} passed in "
                      f"{time.perf_counter() - t0:.1f} s")
        print(f"[done] phases {sorted(only)} passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
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
    launches["xty"] += phase_mor(card)
    phase_banded(card)
    phase_serving(card)
    t0 = time.perf_counter()
    for k, v in phase_drivers(card).items():
        launches[k] += v
    print(f"[done] phase 17 passed in {time.perf_counter() - t0:.1f} s")
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
    sys.exit(main(sys.argv[1:]))
