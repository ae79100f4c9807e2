#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card (Hopper, sm_90a)

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
nvcc into ``build/kernels/``, then runs twenty-one phases, each of which
raises (exit code 1) on a failed check (``--only 14,16`` runs the build
and just the listed phases, 6 and 12 to 21, and prints no result lines):

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
   and the card's bound (flash: the largest of the function's two
   products, Q·Kᵀ and P·V, at the bf16 tensor-core rate, the
   exponentials at the SFU rate and the bytes, k and v at n_kv heads,
   with the bf16 design's four-product bound beside it; ssd_intra: its
   kept bf16 term products, the exponentials and the bytes, with its
   f32-rate bound beside it).
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
    parity tolerance; wall times of both, and the seed path's own run
    split into Gram + eigh, XᵀY, solve, scores and refit), then dual at the
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
    p=16,384; t cut from 2,000 to 128): ``resolve`` gives plan ``mor``,
    method ``dual``, one target shard; ``BrainEncoder(solver="mor").fit``
    must launch ``xty`` t times the count of one target's fit, equal the
    plain tier (rtol 1e-4, atol 2e-4), and ``mor_fit_taskwise`` must equal
    it bitwise on 64 targets.  Prints per-target seconds, the mutualised
    ``ridge_cv`` on the same targets and the measured MOR/mutualised
    factor beside ``complexity.mor_overhead_factor``.
15. Banded ridge on the ``parcels`` cell (n=69,202, p=16,384 as the
    paper's 4 TR lags × 4,096 VGG16-FC2 features, t=444, 3 folds; 2 band
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
    launch is held against ``ref.xty_folds`` on its own operands.  (b)
    ``python -m repro_torch.launch.wholebrain --device cuda``, started in
    the background (after phase 12 in a full run, at the phase's start
    with ``--only``: its ten processes mostly start up, and phases 13–16,
    (a) and (c) run beside it), at the reference's full
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
18. Multi-device over ``torch.distributed`` (``--only 18``; targets
    standardized within each CV fold, so B-MOR's pooled r² and
    ``ridge_cv``'s mean per-target r² are one curve).  (a) A NCCL world
    of one rank in this process: ``BrainEncoder(solver="bmor",
    data_shards=1, target_shards=1)`` at ``parcels`` (one ``xty_folds``)
    and ``solver="bmor_dual"`` at ``whole_brain_mor`` (one ``xty``), each
    launch held against its plain version, each fit against the
    one-device ``ridge_cv`` of the same operands (λ equal, W and CV curve
    within rtol 1e-4/atol 2e-4).  (b) Four gloo ranks sharing the card
    (``python -m torch.distributed.run`` of ``chip_smoke.py
    --dist-child``): dual B-MOR 1×4 at ``whole_brain_mor``, each batch
    against the one-device dual solve at its λ; primal B-MOR 2×2 on
    36,864 × 16,384 rows with 444 targets, 3 folds.  (c) Two gloo ranks:
    the sharded streamed ``fit(store=)`` of the same rows from a
    ``RunStore`` (``chunked`` over 2 data shards, 4,096-row chunks).  One
    device then checks each 2×2 batch against ``ridge_cv`` of its
    columns and (c) against the in-memory fit.  Rank 0 holds every
    launch against its plain version; the ranks' launches, seconds and
    each ``all_reduce``/gather's bytes and seconds are printed (gloo
    moves CUDA tensors through host memory: not NVLink's rates).  (a)
    ends with ``launch/steps.py``'s ``build_step`` on a (1, 1) mesh
    (module constants ``MESH_*``): gemma2-2b's sharded prefill and decode
    against ``ServeEngine``, zamba2-2.7b's kernel prefill against the
    plain one, and qwen3-1.7b train steps against the plain update; that
    train step is then counted by the dry run's counter
    (``hlo_analysis.count_costs``) on fake tensors, as ``launch.dryrun``
    traces it, and on one more real step: FLOPs, bytes and collective
    bytes equal; its roofline terms (compute at the f32 and bf16 rates,
    memory at HBM3) are printed beside the measured step, its argument +
    temp bytes beside the card's peak allocation.
19. LM serving (``--only 19``; random bf16 weights from a seeded
    generator on the card, the kernel switches on through
    ``configs.for_device``).  (a) ``serve.main`` in this process for
    zamba2-2.7b at full width and depth, batch 8, prompt 256, 32 tokens:
    54 ``ssd_intra`` launches in its prefill, the first launch of each
    operand shape held against ``ref.ssd_intra``.  (b) ``serve --arch
    qwen3-1.7b`` at the reference's defaults (no kernel on its path).
    (c) gemma2-2b at full width and depth through ``ServeEngine`` with the
    flash path on (``flash_threshold = flash_block = 512``): a wave of 2
    prompts of 8,192 tokens, 32 greedy tokens, 26 ``flash_attention``
    launches in the prefill (head dimension 256, the local layers'
    4,096-key window, softcap 50); one local and one global launch held
    against ``ref.mha_flash`` and timed beside it and the bound.  (d)
    phi3.5-moe-42b-a6.6b (2 of 32 layers) through ``ServeEngine`` and
    llava-next-34b (4 of 60 layers) through ``prefill``/``decode_step``
    with ``make_batch``'s prefix embeddings, 2 × 2,048 positions, 16
    tokens, one flash launch per layer.  (e) gemma2-2b (1 × 8,192) and
    zamba2-2.7b (1 × 1,024) at 2 pattern repeats with the kernel switches
    on and off: in f32 the prefill logits within 2e-4·max|logits| and 16
    greedy tokens equal; in bf16 the count of equal tokens is printed.
    Each run prints its prefill seconds, decode tokens/s, peak device
    memory and launches.
20. The audio family and training (``--only 20``), seamless-m4t-medium at
    full width and depth (12 + 12 layers, d 1,024, vocab 256,206; random
    bf16 weights).  (a) ``serve.main`` in this process with the flash
    path at 512: batch 8 × 4,096 source frames, 32 tokens, 12
    ``flash_attention`` launches (the encoder's, non-causal) in the
    prefill, the first held against ``ref.mha_flash``.  (b) The feature
    hook, ``hidden_states`` on 2 × (4,096 frames + 1,024 tokens): 36
    launches, one of each use (encoder; decoder self-attention, causal;
    cross-attention, non-causal with S ≠ T) held against
    ``ref.mha_flash`` and timed beside the plain version, SDPA and the
    bound.  (c) Kernel path against plain path in f32 at 2 + 2 layers:
    the prefill logits and the features within 2e-4·max and 16 greedy
    tokens equal.  (d) ``launch/train.py --arch seamless-m4t-medium
    --steps 8 --batch 8 --seq 1024`` in this process: every loss finite,
    no kernel launched, and the trained parameters lower the loss of the
    driver's first batch (the driver's last-against-first loss is
    printed: on fresh uniform tokens it moves less than the spread
    between batches at this size); step times and peak device memory.
21. The dry run on the card's host (``--only 21``; in a full run started
    beside phases 13–16 and collected after them): ``python -m
    repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k`` (with
    its cost probes) and ``python -m repro_torch.launch.perf --arch
    gemma2-2b --shape decode_32k``, each a child that sees no card
    (``CUDA_VISIBLE_DEVICES=""``) and traces on fake tensors as rank 0
    of a fake 256-rank world; then ``python -m
    repro_torch.launch.roofline_report`` of their records.  Each exits
    0, the qwen3 row's 6ND/HLO lies in 0.3–1.0, and the peak RSS each
    child adds over a baseline child (the same imports, fake world and
    mesh, no trace) is below its record's argument + temp bytes (it
    allocated none of them).

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
import signal
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
# 2,000 targets are cut to the first 128 (256 until phase 18 needed the
# time); the taskwise loop is held bitwise against mor_fit on the first 64
# of them.
MOR_TARGETS, MOR_TASKWISE = 128, 64
# Phase 15: banded ridge on the parcels cell, the paper's VGG16-FC2 at
# 4 TR lags (bands of 4,096), 3 folds; 2 band candidates instead of the
# default 16 (each candidate pays 3 eighs of 16,384², ~2.5 s each; 4
# until phase 18 needed the time).
BANDS = (4096,) * 4
BANDED_CANDIDATES = 2
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
# Phase 18: multi-device over torch.distributed.  (a) runs the parcels and
# whole_brain_mor cells uncut (5 folds) in a NCCL world of one; (b)'s
# primal 2×2 and (c), gloo ranks sharing cuda:0, fit parcels' p and t on
# DIST_N rows with DIST_FOLDS-fold CV: every rank pays one eigh of
# 16,384² per split and four ranks time-slice one card, so 3 folds (the
# reference's own multi-device checks use 3 and 4) cut (b)'s 24 eighs to
# 16 and (c)'s 12 to 8; DIST_N keeps each training split 1.5 p rows, away
# from the near-singular Gram of n_train ≈ p, where f32 CV scores of the
# pooled and trace-identity forms drift apart.  The streamed fit reads
# DIST_CHUNK_ROWS rows a chunk; (c) starts with (b) and fits once (b)
# is done, so its torchrun start-up overlaps (b); every process group
# fails after DIST_TIMEOUT_S instead of hanging.  DIST_TOL is the port's
# f32 parity tolerance (tests/test_kernels.py::_tol).
DIST_N, DIST_FOLDS, DIST_CHUNK_ROWS = 36_864, 3, 4_096
DIST_TIMEOUT_S = 600
DIST_TOL = dict(rtol=1e-4, atol=2e-4)
# Phase 19: LM serving.  (a) the hybrid through the driver at full width
# and depth; (c) gemma2-2b with the flash path on (flash_threshold =
# flash_block = 512, as phases 8-9 set them; the reference leaves both
# None, so serve --arch at its defaults never reaches the flash path) on
# prompts long enough that the local layers' 4,096-key window bites; (d)
# the MoE and VLM archs at full width, depth cut (phi3.5-moe: 84 GB of
# bf16 weights whole; llava-next-34b: 69 GB) to 2 and 4 layers, for the
# time limit; (e) kernel path against plain path in f32 at 2
# pattern repeats, prefill logits within LM_F32_TOL·max|logits| (f32
# summation order in the flash and SSD kernels) and the greedy tokens
# equal.
LM_HYBRID = ["--arch", "zamba2-2.7b", "--batch", "8", "--prompt-len", "256",
             "--gen", "32", "--device", "cuda"]
LM_FLASH = 512
LM_WAVE, LM_PROMPT, LM_GEN = 2, 8192, 32
LM_CUT = {"phi3.5-moe-42b-a6.6b": 2, "llava-next-34b": 4}
LM_CUT_PROMPT, LM_CUT_GEN = 2048, 16
LM_F32 = {"gemma2-2b": 8192, "zamba2-2.7b": 1024}
LM_F32_REPEATS, LM_F32_GEN, LM_F32_TOL = 2, 16, 2e-4
# Phase 20: the audio family and training, seamless-m4t-medium at its
# published widths and depth (12 + 12 layers, d 1,024, 16 heads of 64,
# vocab 256,206; random bf16 weights).  (a) serve --arch in process, the
# flash path at LM_FLASH: a wave of AUDIO_BATCH × AUDIO_FRAMES source
# frames (the reference's decode shapes' CROSS_LEN), AUDIO_GEN tokens;
# (b) the feature hook on AUDIO_FEAT_B × (AUDIO_FRAMES frames +
# AUDIO_TOKENS tokens), which runs the flash kernel as the encoder's
# (non-causal, RoPE), the decoder's self (causal) and the cross-attention
# (non-causal, S ≠ T); (c) kernel path against plain path in f32 at
# AUDIO_F32_LAYERS + AUDIO_F32_LAYERS layers; (d) launch/train.py at
# full width and depth: every loss finite, and the trained parameters
# lower the loss of the first batch the driver trained on; no checkpoint
# at this size.
# Phase 18(a), continued: launch/steps.py's build_step on a (1, 1) mesh
# in the NCCL world of one, parameters placed as DTensors
# (convert.shard_params).  (i) gemma2-2b at full width and depth, the
# kernels on (flash at LM_FLASH): the sharded prefill of MESH_LM_B ×
# MESH_LM_PROMPT tokens and MESH_LM_GEN greedy tokens through the decode
# step, equal to ServeEngine's on the same weights and prompts; (ii)
# zamba2-2.7b at full width, phase 19's LM_F32_REPEATS repeats, f32: the
# sharded prefill with the kernels on (ssd_intra, flash on the shared
# attention) against the same step on the plain path, within LM_F32_TOL;
# (iii) qwen3-1.7b at full width, MESH_TRAIN_LAYERS of its 28 layers, f32:
# MESH_TRAIN_STEPS train steps, each loss equal within MESH_TRAIN_RTOL to
# the same update done on plain tensors outside the mesh (model.loss,
# torch.autograd.grad, adamw_update).
MESH_LM_B, MESH_LM_PROMPT, MESH_LM_GEN = 2, 2048, 16
MESH_HYBRID_SEQ = 1024
MESH_TRAIN_LAYERS, MESH_TRAIN_B, MESH_TRAIN_SEQ = 4, 4, 1024
MESH_TRAIN_STEPS, MESH_TRAIN_RTOL = 2, 1e-4
# Phase 21: the dry run on the card's host, as a lab runs it before it
# books a pod: launch.dryrun (with its cost probes) and launch.perf, each
# in a child that sees no card (CUDA_VISIBLE_DEVICES=""), started beside
# phases 13–16 (whose times are printed) at the lowest priority, then
# launch.roofline_report of both records.  The qwen3-1.7b train_4k row's
# 6ND/HLO must lie in the reference's band (tests/test_reporting.py:33),
# and the peak RSS each child adds over DRY_BASE (a child that imports
# the same modules and makes the same fake world and mesh, then exits)
# must stay below its record's argument + temp bytes: it allocated none
# of them.  The baseline is taken because the card's host counts mapped
# library pages as resident (~4.5 GB for `import torch` alone).
DRY_BASE = ("import torch\n"
            "from repro_torch.launch import dryrun, mesh, perf, steps\n"
            "dryrun.fake_world(256)\n"
            "mesh.make_production_mesh(device='cpu').device_mesh\n"
            "print(''.join(l for l in open('/proc/self/status')\n"
            "              if l.startswith(('VmHWM', 'VmRSS', 'Rss'))))\n")
DRY_RUNS = {
    "dryrun": ["repro_torch.launch.dryrun", "--arch", "qwen3-1.7b",
               "--shape", "train_4k"],
    "perf": ["repro_torch.launch.perf", "--arch", "gemma2-2b", "--shape",
             "decode_32k"],
}
DRY_BAND = (0.3, 1.0)
DRY_TIMEOUT_S = 600
AUDIO = "seamless-m4t-medium"
AUDIO_BATCH, AUDIO_FRAMES, AUDIO_GEN = 8, 4096, 32
AUDIO_FEAT_B, AUDIO_TOKENS = 2, 1024
AUDIO_F32_LAYERS = 2
AUDIO_TRAIN = ["--arch", AUDIO, "--steps", "8", "--batch", "8", "--seq",
               "1024", "--device", "cuda"]


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


def _sdpa(q, k, v, causal: bool = True):
    """(name, fn) of the fastest SDPA backend that takes the model layout
    (B, S, H, K) as (B, H, S, K) views, causal or not, with q pre-scaled
    (scale 1)."""
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
                    *args, is_causal=causal, scale=1.0).transpose(1, 2)
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
    # The bound (_flash_bound_ms): the function's two products per visible
    # pair at the bf16 rate, one exponential per pair at the SFU rate, 16
    # a clock per SM at the clock the bf16 peak implies (4,096 FLOP a
    # clock per SM), i.e. peak / 256 a second; the bytes.  Beside it, the
    # bf16 design's own bound (Q·Kᵀ once and P·V three times: P split
    # exactly into three bf16 terms, each product exact in f32) and the
    # CUDA-core design's, with P·V at the f32 rate.
    pairs = S * (S + 1) / 2                        # causal (query, key) pairs
    half = 2.0 * bh * K * pairs                    # FLOPs of each product
    f32_peak = peaks(card)[0]
    bound, by, design = _flash_bound_ms(B, S, H, n_kv, K, None, None, card)
    t_tc = 2 * half / bf16_peak(card)
    t_exp = bh * pairs / (bf16_peak(card) / 256)
    t_bytes = 2 * (bh + B * n_kv) * S * K * q.element_size() / peaks(card)[1]
    t_f32_pv = half / bf16_peak(card) + half / f32_peak
    print(f"[backbone-kernels] flash_attention (mha_flash) B={B} S=T={S} "
          f"H={H} n_kv={n_kv} K={K} causal bf16, strided q/k/v: max abs err "
          f"{err:.3e}, (BH,S,K) contiguous {err_f:.3e} (rtol "
          f"{FLASH_TOL['bfloat16']['rtol']:g}/atol "
          f"{FLASH_TOL['bfloat16']['atol']:g}, max|plain| {scale:.4e}); "
          f"kernel {ms:.3f} ms ({2 * half / ms / 1e9:.1f} TFLOP/s; "
          f"contiguous (BH,S,K) {contig_ms:.3f} ms), plain {plain_ms:.3f} "
          f"ms, library {lib_ms:.3f} ms (SDPA {lib_name}, max|SDPA-kernel| "
          f"{lib_err:.3e}), bound {bound:.3f} ms ({by}: tensor cores "
          f"{t_tc * 1e3:.3f} ms for Q·Kᵀ and P·V at the bf16 rate, "
          f"exponentials {t_exp * 1e3:.3f} ms at the SFU rate, bytes "
          f"{t_bytes * 1e3:.3f} ms); the bf16 design's bound (P·V as 3 "
          f"split products) {design:.3f} ms, the CUDA-core design's (P·V at "
          f"the f32 rate) {max(t_f32_pv, t_exp, t_bytes) * 1e3:.3f} ms "
          f"[{card}]")
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
SEED_STAGES = {"factorize": "gram+eigh", "gram_xty": "XtY",
               "solve_lambda_grid": "solve_lambda_grid", "_score": "score",
               "solve": "refit"}


def _seed_stages(ridge, n_folds: int):
    """Patches of ``ridge``'s steps that time ``ridge_cv_reference``'s own
    run, the device synchronised around each → (patches, seconds by
    stage, calls by stage).  Every step after the last fold's score is
    the refit's; a step called inside another is the caller's."""
    import torch

    sec = dict.fromkeys(SEED_STAGES.values(), 0.0)
    calls = dict.fromkeys(sec, 0)
    depth = [0]

    def staged(fn, key):
        def wrapper(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            stage = "refit" if calls["score"] == n_folds else key
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            sec[stage] += time.perf_counter() - t0
            calls[stage] += 1
            return out
        return wrapper

    patches = [(ridge, name, staged(getattr(ridge, name), key))
               for name, key in SEED_STAGES.items()]
    return patches, sec, calls


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

    # The entry point's run is also its split by stage (_seed_stages).
    stages, sec, calls = _seed_stages(ridge, cfg.n_folds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _patched((ops, "solve_lambda_grid", keep_first), *stages):
        t0 = time.perf_counter()
        seed = ridge.ridge_cv_reference(X, Y, cfg)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
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
    rest = seed_s - sum(sec.values())
    print(f"[seed-primal] ridge_cv_reference's time split (its own run "
          f"above, synchronised around each step; {seed_s:.2f} s in all): "
          + ", ".join(f"{k} {v:.2f} s ({100 * v / seed_s:.1f}%)"
                      for k, v in sec.items())
          + f", the rest (splits, predictions) {rest:.2f} s "
          f"({100 * rest / seed_s:.1f}%); calls {calls} [{card}]")
    # Each fold factorises, forms XᵀY, sweeps λ and scores once; the refit
    # factorises, forms XᵀY and solves: the split covers every step.
    want_calls = {**dict.fromkeys(("gram+eigh", "XtY", "solve_lambda_grid",
                                   "score"), cfg.n_folds), "refit": 3}
    check(calls == want_calls, f"the split saw calls {calls}, want "
          f"{want_calls}")
    check(rest >= 0.0, f"the timed steps took {sum(sec.values()):.2f} s of "
          f"a {seed_s:.2f} s run")
    del X, Y, seed, new
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
DRIVER_TIMEOUT_S = 900


def _start_driver(tag: str, argv: list[str], logs: Path) -> dict:
    """Start ``python -m repro_torch.launch.<argv>`` in a new process group
    with the recompile sentinel armed, its output to files under
    ``logs`` (``_finish_driver`` collects it, ``_stop_driver`` ends it)."""
    logs.mkdir(parents=True, exist_ok=True)
    slug = tag.replace(" ", "_")
    out, err = logs / f"{slug}.out", logs / f"{slug}.err"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=ROOT,
            env=dict(os.environ, REPRO_OBS_STRICT="1",
                     PYTHONPATH=str(ROOT / "src")),
            stdout=fo, stderr=fe, start_new_session=True)
    return dict(tag=tag, argv=argv, proc=proc, out=out, err=err,
                t0=time.perf_counter())


def _stop_driver(h: dict | None) -> None:
    """End a started driver and every process it started, if still
    running."""
    if h is None or h["proc"].poll() is not None:
        return
    try:
        os.killpg(h["proc"].pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    h["proc"].wait()


def _finish_driver(h: dict, card: str, beside: str = "") -> str:
    """Wait for a started driver (within DRIVER_TIMEOUT_S of its start);
    it must exit 0.  → its standard output."""
    tag, argv, proc = h["tag"], h["argv"], h["proc"]
    try:
        rc = proc.wait(timeout=max(
            1.0, DRIVER_TIMEOUT_S - (time.perf_counter() - h["t0"])))
    except subprocess.TimeoutExpired:
        _stop_driver(h)
        rc = "timeout"
    wall = time.perf_counter() - h["t0"]
    stdout = h["out"].read_text()
    for line in stdout.splitlines():
        if not line.startswith("WHOLEBRAIN_RESULT"):
            print(f"[drivers]   {tag}: {line}")
    if rc != 0:
        print(h["err"].read_text()[-6000:], file=sys.stderr)
    check(rc == 0, f"{tag}: python -m {' '.join(argv)} exited {rc}")
    print(f"[drivers] {tag}: python -m {' '.join(argv)} exited 0 in "
          f"{wall:.2f} s{beside} [{card}]")
    return stdout


def _run_driver(tag: str, argv: list[str], card: str, logs: Path) -> str:
    """``_start_driver`` then ``_finish_driver``: one driver run to its
    end.  → its standard output."""
    h = _start_driver(tag, argv, logs)
    try:
        return _finish_driver(h, card)
    finally:
        _stop_driver(h)


def _start_wholebrain_driver(card: str) -> dict:
    """Phase 17(b)'s whole-brain driver, started in the background (its
    ten processes mostly start up and stage files: the work beside it
    fills that time).  → the handle ``phase_drivers`` finishes; its
    ``root`` holds the driver's store, bundle and logs."""
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
    wb_out = root / "BENCH_wholebrain_torch.json"
    h = _start_driver("wholebrain", [
        "repro_torch.launch.wholebrain", "--device", "cuda",
        "--workdir", str(root / "wb"), "--out", str(wb_out),
        "--cap-mb", str(WB_DRIVER_CAP_MB),
        "--trace-out", str(root / "wb.jsonl"),
        "--metrics-out", str(root / "wb.json")], root / "logs")
    return dict(h, root=root, wb_out=wb_out, beside="")


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


def phase_drivers(card: str, wb: dict | None = None) -> dict:
    """Phase 17: the drivers a lab runs, from their command lines.
    ``wb``: the whole-brain driver, started before phases 13–16 in a
    full run (``_start_wholebrain_driver``), else started here; (a) and
    (c) run beside it.  → kernel launches of the runs this process
    counts."""
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

    if wb is None:
        wb = _start_wholebrain_driver(card)
        wb["beside"] = ", beside (a) and (c)"
    root = wb["root"]
    try:
        hold_folds = (ops, "xty_folds",
                      holding("xty_folds", ops.xty_folds, ref.xty_folds))
        # (a) The backbone mode feeds 16-token sequences: ssd_intra at
        # Q = 16, zamba2-2.7b's H and P, one chunk per sequence, held
        # against its plain version first (f32 operands, as mamba_apply
        # passes them, and bf16).
        cfg = configs.for_device(configs.get_config(DRV_BACKBONE), "cuda")
        check(cfg.ssm.use_kernel and cfg.flash_kernel, "configs.for_device: "
              "the kernel tier is off on a CUDA device")
        pd = cfg.ssm.head_dim
        h = cfg.ssm.expand * cfg.d_model // pd
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
                  f"Q={DRV_SEQ}, H={h}, P={pd}, {str(dt)[6:]} operands) "
                  f"against ref.ssd_intra: max abs err {err:.3e} [{card}]")
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

        # (c) The serving driver, beside (b): the checked-in trace, then
        # the faults lane's two-worker drain with worker 0 killed.
        trace = ROOT / "benchmarks" / "traces" / "mixed_v1.json"
        out = _run_driver("serve replay", [
            "repro_torch.launch.serve", "--device", "cuda",
            "--replay-trace", str(trace),
            "--bundle-dir", str(root / "fleet_a")], card, root / "logs")
        check("0 backpressure rejections, 0 faults" in out,
              "trace replay rejected or faulted")
        out = _run_driver("serve fleet", [
            "repro_torch.launch.serve", "--device", "cuda", "--encoders",
            "4", "--bundle-dir", str(root / "fleet_b"), "--workers", "2",
            "--kill-worker", "0", "--n", "128", "--targets", "64",
            "--serve-steps", "3", "--requests-per-step", "4"], card,
            root / "logs")
        check("lease gate: w0 SIGKILLed" in out
              and "2 workers drained cleanly" in out,
              "fleet drain: no lease gate line")
        # (b) The whole-brain driver at the reference's full shape, each
        # phase its own process (their launches come back in the result
        # lines), started before (a).
        wb_out = wb["wb_out"]
        _finish_driver(wb, card, wb["beside"])
        doc = json.loads(wb_out.read_text())
        _run_driver("obs_report", [
            "repro_torch.launch.obs_report", str(root / "wb.fit16384.jsonl"),
            "--assert-coverage", str(COVERAGE_GATE)], card, root / "logs")
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
    finally:
        _stop_driver(wb)
        shutil.rmtree(root, ignore_errors=True)
    return total


# --------------------------------------------------------------------------
# Phase 18
# --------------------------------------------------------------------------
def _fold_standardized(Y, n_folds: int):
    """``Y`` with each CV fold's rows centred and scaled to unit variance
    per column (in place).  Every target then has the same ``ss_tot`` in
    every validation fold, so Algorithm 1's pooled r² (B-MOR's CV score,
    ``1 − Σ ss_res / Σ ss_tot``) and ``ridge_cv``'s mean of per-target r²
    are the same function of λ, and the two CV curves can be held
    against each other."""
    from repro_torch.core.foldstats import fold_bounds
    for lo, hi in fold_bounds(Y.shape[0], n_folds):
        blk = Y[lo:hi]
        blk -= blk.mean(0, keepdim=True)
        blk /= blk.std(0, correction=0, keepdim=True)
    return Y


def _dist_data(which: str, device):
    """The operands of phase 18, made on ``device`` from a seed: the
    ``whole_brain_mor`` and ``parcels`` cells (``DIST_N`` rows for the
    gloo runs), targets standardized within each fold of their CV."""
    import torch
    from repro_torch.core import complexity
    from repro_torch.data import fmri
    from repro_torch.encoding import EncoderConfig

    k = EncoderConfig().n_folds
    name, n, seed, folds = {
        "dual": ("whole_brain_mor", None, 181, k),
        "parcels": ("parcels", None, 182, k),
        "cut": ("parcels", DIST_N, 183, DIST_FOLDS)}[which]
    w = complexity.PAPER_WORKLOADS[name]
    spec = fmri.SubjectSpec(n=n or w.n, p=w.p, t=w.t)
    g = torch.Generator(torch.device(device).type).manual_seed(seed)
    X, Y, _ = fmri.generate(spec, g, device=device)
    return X, _fold_standardized(Y, folds)


def _holding_all(held: list):
    """``_patched`` triples that hold every ``xty_folds``, ``xty`` and
    ``xty_folds_masked`` launch against its plain version on its own
    operands; each appends ``(shapes, max abs err, max|plain|)`` to
    ``held``.  The plain calls launch nothing."""
    from repro_torch.kernels import ops, ref

    def holding(name, kernel, plain):
        def wrapper(x, y, *rest):
            out = kernel(x, y, *rest)
            third = f" s={len(rest[0]) if name == 'xty_folds' else rest[0].shape[1]}" \
                if rest else ""
            shapes = f"{name} x={tuple(x.shape)} z={tuple(y.shape)}{third}"
            err, scale = _compare(shapes, out, plain(x, y, *rest), "float32")
            held.append((shapes, err, scale))
            return out
        return wrapper

    return [(ops, name, holding(name, getattr(ops, name), getattr(ref, name)))
            for name in ("xty_folds", "xty", "xty_folds_masked")]


def _collectives(events) -> list[dict]:
    """The ``dist.psum``/``dist.gather`` spans of a trace: op, axis, bytes
    and seconds (the span waits for the card before and after)."""
    return [{"op": e["name"].split(".")[1], "axis": e["attrs"]["axis"],
             "bytes": e["attrs"]["bytes"], "s": e["dur_us"] / 1e6}
            for e in events if e["name"] in ("dist.psum", "dist.gather")
            and not e.get("instant")]


def _dist_child(spec_path: str) -> int:
    """One rank of phase 18's gloo worlds (started by
    ``torch.distributed.run``): ``spec["world"]`` "b" fits dual B-MOR 1×4
    at ``whole_brain_mor`` and primal B-MOR 2×2 on the store's rows; "c"
    the sharded streamed ``fit(store=)`` over 2 data ranks.  Every rank
    counts its launches; rank 0 holds each launch against its plain
    version and writes the results."""
    import numpy as np
    import torch
    from repro_torch.core import compat, ridge
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with open(spec_path) as f:
        spec = json.load(f)
    dev = compat.init_from_env("cuda", "gloo", timeout_s=spec["timeout_s"])
    rank = compat.rank()
    _build.load()
    if spec.get("after"):
        # Started beside another world: fit once that world is done.
        deadline = time.monotonic() + spec["timeout_s"]
        while not Path(spec["after"]).exists():
            if time.monotonic() > deadline:
                raise RuntimeError(f"{spec['after']} did not appear within "
                                   f"{spec['timeout_s']} s")
            time.sleep(0.2)
    out = Path(spec["out"])
    held: list = []
    res: dict = {"rank": rank, "device": str(dev), "seconds": {},
                 "launches": {}}
    patches = _holding_all(held) if rank == 0 else []
    arrays = {}

    def main_path(tag, fn):
        """``fn()`` as the main path: launches counted from zero (every
        rank), rank 0's held against plain; collectives from its trace."""
        _reset_counters()
        compat.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _patched(*patches), _traced() as tracer:
            enc = fn()
            torch.cuda.synchronize()
        res["seconds"][tag] = time.perf_counter() - t0
        res["launches"][tag] = _counters()
        res[f"{tag}_collectives"] = _collectives(tracer.events())
        res[f"{tag}_held"] = list(held)
        held.clear()
        rep = enc.report_
        res[f"{tag}_decision"] = [rep.decision.solver, rep.decision.method,
                                  rep.decision.data_shards,
                                  rep.decision.target_shards]
        res[f"{tag}_lam"] = rep.best_lambda.tolist()
        arrays[f"{tag}_W"] = enc.weights_.cpu().numpy()
        arrays[f"{tag}_cv"] = rep.cv_scores
        return enc

    if spec["world"] == "b":
        X, Y = _dist_data("dual", dev)
        enc = main_path("dual", lambda: BrainEncoder(
            solver="bmor_dual", device=dev).fit(X, Y))
        if rank == 0:
            # Each batch against the one-device dual solve of its columns
            # at that batch's λ (on the same K: ridge.factorize's xty).
            t0 = time.perf_counter()
            cfg = enc.config.ridge_cv_config("dual", device=dev)
            f = ridge.factorize(X, cfg)
            lams, W = enc.report_.best_lambda, enc.weights_
            width = Y.shape[1] // len(lams)
            errs = []
            for i, lam in enumerate(lams):
                cols = slice(i * width, (i + 1) * width)
                W_ref = ridge.solve(f, Y[:, cols], torch.tensor(
                    float(lam), device=dev), X=X, use_pallas=True)
                errs.append(_within("dual batch", W[:, cols], W_ref))
            res["dual_batch_err"] = max(errs)
            res["seconds"]["dual_check"] = time.perf_counter() - t0
        del X, Y, enc
        free()
        Xs, Ys = RunStore.open(spec["store"]).load()
        main_path("primal", lambda: BrainEncoder(
            solver="bmor", data_shards=2, target_shards=2,
            n_folds=DIST_FOLDS, device=dev).fit(Xs, Ys))
    else:
        store = RunStore.open(spec["store"])
        enc = main_path("streamed", lambda: BrainEncoder(
            n_folds=DIST_FOLDS, device_memory_budget=1,
            chunk_rows=DIST_CHUNK_ROWS, device=dev).fit(store=store))
        res["streamed_compiles"] = enc.stream_stats_["compile_count"]
    with open(out / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    if rank == 0:
        np.savez(out / "rank0.npz", **arrays)
    compat.barrier()
    compat.shutdown()
    return 0


def _within(name, got, want) -> float:
    """max |got − want|, checked against the f32 parity tolerance of the
    port's tests (rtol 1e-4, atol 2e-4)."""
    import torch
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    want = want.to(got.device)
    err = (got - want).abs().max().item()
    check(bool(torch.allclose(got, want, **DIST_TOL)),
          f"{name}: max abs err {err:.3e} outside rtol "
          f"{DIST_TOL['rtol']:g} / atol {DIST_TOL['atol']:g}")
    return err


def _torchrun(nproc: int, spec: dict) -> tuple:
    """Start ``python -m torch.distributed.run --nproc-per-node nproc
    chip_smoke.py --dist-child SPEC`` (``_torchrun_wait`` collects it)."""
    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    with open(out / "torchrun.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc), str(ROOT / "chip_smoke.py"),
             "--dist-child", str(path)], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     REPRO_OBS_STRICT="1",
                     # The ranks share one card: blocks a rank freed stay
                     # usable by its next allocation instead of
                     # fragmenting.
                     PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
            stdout=log, stderr=subprocess.STDOUT)
    return proc, nproc, spec, time.perf_counter()


def _torchrun_wait(tag: str, run: tuple, card: str) -> list[dict]:
    """Wait for a ``_torchrun`` world; it must exit 0 within its time
    limit (else it is killed).  → every rank's result."""
    proc, nproc, spec, t0 = run
    out = Path(spec["out"])
    try:
        rc = proc.wait(timeout=spec["timeout_s"] + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        print((out / "torchrun.log").read_text()[-12000:], file=sys.stderr)
    check(rc == 0, f"{tag}: torch.distributed.run of {nproc} gloo ranks "
          f"exited {rc}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(nproc)]
    print(f"[multidevice] {tag}: {nproc} gloo ranks sharing cuda:0 "
          f"exited 0 in {wall:.2f} s wall [{card}]")
    return ranks


def _print_world(tag: str, ranks: list[dict], card: str) -> dict:
    """Print a world's seconds, launches (summed over ranks), held
    launches and collectives; → the summed launches."""
    r0 = ranks[0]
    total: dict = {}
    for t in r0["launches"]:
        sums = {}
        for r in ranks:
            for k, v in r["launches"][t].items():
                sums[k] = sums.get(k, 0) + v
        launched = {k: v for k, v in sums.items() if v}
        print(f"[multidevice] {tag} {t}: {r0['seconds'][t]:.2f} s on rank 0 "
              f"(of ranks {[round(r['seconds'][t], 2) for r in ranks]}); "
              f"decision {r0[t + '_decision']}; λ {r0[t + '_lam']}; "
              f"launches over all ranks {launched} [{card}]")
        held = r0[t + "_held"]
        check(bool(held) and len(held) == sum(r0["launches"][t].values()),
              f"{tag} {t}: {len(held)} held of {r0['launches'][t]}")
        if held:
            worst = max(held, key=lambda h: h[1] / max(h[2], 1e-30))
            print(f"[multidevice]   rank 0's {len(held)} launches each held "
                  f"against plain on its own operands "
                  f"({'; '.join(sorted({h[0] for h in held}))}): worst max "
                  f"abs err {worst[1]:.3e} of max|plain| {worst[2]:.3e} "
                  f"(tol {REL_TOL:g}·max|plain|) [{card}]")
        for c in r0[t + "_collectives"]:
            print(f"[multidevice]   rank 0 {c['op']} over {c['axis']}: "
                  f"{c['bytes']} bytes in {c['s']:.4f} s "
                  f"({c['bytes'] / max(c['s'], 1e-9) / 1e9:.2f} GB/s; gloo "
                  f"through host memory and loopback TCP, not NVLink) "
                  f"[{card}]")
        for k, v in sums.items():
            total[k] = total.get(k, 0) + v
    return total


def _one_device_batches(X, Y, batches: dict, cfg) -> dict:
    """``ridge.ridge_cv`` on each column batch ``Y[:, lo:hi]`` of
    ``batches`` ({name: (lo, hi)}) on one device: its own steps
    (``foldstats.compute``, the downdated ``eigh`` of every split,
    ``ridge._fold_scores``, the argmax, the refit ``ridge.solve``), with the
    target-independent factorisations shared by the batches (a batch's
    result does not depend on the other columns).  → {name: (λ, W, cv)}."""
    import torch
    from repro_torch.core import foldstats, ridge

    n, p = X.shape
    stats = foldstats.compute(X, Y, cfg.n_folds, use_pallas=cfg.use_pallas)
    lams = ridge._lambda_grid(cfg, X.device)
    scores = {b: [] for b in batches}
    for f, (lo, hi) in enumerate(foldstats.fold_bounds(n, cfg.n_folds)):
        G_tr, C_tr = stats.train(f)
        G_tr.diagonal().add_(cfg.jitter)
        evals, Q = torch.linalg.eigh(G_tr)
        del G_tr
        A = torch.matmul(Q.T, C_tr)
        Bv = torch.matmul(X[lo:hi].float(), Q)
        for b, (c0, c1) in batches.items():
            scores[b].append(ridge._fold_scores(
                Bv, A[:, c0:c1].contiguous(), Y[lo:hi, c0:c1], evals, lams,
                cfg.scoring))
        del A, Bv, Q
    G = stats.G_total
    G.diagonal().add_(cfg.jitter)
    evals, Q = torch.linalg.eigh(G)
    factors = ridge.RidgeFactors(basis=Q, evals=evals, primal=True)
    out = {}
    for b, (c0, c1) in batches.items():
        cv = torch.stack(scores[b]).mean(0)
        best = torch.argmax(cv)
        out[b] = (lams[best].item(), ridge.solve(
            factors, stats.C_total[:, c0:c1], lams[best]), cv)
    return out


def phase_multidevice(card: str) -> dict:
    """Phase 18: B-MOR and dual B-MOR, the sharded streamed fit, over
    ``torch.distributed``.  → kernel launches of the main-path runs."""
    import numpy as np
    import torch
    from repro_torch.core import compat, ridge
    from repro_torch.data.store import RunStore
    from repro_torch.encoding import BrainEncoder

    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_", dir=build))
    try:
        # The rows of (b)'s primal fit and (c)'s store: parcels' p and t,
        # DIST_N rows.
        t0 = time.perf_counter()
        X, Y = _dist_data("cut", "cuda")
        store = RunStore.create(str(root / "store"), n_folds=DIST_FOLDS)
        for lo in range(0, DIST_N, RUN_ROWS):
            store.write(X[lo:lo + RUN_ROWS], Y[lo:lo + RUN_ROWS], f"run{lo}")
        del X, Y
        free()
        print(f"[multidevice] store of {DIST_N} rows × (16,384 + 444) "
              f"written in {time.perf_counter() - t0:.2f} s")
        spec = dict(store=str(root / "store"), timeout_s=DIST_TIMEOUT_S)
        # (b) Four gloo ranks on cuda:0: dual B-MOR 1×4, primal 2×2; and
        # (c) two gloo ranks: the sharded streamed fit of the same rows.
        # (c) starts with (b), so its start-up overlaps (b)'s work, but
        # its ranks wait for the gate file before they fit: both worlds'
        # fits at once do not fit one card.  The one-device check of (b)
        # and (c) runs here beside (c)'s fit.
        gate = root / "b_done"
        run_b = _torchrun(4, dict(spec, world="b", out=str(root / "b")))
        run_c = _torchrun(2, dict(spec, world="c", out=str(root / "c"),
                                  after=str(gate)))
        try:
            ranks_b = _torchrun_wait("(b)", run_b, card)
        except BaseException:
            run_c[0].kill()
            run_c[0].wait()
            raise
        finally:
            gate.touch()
        add(_print_world("(b)", ranks_b, card))
        r0 = ranks_b[0]
        check(r0["dual_decision"] == ["bmor_dual", "dual", 1, 4]
              and r0["primal_decision"] == ["bmor", "eigh", 2, 2],
              f"(b) decisions {r0['dual_decision']} {r0['primal_decision']}")
        for r in ranks_b:
            check(r["launches"]["dual"]["xty"] == 1
                  and r["launches"]["primal"]["xty_folds"] == 1,
                  f"(b) rank {r['rank']} launches {r['launches']}")
        print(f"[multidevice] (b) dual B-MOR 1×4: each batch's W against the "
              f"one-device dual solve of its columns at its λ: max abs err "
              f"{r0['dual_batch_err']:.3e} ({r0['seconds']['dual_check']:.2f} "
              f"s) [{card}]")
        t0 = time.perf_counter()
        Xs, Ys = RunStore.open(spec["store"]).load()
        X = torch.from_numpy(Xs).cuda()
        Y = torch.from_numpy(Ys).cuda()
        half = Y.shape[1] // 2
        cfg = BrainEncoder(n_folds=DIST_FOLDS, device="cuda").config \
            .ridge_cv_config("eigh", device="cuda")
        one = _one_device_batches(X, Y, {"b0": (0, half),
                                         "b1": (half, Y.shape[1]),
                                         "all": (0, Y.shape[1])}, cfg)
        one_s = time.perf_counter() - t0
        del X, Y, Xs, Ys
        ranks_c = _torchrun_wait("(c)", run_c, card)
        add(_print_world("(c)", ranks_c, card))
        rc0 = ranks_c[0]
        check(rc0["streamed_decision"] == ["ridge", "chunked", 2, 1]
              and rc0["streamed_compiles"] == 1,
              f"(c) decision {rc0['streamed_decision']}")
        per_rank = -(-DIST_N // 2 // DIST_CHUNK_ROWS)
        for r in ranks_c:
            check(r["launches"]["streamed"]["xty_folds_masked"] == per_rank,
                  f"(c) rank {r['rank']} launches {r['launches']}")
        b_arr = dict(np.load(Path(root / "b" / "rank0.npz")))
        c_arr = dict(np.load(Path(root / "c" / "rank0.npz")))
        errs = []
        for i, b in enumerate(("b0", "b1")):
            lam, W, cv = one[b]
            check(r0["primal_lam"][i] == lam, f"(b) batch {i} λ "
                  f"{r0['primal_lam'][i]} != one-device {lam}")
            cols = slice(i * half, (i + 1) * half)
            errs.append(_within(f"(b) batch {i} W", b_arr["primal_W"][:, cols],
                                W))
            errs.append(_within(f"(b) batch {i} CV", b_arr["primal_cv"][i],
                                cv))
        lam, W, cv = one["all"]
        check(rc0["streamed_lam"] == [lam], f"(c) λ {rc0['streamed_lam']} "
              f"!= in-memory {lam}")
        c_err = _within("(c) W", c_arr["streamed_W"], W)
        print(f"[multidevice] one device on the same {DIST_N} rows "
              f"({one_s:.2f} s beside (c)'s ranks, {DIST_FOLDS + 1} eighs "
              f"shared by the batches): (b) "
              f"B-MOR 2×2 batches λ {r0['primal_lam']} equal to ridge_cv of "
              f"their columns, W and CV curve max abs err {max(errs):.3e}; "
              f"(c) streamed over 2 ranks λ {lam:g} equal to the in-memory "
              f"fit, W max abs err {c_err:.3e} [{card}]")
        del one
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (a) NCCL, a world of one rank on cuda:0, initialised here.
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    init = root.with_name(root.name + "_nccl")
    dev = compat.init_from_env("cuda", "nccl",
                               init_method=f"file://{init}",
                               timeout_s=DIST_TIMEOUT_S)
    try:
        for which, solver, method, kernel in (
                ("parcels", "bmor", "eigh", "xty_folds"),
                ("dual", "bmor_dual", "dual", "xty")):
            X, Y = _dist_data(which, dev)
            held: list = []
            _reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _patched(*_holding_all(held)):
                enc = BrainEncoder(solver=solver, data_shards=1,
                                   target_shards=1, device=dev).fit(X, Y)
                torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = {k: v for k, v in _counters().items() if v}
            rep = enc.report_
            check(launches == {kernel: 1} and len(held) == 1,
                  f"(a) {solver} launches {launches}")
            check([rep.decision.solver, rep.decision.data_shards,
                   rep.decision.target_shards] == [solver, 1, 1],
                  f"(a) decision {rep.decision}")
            add(launches)
            t0 = time.perf_counter()
            one = ridge.ridge_cv(X, Y, enc.config.ridge_cv_config(
                method, device=dev))
            one_s = time.perf_counter() - t0
            check(rep.best_lambda.tolist() == [one.best_lambda.item()],
                  f"(a) {solver} λ {rep.best_lambda} != ridge_cv's "
                  f"{one.best_lambda.item()}")
            w_err = _within(f"(a) {solver} W", enc.weights_, one.weights)
            cv_err = _within(f"(a) {solver} CV", rep.cv_scores[0],
                             one.cv_scores)
            h = held[0] if held else ("", float("nan"), float("nan"))
            print(f"[multidevice] (a) NCCL world of one: {solver} 1×1 at "
                  f"n={X.shape[0]} p={X.shape[1]} t={Y.shape[1]} in "
                  f"{fit_s:.2f} s, launches {launches} (held against plain: "
                  f"max abs err {h[1]:.3e} of max|plain| {h[2]:.3e}); "
                  f"one-device ridge_cv {one_s:.2f} s: λ "
                  f"{rep.best_lambda[0]:g} equal, W max abs err {w_err:.3e}, "
                  f"CV max abs err {cv_err:.3e} [{card}]")
            del X, Y, enc, one
            free()
        add(_mesh_steps(dev, card))
    finally:
        compat.shutdown()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(k, None)
        init.unlink(missing_ok=True)
    return total


def _dry_run_counts(bundle, mesh, sharded, opt, batch, step_s: float,
                    peak_gib: float, card: str) -> None:
    """Phase 18(a)(iii), continued: the dry run's counter
    (``hlo_analysis.count_costs``) on this train step twice, on fake
    tensors as ``launch.dryrun`` traces it and on one more, untimed, real
    step on the card: FLOPs, bytes and collective bytes must be equal.
    Prints the dry run's roofline terms beside the measured step and its
    argument + temp bytes beside the card's peak allocation."""
    import torch
    from repro_torch.launch import dryrun, hlo_analysis, roofline_report

    t0 = time.perf_counter()
    fake = dryrun._compile(bundle, mesh)
    fake_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    with hlo_analysis.count_costs() as real:
        bundle.fn(sharded, opt, batch)
    torch.cuda.synchronize()
    got, want = fake.costs.as_dict(), real.as_dict()
    check(got == want, f"qwen3 train: the dry run's counts on fake "
          f"tensors {got} differ from a real step's {want}")
    coll = sum(got["collective_bytes"].values())
    f32 = hlo_analysis.roofline_terms(
        got["flops"], got["hlo_bytes"], coll,
        peak_flops=roofline_report.H100_PEAK_FLOPS)
    bf16 = hlo_analysis.roofline_terms(got["flops"], got["hlo_bytes"], coll)
    mem = fake.memory_analysis()
    dry_gib = (mem["argument_size_in_bytes"] +
               mem["temp_size_in_bytes"]) / 2**30
    print(f"[multidevice] (a) dry-run counter on the qwen3 train step "
          f"(fake trace {fake_s:.2f} s), fake = real: {got['flops']:.6e} "
          f"FLOPs, {got['hlo_bytes']:.6e} bytes unfused, collectives "
          f"{coll:.0f} B; predicted compute {f32['t_compute_s']:.4f} s at "
          f"the f32 rate (TF32 off), {bf16['t_compute_s']:.4f} s at the "
          f"bf16 peak, memory {f32['t_memory_s']:.4f} s at HBM3, beside "
          f"the measured {step_s:.4f} s/step; argument + temp "
          f"{dry_gib:.2f} GiB ({mem['argument_size_in_bytes'] / 2**30:.2f}"
          f" + {mem['temp_size_in_bytes'] / 2**30:.2f}) beside "
          f"max_memory_allocated {peak_gib:.2f} GiB [{card}]")


def _mesh_steps(dev, card: str) -> dict:
    """Phase 18(a), continued: ``build_step``'s sharded prefill, decode and
    train steps on a (1, 1) mesh in this process's NCCL world of one (see
    MESH_LM_B).  → the kernel launches of (i) and (ii)."""
    import dataclasses
    import torch
    from repro_torch import configs, convert
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import InputShape
    from repro_torch.models.params import leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.serving import ServeEngine, ServeRequest

    t_phase = time.perf_counter()
    mesh = make_host_mesh(model=1, device=dev)
    total = {"flash_attention": 0, "ssd_intra": 0}
    held, keep = {}, {}
    patches = _holding_lm(held, keep)

    # (i) gemma2-2b: the sharded prefill and decode against ServeEngine.
    cfg = _lm_cfg("gemma2-2b")
    model = build_model(cfg)
    g = torch.Generator("cuda").manual_seed(23)
    params = model.init(g, device=dev)
    prompts = torch.randint(1, cfg.vocab, (MESH_LM_B, MESH_LM_PROMPT),
                            generator=g, device=dev)
    sharded = convert.shard_params(params, cfg, mesh)
    pre = steps.build_step(cfg, mesh, InputShape(
        "p", MESH_LM_PROMPT, MESH_LM_B, "prefill"))
    dec = steps.build_step(cfg, mesh, InputShape(
        "d", MESH_LM_PROMPT, MESH_LM_B, "decode"))
    free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _patched(*patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = pre.fn(sharded, {"tokens": prompts})
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        launches = _counters()
        toks = []
        t0 = time.perf_counter()
        for i in range(MESH_LM_GEN):
            tok = torch.argmax(logits.to_local()[:, -1], -1).to(
                torch.int32)[:, None]
            toks.append(tok)
            if i < MESH_LM_GEN - 1:
                logits, cache = dec.fn(sharded, cache, tok,
                                       MESH_LM_PROMPT + i)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    dec_launches = {k: v - launches[k] for k, v in _counters().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(steps.is_dtensor(logits) and tuple(logits.shape) ==
          (MESH_LM_B, 1, cfg.vocab), f"gemma2 step logits {logits.shape}")
    check(launches == dict({k: 0 for k in launches},
                           flash_attention=cfg.n_layers),
          f"gemma2 sharded prefill launches {launches}")
    check(not any(dec_launches.values()), f"gemma2 decode launches "
          f"{dec_launches}")
    got = torch.cat(toks, 1).tolist()
    del sharded, cache, logits, pre, dec
    free()
    engine = ServeEngine(model, params, cfg, wave_size=MESH_LM_B,
                         prompt_len=MESH_LM_PROMPT, device=dev)
    want = [r.tokens for r in engine.serve([
        ServeRequest(p, max_new_tokens=MESH_LM_GEN)
        for p in prompts.tolist()])]
    check(got == want, f"gemma2: build_step's greedy tokens {got} differ "
          f"from ServeEngine's {want}")
    print(f"[multidevice] (a) build_step on a (1, 1) mesh, gemma2-2b full "
          f"depth, DTensor weights: prefill {MESH_LM_B} × {MESH_LM_PROMPT} "
          f"{pre_s:.3f} s (launches {launches}), {MESH_LM_GEN - 1} decode "
          f"steps {dec_s:.3f} s "
          f"({MESH_LM_B * (MESH_LM_GEN - 1) / dec_s:.1f} tok/s), peak "
          f"{peak:.2f} GiB; {MESH_LM_GEN} greedy tokens equal to "
          f"ServeEngine's [{card}]")
    total["flash_attention"] += launches["flash_attention"]
    del params, engine, model
    keep.clear()
    free()

    # (ii) zamba2-2.7b: the sharded prefill, kernels against plain, f32.
    base = configs.get_config("zamba2-2.7b")
    kern = _lm_cfg("zamba2-2.7b", param_dtype=torch.float32,
                   n_layers=len(base.pattern) * LM_F32_REPEATS)
    plain = configs.for_device(kern, "cpu")
    params = build_model(kern).init(g, device=dev)
    batch = synthetic.make_batch(g, kern, 1, MESH_HYBRID_SEQ, "prefill",
                                 device=dev)
    sharded = convert.shard_params(params, kern, mesh)
    shape = InputShape("p", MESH_HYBRID_SEQ, 1, "prefill")
    _reset_counters()
    with _patched(*patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, _ = steps.build_step(kern, mesh, shape).fn(sharded, batch)
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
    launches = _counters()
    lp, _ = steps.build_step(plain, mesh, shape).fn(sharded, batch)
    check(not any(_counters()[k] - launches[k] for k in launches),
          "zamba2: the plain step launched a kernel")
    lk, lp = lk.to_local(), lp.to_local()
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    n_mamba = LM_F32_REPEATS * sum(k == "mamba" for k in kern.pattern)
    check(launches["ssd_intra"] == n_mamba and
          launches["flash_attention"] == LM_F32_REPEATS,
          f"zamba2 sharded prefill launches {launches}")
    check(err <= LM_F32_TOL * scale, f"zamba2 sharded prefill logits "
          f"{err:.3e} > {LM_F32_TOL:g}·{scale:.3e}")
    print(f"[multidevice] (a) build_step, zamba2-2.7b {kern.n_layers} layers "
          f"f32, prefill 1 × {MESH_HYBRID_SEQ} {k_s:.3f} s, launches "
          f"{launches}, against the plain step: logits max err {err:.3e} of "
          f"max|logits| {scale:.4e} [{card}]")
    for k in total:
        total[k] += launches[k]
    del params, sharded, lk, lp, batch
    free()

    # (iii) qwen3-1.7b: sharded train steps against the plain update.
    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"),
                              n_layers=MESH_TRAIN_LAYERS,
                              param_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(g, device=dev)
    sharded = convert.shard_params(params, cfg, mesh)
    opt = adamw_init(sharded)
    bundle = steps.build_step(cfg, mesh, InputShape(
        "t", MESH_TRAIN_SEQ, MESH_TRAIN_B, "train"), opt=AdamWConfig())
    stream = synthetic.TokenStream(cfg, MESH_TRAIN_B, MESH_TRAIN_SEQ,
                                   device=dev)
    free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    got, step_s = [], []
    for i in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded, opt, met = bundle.fn(sharded, opt, stream.batch_at(i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        got.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(not any(_counters().values()), f"qwen3 train launched kernels "
          f"{_counters()} (training runs the plain paths)")
    check(all(steps.is_dtensor(t) for t in leaves(sharded)),
          "qwen3 train: the step did not return DTensors")
    _dry_run_counts(bundle, mesh, sharded, opt,
                    stream.batch_at(MESH_TRAIN_STEPS), min(step_s[1:]),
                    peak, card)
    del sharded, opt
    free()
    plain_opt = adamw_init(params)
    want = []
    for i in range(MESH_TRAIN_STEPS):
        loss, grads = steps._value_and_grad(model.loss, params,
                                            stream.batch_at(i))
        params, plain_opt, _ = adamw_update(AdamWConfig(), params, grads,
                                            plain_opt)
        want.append(float(loss))
        del grads
    check(all(abs(a - b) <= MESH_TRAIN_RTOL * abs(b)
              for a, b in zip(got, want)),
          f"qwen3 sharded train losses {got} != plain {want}")
    tokens = MESH_TRAIN_B * MESH_TRAIN_SEQ
    print(f"[multidevice] (a) build_step train, qwen3-1.7b {cfg.n_layers} of "
          f"28 layers f32, {MESH_TRAIN_B} × {MESH_TRAIN_SEQ}: losses {got} "
          f"(the plain update's {want}), s/step {step_s[0]:.3f} then "
          f"{[round(x, 3) for x in step_s[1:]]} "
          f"({tokens / min(step_s):.0f} tokens/s at best), peak "
          f"{peak:.2f} GiB [{card}]")
    del params, plain_opt, model
    free()
    print(f"[multidevice] (a) held launches: " + "; ".join(
        f"{k}: {v:.3e}" for k, v in held.items()) + f"; build_step part "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return total


# --------------------------------------------------------------------------
# Phase 19
# --------------------------------------------------------------------------
def _lm_cfg(arch: str, **over):
    """The arch's config on the card's kernel tier (``for_device``), the
    flash path reachable at LM_FLASH, with ``over`` applied."""
    import dataclasses
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(arch),
                              flash_threshold=LM_FLASH, flash_block=LM_FLASH,
                              **over)
    return configs.for_device(cfg, "cuda")


def _holding_lm(held: dict, keep: dict):
    """``_patched`` triples holding the first ``mha_flash`` and
    ``ssd_intra`` launch of each distinct operand shape and option set
    against its plain version on its own operands (``_close``: one bf16
    ulp for a bf16 output, 2e-4 for f32); ``held[key]`` is the max abs
    error.  The operands of each held flash launch are kept in ``keep``
    for timing.  The plain calls launch nothing."""
    from repro_torch.kernels import ops, ref

    flash, ssd_intra = ops.mha_flash, ops.ssd_intra

    def hold_flash(q, k, v, n_kv, *, causal=True, window=None,
                   softcap=None):
        out = flash(q, k, v, n_kv, causal=causal, window=window,
                    softcap=softcap)
        key = (f"mha_flash q={tuple(q.shape)} k={tuple(k.shape)} "
               f"causal={causal} window={window} softcap={softcap} "
               f"{str(q.dtype).removeprefix('torch.')}")
        if key not in held:
            held[key] = _close(key, out, ref.mha_flash(
                q, k, v, n_kv, causal=causal, window=window,
                softcap=softcap).contiguous())
            keep[key] = (q.clone(), k.clone(), v.clone(), n_kv, window,
                         softcap, causal)
        return out

    def hold_ssd(cb, la, x):
        out = ssd_intra(cb, la, x)
        key = (f"ssd_intra cb={tuple(cb.shape)} la={tuple(la.shape)} "
               f"x={tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}")
        if key not in held:
            held[key] = _close(key, out, ref.ssd_intra(cb, la, x))
        return out

    return [(ops, "mha_flash", hold_flash), (ops, "ssd_intra", hold_ssd)]


def _serve_in_process(tag: str, argv: list[str], card: str, patches
                      ) -> tuple[str, dict, float, float]:
    """``launch/serve.py``'s ``main(argv)`` (LLM mode) in this process,
    its kernel launches counted from zero.  → (output, launches, seconds,
    peak device GiB)."""
    import io
    import torch
    from repro_torch.launch import serve

    out = io.StringIO()
    free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _patched(*patches), contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in out.getvalue().splitlines():
        print(f"[lm]   {tag}: {line}")
    print(f"[lm] {tag}: serve {' '.join(argv)}: {wall:.2f} s in process "
          f"(parameter draw included), peak device memory {peak:.2f} GiB, "
          f"launches {launches} [{card}]")
    return out.getvalue(), launches, wall, peak


def _flash_bound_ms(b, s, h, n_kv, kd, window, softcap, card, t=None,
                    causal=True) -> tuple[float, str, float]:
    """The least time the card could take for one attention call, the
    largest of three: the function's two products per visible query-key
    pair (Q·Kᵀ and P·V) at the bf16 tensor-core rate, one exponential per
    pair (and a tanh with a softcap) at the SFU rate (bf16 peak / 256, as
    phase 7 takes it), and the bytes (q and the output at H heads and S
    rows, k and v at n_kv heads and T rows, bf16, each moved once).
    Visible pairs: causal, those a window leaves; else all S·T, T keys
    defaulting to S.  → (bound ms, "operations" or "bytes", the bf16
    design's bound ms: four products, P·V split into three bf16 terms)."""
    t = s if t is None else t
    if causal:
        w = s if window is None else min(window, s)
        pairs = w * (w + 1) / 2 + (s - w) * w
    else:
        pairs = s * t
    half = 2.0 * b * h * kd * pairs                # FLOPs of each product
    t_tc = 2 * half / bf16_peak(card)
    t_sfu = (2 if softcap else 1) * b * h * pairs / (bf16_peak(card) / 256)
    t_bytes = 2 * (b * h * s + b * n_kv * t) * kd * 2 / peaks(card)[1]
    by = "operations" if max(t_tc, t_sfu) >= t_bytes else "bytes"
    design = max(4 * half / bf16_peak(card), t_sfu, t_bytes)
    return max(t_tc, t_sfu, t_bytes) * 1e3, by, design * 1e3


def _greedy(model, params, batch, start: int, steps: int):
    """Prefill, then ``steps`` greedy tokens (the first from the prefill's
    logits) → (prefill logits, tokens (B, steps))."""
    import torch

    logits, cache = model.prefill(params, batch)
    first = logits
    toks = []
    for i in range(steps):
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks.append(tok)
        if i < steps - 1:
            logits, cache = model.decode_step(params, cache, tok, start + i)
    return first, torch.cat(toks, 1)


def phase_lm_serving(card: str) -> dict:
    """Phase 19: LM serving — the prefill and decode of every model
    family through the drivers and ``ServeEngine``.  → kernel launches of
    the serving runs (the f32 path comparison's are checks)."""
    import dataclasses
    import re
    import torch
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.kernels import attention, ref
    from repro_torch.models import build_model
    from repro_torch.models.params import param_bytes
    from repro_torch.serving import ServeEngine, ServeRequest

    total = {"flash_attention": 0, "ssd_intra": 0}
    held, keep = {}, {}
    patches = _holding_lm(held, keep)

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def numbers(out):
        pre = float(re.search(r"prefill: ([\d.]+)s", out).group(1))
        tps = float(re.search(r"\(([\d.]+) tok/s\)", out).group(1))
        toks = json.loads(re.search(r"sample tokens: (\[.*\])",
                                    out).group(1))
        return pre, tps, toks

    # (a) The hybrid at full width and depth through the driver.
    cfg = configs.get_config("zamba2-2.7b")
    out, launches, _, peak = _serve_in_process("zamba2-2.7b", LM_HYBRID,
                                               card, patches)
    pre, tps, toks = numbers(out)
    n_mamba = cfg.n_repeats * sum(k == "mamba" for k in cfg.pattern)
    check(launches == dict({k: 0 for k in launches}, ssd_intra=n_mamba)
          and n_mamba == 54, f"zamba2 serve launches {launches}")
    check("logits (8, 1, 32000)" in out and len(toks) == 12
          and all(0 <= t < cfg.vocab for t in toks), "zamba2 serve output")
    print(f"[lm] zamba2-2.7b full depth, B=8, prompt 256, 32 tokens: "
          f"prefill {pre:.2f} s, decode {tps:.1f} tok/s, peak "
          f"{peak:.2f} GiB, ssd_intra {launches['ssd_intra']} per prefill "
          f"[{card}]")
    add(launches)
    # (b) The dense default a user runs: serve --arch qwen3-1.7b.
    out, launches, _, peak = _serve_in_process(
        "qwen3-1.7b", ["--arch", "qwen3-1.7b", "--device", "cuda"], card,
        patches)
    pre, tps, toks = numbers(out)
    check(not any(launches.values()), f"qwen3 serve at the reference's "
          f"defaults reaches no kernel, launched {launches}")
    check("logits (2, 1, 151936)" in out and len(toks) == 12
          and all(0 <= t < 151_936 for t in toks), "qwen3 serve output")
    print(f"[lm] qwen3-1.7b full depth, B=2, prompt 16, 16 tokens: prefill "
          f"{pre:.2f} s, decode {tps:.1f} tok/s, peak {peak:.2f} GiB [{card}]")
    free()

    # (c) gemma2-2b through ServeEngine with the flash path on.
    def engine_run(tag, cfg, wave, prompt_len, gen, seed):
        model = build_model(cfg)
        g = torch.Generator("cuda").manual_seed(seed)
        t0 = time.perf_counter()
        params = model.init(g, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        timers = {"prefill": 0.0, "decode": 0.0}
        model.prefill = _timed(model.prefill, timers, "prefill")
        model.decode_step = _timed(model.decode_step, timers, "decode")
        prompts = torch.randint(1, cfg.vocab, (wave, prompt_len),
                                generator=g, device="cuda").tolist()
        engine = ServeEngine(model, params, cfg, wave_size=wave,
                             prompt_len=prompt_len, device="cuda")
        free()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        with _patched(*patches):
            res = engine.serve([ServeRequest(p, max_new_tokens=gen)
                                for p in prompts])
        launches = _counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(len(r.tokens) == gen and all(0 <= t < cfg.vocab
                                                for t in r.tokens)
                  for r in res), f"{tag}: served tokens")
        tps = wave * (gen - 1) / timers["decode"]
        print(f"[lm] {tag}: {param_bytes(model.param_defs()) / 1e9:.2f} GB "
              f"of bf16 weights drawn in {init_s:.2f} s; ServeEngine wave "
              f"{wave} × prompt {prompt_len}: prefill {timers['prefill']:.3f}"
              f" s, {gen - 1} decode steps {timers['decode']:.3f} s "
              f"({tps:.1f} tok/s), peak {peak:.2f} GiB, launches {launches} "
              f"[{card}]")
        del params, engine, model
        free()
        return launches

    cfg = _lm_cfg("gemma2-2b")
    launches = engine_run("gemma2-2b full depth", cfg, LM_WAVE, LM_PROMPT,
                          LM_GEN, 19)
    check(launches == dict({k: 0 for k in launches},
                           flash_attention=cfg.n_layers) and
          cfg.n_layers == 26, f"gemma2 engine launches {launches}")
    add(launches)
    # The held local and global launches, timed beside the plain version.
    for key, (q, k, v, n_kv, window, softcap, _) in keep.items():
        ms = time_ms(lambda: attention.mha_flash(
            q, k, v, n_kv, window=window, softcap=softcap), 3)
        plain_ms = time_ms(lambda: ref.mha_flash(
            q, k, v, n_kv, window=window, softcap=softcap), 1)
        bound, by, design = _flash_bound_ms(
            q.shape[0], q.shape[1], q.shape[2], n_kv, q.shape[3], window,
            softcap, card)
        print(f"[lm] flash {key}: max abs err {held[key]:.3e} (rtol "
              f"{FLASH_TOL['bfloat16']['rtol']:g}/atol "
              f"{FLASH_TOL['bfloat16']['atol']:g}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, library none (SDPA takes no "
              f"softcap), bound {bound:.3f} ms ({by}; the bf16 design's "
              f"{design:.3f} ms) [{card}]")
    check(len(keep) == 2, f"gemma2: {len(keep)} flash variants held, want "
          f"a local and a global one")
    keep.clear()
    free()

    # (d) MoE and VLM at full width, depth cut (their flash launches are
    # held, not timed).
    arch = "phi3.5-moe-42b-a6.6b"
    cfg = _lm_cfg(arch, n_layers=LM_CUT[arch])
    launches = engine_run(f"{arch} ({cfg.n_layers} of 32 layers)", cfg,
                          LM_WAVE, LM_CUT_PROMPT, LM_CUT_GEN, 20)
    check(launches == dict({k: 0 for k in launches},
                           flash_attention=cfg.n_layers),
          f"{arch} launches {launches}")
    add(launches)
    arch = "llava-next-34b"
    cfg = _lm_cfg(arch, n_layers=LM_CUT[arch])
    model = build_model(cfg)
    g = torch.Generator("cuda").manual_seed(21)
    params = model.init(g, device="cuda")
    batch = synthetic.make_batch(g, cfg, LM_WAVE, LM_CUT_PROMPT, "prefill",
                                 device="cuda")
    free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _patched(*patches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch)
        torch.cuda.synchronize()
        pre = time.perf_counter() - t0
        launches = _counters()
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        for i in range(LM_CUT_GEN - 1):
            logits, cache = model.decode_step(params, cache, tok,
                                              LM_CUT_PROMPT + i)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        dec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(logits).all()), "llava logits not finite")
    check(launches == dict({k: 0 for k in launches},
                           flash_attention=cfg.n_layers),
          f"{arch} launches {launches}")
    print(f"[lm] {arch} ({cfg.n_layers} of 60 layers): "
          f"{param_bytes(model.param_defs()) / 1e9:.2f} GB of bf16 weights; "
          f"prefill of {LM_WAVE} × ({LM_CUT_PROMPT // 2} prefix embeddings + "
          f"{LM_CUT_PROMPT // 2} tokens) {pre:.3f} s, {LM_CUT_GEN - 1} decode"
          f" steps {dec:.3f} s ({LM_WAVE * (LM_CUT_GEN - 1) / dec:.1f} "
          f"tok/s), peak {peak:.2f} GiB, launches {launches} [{card}]")
    add(launches)
    del params, model, cache, logits, batch
    keep.clear()
    free()
    print(f"[lm] held launches: " + "; ".join(
        f"{k}: {v:.3e}" for k, v in held.items()) + f" [{card}]")

    # (e) Kernel path against plain path, f32 then bf16, 2 repeats.
    for arch, seq in LM_F32.items():
        for dt in (torch.float32, torch.bfloat16):
            base = configs.get_config(arch)
            kern = _lm_cfg(arch, param_dtype=dt, n_layers=len(base.pattern)
                           * LM_F32_REPEATS)
            plain = configs.for_device(kern, "cpu")
            g = torch.Generator("cuda").manual_seed(22)
            params = build_model(kern).init(g, device="cuda")
            batch = synthetic.make_batch(g, kern, 1, seq, "prefill",
                                         device="cuda")
            _reset_counters()
            lk, tk = _greedy(build_model(kern), params, batch, seq,
                             LM_F32_GEN)
            launches = _counters()
            lp, tp = _greedy(build_model(plain), params, batch, seq,
                             LM_F32_GEN)
            check(not any(_counters()[k] - launches[k] for k in launches),
                  f"{arch}: the plain path launched a kernel")
            err = (lk - lp).abs().max().item()
            scale = lp.abs().max().item()
            same = int((tk == tp).sum())
            print(f"[lm] {arch} {kern.n_layers} layers, {str(dt)[6:]}, "
                  f"1 × {seq}: kernel path (launches {launches}) against "
                  f"the plain path: prefill logits max err {err:.3e} of "
                  f"max|logits| {scale:.4e}; {same} of {LM_F32_GEN} greedy "
                  f"tokens equal [{card}]")
            if dt == torch.float32:
                check(err <= LM_F32_TOL * scale, f"{arch} f32 logits "
                      f"{err:.3e} > {LM_F32_TOL:g}·{scale:.3e}")
                check(same == LM_F32_GEN, f"{arch} f32 greedy tokens differ")
                check(launches["flash_attention"] > 0,
                      f"{arch}: the kernel path launched no flash")
            del params, batch
            free()
    print(f"[lm] phase 19 launches {total} [{card}]")
    return total


def _flash_on(threshold: int):
    """A ``_patched`` triple: ``configs.for_device`` with the flash path
    reachable at ``threshold`` (flash_threshold = flash_block), so a
    driver that builds its config through it (``serve --arch``) runs the
    flash kernel on the card."""
    import dataclasses
    from repro_torch import configs

    orig = configs.for_device

    def for_device(cfg, device):
        return orig(dataclasses.replace(cfg, flash_threshold=threshold,
                                        flash_block=threshold), device)
    return (configs, "for_device", for_device)


def phase_audio(card: str) -> dict:
    """Phase 20: the audio family (EncDecLM) served, as a feature hook and
    against its plain path, then trained through ``launch/train.py``, all
    at seamless-m4t-medium's full width and depth.  → flash launches of
    (a) and (b) (those of (c) are checks)."""
    import dataclasses
    import io
    import math
    import re
    import torch
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import attention, ref
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.models.params import (count_params, param_bytes,
                                           tree_map)

    total = {"flash_attention": 0}
    held, keep = {}, {}
    patches = _holding_lm(held, keep)
    base = configs.get_config(AUDIO)
    L, L_enc = base.n_layers, base.n_encoder_layers
    n_par = count_params(build_model(base).param_defs())

    # (a) serve --arch at full width and depth, flash on at LM_FLASH.
    argv = ["--arch", AUDIO, "--batch", str(AUDIO_BATCH), "--prompt-len",
            str(AUDIO_FRAMES), "--gen", str(AUDIO_GEN), "--device", "cuda"]
    out, launches, wall, peak = _serve_in_process(
        AUDIO, argv, card, patches + [_flash_on(LM_FLASH)])
    pre = float(re.search(r"prefill: ([\d.]+)s", out).group(1))
    tps = float(re.search(r"\(([\d.]+) tok/s\)", out).group(1))
    toks = json.loads(re.search(r"sample tokens: (\[.*\])", out).group(1))
    check(launches == dict({k: 0 for k in launches},
                           flash_attention=L_enc) and L_enc == 12,
          f"{AUDIO} serve launches {launches}")
    check(f"logits ({AUDIO_BATCH}, 1, {base.vocab})" in out
          and len(toks) == 12 and all(0 <= t < base.vocab for t in toks),
          f"{AUDIO} serve output")
    print(f"[audio] {AUDIO} full depth ({n_par / 1e9:.3f} B parameters, "
          f"{param_bytes(build_model(base).param_defs()) / 1e9:.2f} GB "
          f"bf16), B={AUDIO_BATCH} × {AUDIO_FRAMES} frames, {AUDIO_GEN} "
          f"tokens: prefill {pre:.2f} s (the driver's line: the encoder, "
          f"the cross K/V of {L} layers and the first token), decode "
          f"{tps:.1f} tok/s, peak {peak:.2f} GiB, flash "
          f"{launches['flash_attention']} per prefill [{card}]")
    total["flash_attention"] += launches["flash_attention"]
    keep.clear()
    free()

    # (b) The feature hook: the kernel's three uses at model shapes, timed
    # on a warm second call, then once more with each use held.
    cfg = _lm_cfg(AUDIO)
    model = build_model(cfg)
    g = torch.Generator("cuda").manual_seed(23)
    params = model.init(g, device="cuda")
    batch = {"src_embeds": torch.randn(
                 AUDIO_FEAT_B, AUDIO_FRAMES, cfg.d_model, generator=g,
                 device="cuda").to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab,
                                     (AUDIO_FEAT_B, AUDIO_TOKENS),
                                     generator=g, device="cuda",
                                     dtype=torch.int32)}
    model.hidden_states(params, batch)                 # warm-up
    free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = model.hidden_states(params, batch)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with _patched(*patches):
        model.hidden_states(params, batch)
    check(tuple(h.shape) == (AUDIO_FEAT_B, AUDIO_TOKENS, cfg.d_model)
          and bool(torch.isfinite(h).all()), f"{AUDIO} features")
    check(launches == dict({k: 0 for k in launches},
                           flash_attention=L_enc + 2 * L),
          f"{AUDIO} feature hook launches {launches}")
    print(f"[audio] feature hook: {AUDIO_FEAT_B} × ({AUDIO_FRAMES} frames + "
          f"{AUDIO_TOKENS} tokens) → features {tuple(h.shape)} in "
          f"{feat_s:.3f} s ({AUDIO_FEAT_B * AUDIO_TOKENS / feat_s:.0f} "
          f"tokens/s), peak {peak:.2f} GiB, "
          f"launches {launches} [{card}]")
    total["flash_attention"] += launches["flash_attention"]
    del h
    kinds = {}
    for key, (q, k, v, n_kv, window, softcap, causal) in keep.items():
        kind = ("encoder" if not causal and q.shape[1] == k.shape[1]
                else "cross" if not causal else "decoder self")
        kinds[kind] = key
        ms = time_ms(lambda: attention.mha_flash(
            q, k, v, n_kv, causal=causal), 3)
        plain_ms = time_ms(lambda: ref.mha_flash(
            q, k, v, n_kv, causal=causal), 1)
        lib_name, lib_fn = _sdpa(q, k, v, causal=causal)
        lib_ms = time_ms(lib_fn, 3)
        bound, by, design = _flash_bound_ms(
            q.shape[0], q.shape[1], q.shape[2], n_kv, q.shape[3], None, None,
            card, t=k.shape[1], causal=causal)
        print(f"[audio] flash, {kind}: {key}: max abs err {held[key]:.3e} "
              f"(rtol {FLASH_TOL['bfloat16']['rtol']:g}/atol "
              f"{FLASH_TOL['bfloat16']['atol']:g}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, SDPA ({lib_name}) {lib_ms:.3f} ms, "
              f"bound {bound:.3f} ms ({by}; {100 * bound / ms:.0f}% of the "
              f"kernel's time, {100 * bound / lib_ms:.0f}% of SDPA's; the "
              f"bf16 design's {design:.3f} ms) [{card}]")
    check(sorted(kinds) == ["cross", "decoder self", "encoder"],
          f"{AUDIO}: flash uses held {sorted(kinds)}")
    keep.clear()
    del params, model, batch
    free()

    # (c) Kernel path against plain path in f32, 2 + 2 layers: the prefill
    # (the encoder's launches) and greedy decode, then the feature hook.
    kern = _lm_cfg(AUDIO, param_dtype=torch.float32,
                   n_layers=AUDIO_F32_LAYERS,
                   n_encoder_layers=AUDIO_F32_LAYERS)
    plain = configs.for_device(kern, "cpu")
    g = torch.Generator("cuda").manual_seed(24)
    params = build_model(kern).init(g, device="cuda")
    batch = {"src_embeds": torch.randn(1, AUDIO_FRAMES, kern.d_model,
                                       generator=g, device="cuda"),
             "tokens": torch.randint(0, kern.vocab, (1, AUDIO_TOKENS),
                                     generator=g, device="cuda",
                                     dtype=torch.int32)}
    first = dict(batch, tokens=batch["tokens"][:, :1],
                 decode_len=LM_F32_GEN + 1)
    _reset_counters()
    lk, tk = _greedy(build_model(kern), params, first, 1, LM_F32_GEN)
    hk = build_model(kern).hidden_states(params, batch)
    launches = _counters()
    lp, tp = _greedy(build_model(plain), params, first, 1, LM_F32_GEN)
    hp = build_model(plain).hidden_states(params, batch)
    check(_counters() == launches, f"{AUDIO}: the plain path launched a "
          f"kernel")
    # The prefill's encoder, then the hook's encoder, self and cross.
    check(launches["flash_attention"] == 4 * AUDIO_F32_LAYERS,
          f"{AUDIO} f32 kernel path launches {launches}")
    err, scale = (lk - lp).abs().max().item(), lp.abs().max().item()
    herr, hscale = (hk - hp).abs().max().item(), hp.abs().max().item()
    same = int((tk == tp).sum())
    print(f"[audio] {AUDIO} {AUDIO_F32_LAYERS} + {AUDIO_F32_LAYERS} layers, "
          f"f32, 1 × {AUDIO_FRAMES} frames: kernel path (launches "
          f"{launches}) against the plain path: prefill logits max err "
          f"{err:.3e} of max|logits| {scale:.4e}; features (+ "
          f"{AUDIO_TOKENS} tokens) max err {herr:.3e} of {hscale:.4e}; "
          f"{same} of {LM_F32_GEN} greedy tokens equal [{card}]")
    check(err <= LM_F32_TOL * scale, f"{AUDIO} f32 logits {err:.3e} > "
          f"{LM_F32_TOL:g}·{scale:.3e}")
    check(herr <= LM_F32_TOL * hscale, f"{AUDIO} f32 features {herr:.3e} "
          f"> {LM_F32_TOL:g}·{hscale:.3e}")
    check(same == LM_F32_GEN, f"{AUDIO} f32 greedy tokens differ")
    del params, batch, first, hk, hp
    free()

    # (d) Training through launch/train.py, each step timed on the card
    # and the last step's parameters kept; the device memory of each
    # AdamW update (held when it starts, its own peak) apart from the
    # peak of the forward and backward before it.
    step_s, trained, mem = [], {}, {"held": 0, "upd": 0, "fwd_bwd": 0}
    build = steps.build_train_step
    update = steps.adamw_update

    def measured_update(*args, **kwargs):
        torch.cuda.synchronize()
        mem["fwd_bwd"] = max(mem["fwd_bwd"], torch.cuda.max_memory_allocated())
        mem["held"] = max(mem["held"], torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        res = update(*args, **kwargs)
        torch.cuda.synchronize()
        mem["upd"] = max(mem["upd"], torch.cuda.max_memory_allocated())
        return res

    def timed_build(*args, **kwargs):
        bundle = build(*args, **kwargs)

        def fn(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bundle.fn(*a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            trained["params"] = res[0]
            return res
        return dataclasses.replace(bundle, fn=fn)

    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _patched((steps, "build_train_step", timed_build),
                  (steps, "adamw_update", measured_update)), \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        train.main(AUDIO_TRAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _counters()
    peak = max(mem["fwd_bwd"], mem["upd"],
               torch.cuda.max_memory_allocated()) / 2**30
    for line in out.getvalue().splitlines():
        print(f"[audio]   train: {line}")
    losses = [float(m) for m in re.findall(r"loss=(\S+)", out.getvalue())]
    n_steps = int(AUDIO_TRAIN[AUDIO_TRAIN.index("--steps") + 1])
    bsz = int(AUDIO_TRAIN[AUDIO_TRAIN.index("--batch") + 1])
    seq = int(AUDIO_TRAIN[AUDIO_TRAIN.index("--seq") + 1])
    check(len(losses) == n_steps == len(step_s)
          and all(math.isfinite(x) for x in losses)
          and out.getvalue().rstrip().endswith("done"),
          f"{AUDIO} train: losses {losses}")
    check(not any(launches.values()), f"{AUDIO} train launched kernels "
          f"{launches} (training runs the plain paths)")
    rest = sorted(step_s[1:])
    med = rest[len(rest) // 2]
    print(f"[audio] train {' '.join(AUDIO_TRAIN)}: {wall:.2f} s in process "
          f"(parameter draw included); step 0 {step_s[0]:.3f} s, steps "
          f"1-{n_steps - 1} median {med:.3f} s (min {rest[0]:.3f}, max "
          f"{rest[-1]:.3f}), {bsz * seq / med:.0f} tokens/s ({bsz} × "
          f"({seq // 2} frames + {seq - seq // 2} tokens)); loss "
          f"{losses[0]:.4f} → {losses[-1]:.4f} on fresh batches; peak "
          f"{peak:.2f} GiB: forward and backward {mem['fwd_bwd'] / 2**30:.2f}"
          f", the in-place AdamW update {mem['upd'] / 2**30:.2f} of which "
          f"{mem['held'] / 2**30:.2f} held when it starts [{card}]")
    # The gate: the trained parameters lower the loss of the first batch
    # the driver trained on (its initial parameters and batch redrawn from
    # the driver's seeds).  The driver's last-against-first comparison
    # (the reference's smoke-size gate) is printed above, not gated: each
    # step draws fresh uniform tokens, so the only learnable part is the
    # loss above log(vocab) that the random logits add, and 8 steps at lr
    # 3e-4 remove less of it than the spread between batches.
    cfg_t = configs.get_config(AUDIO)
    first_batch = TokenStream(cfg_t, bsz, seq, device="cuda").batch_at(0)
    model_t = build_model(cfg_t)
    with torch.no_grad():
        before = float(model_t.loss(model_t.init(
            torch.Generator("cuda").manual_seed(0), device="cuda"),
            first_batch))
        # The step's DTensors, by their local shards (the whole tensors
        # on the driver's (1, 1) mesh).
        after = float(model_t.loss(tree_map(steps.local, trained["params"]),
                                   first_batch))
    print(f"[audio] train: the first batch's loss {before:.4f} (the "
          f"driver's step 0: {losses[0]:.4f}) → {after:.4f} with the "
          f"trained parameters [{card}]")
    check(abs(before - losses[0]) < 1e-3, f"{AUDIO} train: the redrawn "
          f"first batch's loss {before:.4f} is not the driver's "
          f"{losses[0]:.4f}")
    check(after < before, f"{AUDIO} train: the trained parameters do not "
          f"lower the first batch's loss ({before:.4f} → {after:.4f})")
    del trained, model_t, first_batch
    free()
    print(f"[audio] held launches: " + "; ".join(
        f"{k}: {v:.3e}" for k, v in held.items()) + f" [{card}]")
    print(f"[audio] phase 20 launches {total} [{card}]")
    return total


# --------------------------------------------------------------------------
# Phase 21
# --------------------------------------------------------------------------
def _start_dry_runs() -> dict:
    """Phase 21's children, started at once in the background, each in its
    own process group, with no card visible: the baseline (``DRY_BASE``)
    and ``DRY_RUNS``; a thread watches them and then runs
    ``launch.roofline_report`` of the two records, so that only the
    printing is left for ``phase_dry_run``.  → the handle it collects."""
    import threading

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_", dir=build))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    runs = {"base": ["-c", DRY_BASE]}
    runs.update({tag: ["-m", *argv, "--json", str(root / f"{tag}.jsonl")]
                 for tag, argv in DRY_RUNS.items()})
    h = dict(root=root, procs={}, t0=time.perf_counter(), done={})
    for tag, argv in runs.items():
        with open(root / f"{tag}.out", "w") as fo, \
                open(root / f"{tag}.err", "w") as fe:
            h["procs"][tag] = subprocess.Popen(
                [sys.executable, *argv], cwd=ROOT, env=env, stdout=fo,
                stderr=fe, start_new_session=True)
        _lowest(h["procs"][tag])

    def chain():
        # Every child's resident set, read every 0.2 s while it runs;
        # then its exit code, peak and seconds after the start.
        deadline = h["t0"] + DRY_TIMEOUT_S
        peak = dict.fromkeys(h["procs"], 0)
        while len(h["done"]) < len(h["procs"]):
            for tag, proc in h["procs"].items():
                if tag in h["done"]:
                    continue
                peak[tag] = max(peak[tag], _rss(proc.pid))
                rc = proc.poll()
                if rc is None and time.perf_counter() > deadline:
                    rc = "timeout"
                if rc is not None:
                    h["done"][tag] = (rc, peak[tag],
                                      time.perf_counter() - h["t0"])
            time.sleep(0.2)
        if any(h["done"][tag][0] != 0 for tag in DRY_RUNS):
            return
        merged = root / "dry.jsonl"
        merged.write_text("".join((root / f"{tag}.jsonl").read_text()
                                  for tag in DRY_RUNS))
        t0 = time.perf_counter()
        argv = [sys.executable, "-m", "repro_torch.launch.roofline_report",
                str(merged)]
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        _lowest(proc)
        out, err = proc.communicate(timeout=300)
        h["report"] = subprocess.CompletedProcess(argv, proc.returncode,
                                                  out, err)
        h["report_s"] = time.perf_counter() - t0

    h["thread"] = threading.Thread(target=chain, daemon=True)
    h["thread"].start()
    return h


def _stop_dry_runs(h: dict | None) -> None:
    """End phase 21's children that still run, and delete their files."""
    if h is None:
        return
    for proc in h["procs"].values():
        if proc.returncode is None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    h["thread"].join(timeout=60)
    shutil.rmtree(h["root"], ignore_errors=True)


def _lowest(proc) -> None:
    """Run a phase 21 child at the lowest priority, so that the phases
    beside it, which print their times, keep the cores (best effort: a
    host that refuses leaves it as it is)."""
    try:
        os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
    except OSError as e:
        print(f"[dryrun] priority of child {proc.pid} left as it is: {e}")


def _rss(pid: int) -> int:
    """The resident set of a running process, in bytes: the larger of
    its VmHWM (its peak, where /proc has it) and its VmRSS (the card's
    host has only the second); 0 once it has ended.  Not ``ru_maxrss``:
    that keeps the high-water mark of the process image a child was
    forked from, this one's pages, across its exec."""
    out = 0
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(("VmHWM:", "VmRSS:")):
                    out = max(out, int(line.split()[1]) * 1024)
    except OSError:
        pass
    return out


def _dry_output(h: dict, tag: str) -> None:
    """Print a phase 21 child's output; its error tail if it failed."""
    rc = h["done"][tag][0]
    for line in (h["root"] / f"{tag}.out").read_text().splitlines():
        print(f"[dryrun]   {tag}: {line}")
    if rc != 0:
        print((h["root"] / f"{tag}.err").read_text()[-6000:],
              file=sys.stderr)
    check(rc == 0, f"phase 21's {tag} child exited {rc}")


def phase_dry_run(card: str, h: dict | None = None) -> None:
    """Phase 21: the dry run and ``perf`` on the card's host (children
    started by ``_start_dry_runs``, here if ``h`` is None), then
    ``launch.roofline_report`` of their records."""
    h = h or _start_dry_runs()
    try:
        t0 = time.perf_counter()
        h["thread"].join(timeout=DRY_TIMEOUT_S)
        waited = time.perf_counter() - t0
        check(not h["thread"].is_alive(), "phase 21's children did not end "
              f"within {DRY_TIMEOUT_S} s")
        _dry_output(h, "base")
        base = h["done"]["base"][1]
        print(f"[dryrun] baseline child (imports, fake world, mesh): peak "
              f"RSS {base / 2**30:.2f} GiB (sampled every 0.2 s)")
        check(base > 0, "phase 21: no resident set read for the baseline "
              "child")
        for tag, argv in DRY_RUNS.items():
            _dry_output(h, tag)
            _, rss, wall = h["done"][tag]
            with open(h["root"] / f"{tag}.jsonl") as f:
                (rec,) = [json.loads(line) for line in f]
            mem = rec["memory"]
            need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            print(f"[dryrun] {tag}: python -m {' '.join(argv)} had exited "
                  f"0 by {wall:.1f} s after the start "
                  f"(CUDA_VISIBLE_DEVICES=\"\"); trace {rec['compile_s']} s; "
                  f"peak RSS {rss / 2**30:.2f} GiB, {(rss - base) / 2**30:.2f}"
                  f" GiB over the baseline child, below argument + temp "
                  f"{need / 2**30:.2f} GiB a device [{card}]")
            check(rss > 0, f"phase 21: no resident set read for {tag}")
            check(rss - base < need, f"{tag}: peak RSS {rss} B, "
                  f"{rss - base} B over the baseline child's, is not below "
                  f"its record's argument + temp {need} B")
        res = h["report"]
        for line in res.stdout.splitlines():
            print(f"[dryrun]   roofline_report: {line}")
        if res.returncode != 0:
            print(res.stderr[-6000:], file=sys.stderr)
        check(res.returncode == 0, f"roofline_report exited "
              f"{res.returncode}")
        row = [line for line in res.stdout.splitlines()
               if line.startswith("| qwen3-1.7b | train_4k")]
        check(len(row) == 1, "roofline_report: no qwen3 train_4k row")
        ratio = float(row[0].split("|")[7].strip())
        check(DRY_BAND[0] < ratio < DRY_BAND[1], f"qwen3-1.7b train_4k "
              f"6ND/HLO {ratio} outside {DRY_BAND}")
        print(f"[dryrun] phase 21: qwen3-1.7b train_4k 6ND/HLO {ratio:.2f} "
              f"in {DRY_BAND}; roofline_report {h['report_s']:.1f} s; all "
              f"done {time.perf_counter() - h['t0']:.1f} s after the start, "
              f"{waited:.1f} s of it waited for here [{card}]")
    finally:
        _stop_dry_runs(h)


def _selected(argv: list[str]) -> set[int] | None:
    """``--only 14,16`` runs phase 1 and the listed independent phases
    (6 and 12 to 21) and prints no result lines: a quick check while
    working on them.  With no arguments every phase runs."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit("usage: chip_smoke.py [--only N[,N...]] "
                         "(N in 6, 12..21)")
    only = {int(v) for v in argv[1].split(",")}
    if not only <= {6, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21}:
        raise SystemExit(f"--only takes phases 6 and 12 to 21, got "
                         f"{sorted(only)}")
    return only


def main(argv: list[str]) -> int:
    import torch

    if argv[:1] == ["--kill-child"]:
        return _kill_child(argv[1])
    if argv[:1] == ["--dist-child"]:
        return _dist_child(argv[1])
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
                         (16, phase_serving), (17, phase_drivers),
                         (18, phase_multidevice),
                         (19, phase_lm_serving), (20, phase_audio),
                         (21, phase_dry_run)):
            if n in only:
                t0 = time.perf_counter()
                phase(card)
                print(f"[done] phase {n} passed in "
                      f"{time.perf_counter() - t0:.1f} s")
        print(f"[done] phases {sorted(only)} passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    def stamp(n: str) -> None:
        print(f"[time] phase {n} done, {time.perf_counter() - t_start:.1f} "
              f"s into the run")

    phase_kernels_small()
    phase_backbone_kernels_small()
    phase_seed_kernels_small()
    rec = phase_kernels_full(card, reps=3)
    stamp("2")
    launches = {}
    launches["xty_folds"], heldout = phase_primal(card)
    stamp("3")
    launches["xty"] = phase_dual(card)
    phase_paths()
    stamp("4-5")
    launches["xty_folds_masked"] = phase_streamed(card)
    stamp("6")
    rec.update(phase_backbone_kernels_full(card, reps=3))
    phase_backbone_f32_paths(card)
    backbone = phase_backbone(card)
    launches.update(flash_attention=backbone["flash_attention"],
                    ssd_intra=backbone["ssd_intra"])
    stamp("7-9")
    seed_rec, launches["pearson_r"] = phase_seed_kernels_full(card, heldout,
                                                              reps=3)
    rec.update(seed_rec)
    del heldout
    launches["solve_lambda_grid"] = phase_seed_primal(card)
    phase_seed_dual(card)
    stamp("10-11")
    launches["xty_folds_masked"] += phase_wholebrain(card)
    stamp("12")
    # Phase 17's whole-brain driver runs beside phases 13–16 (its
    # processes mostly start up); phase 17 collects and checks it.
    # Phase 21's dry runs (CPU children, no card) run beside them too.
    wb = _start_wholebrain_driver(card)
    wb["beside"] = ", beside phases 13–16 and 17(a), (c)"
    dry = _start_dry_runs()
    try:
        phase_wholebrain_parity(card)
        stamp("13")
        launches["xty"] += phase_mor(card)
        stamp("14")
        phase_banded(card)
        stamp("15")
        phase_serving(card)
        stamp("16")
        t0 = time.perf_counter()
        phase_dry_run(card, dry)
        print(f"[done] phase 21 (started beside phases 13–16) collected in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for k, v in phase_drivers(card, wb).items():
            launches[k] += v
    finally:
        _stop_driver(wb)
        _stop_dry_runs(dry)
        shutil.rmtree(wb["root"], ignore_errors=True)
    print(f"[done] phase 17 passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, v in phase_multidevice(card).items():
        launches[k] += v
    print(f"[done] phase 18 passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, v in phase_lm_serving(card).items():
        launches[k] += v
    print(f"[done] phase 19 passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, v in phase_audio(card).items():
        launches[k] += v
    print(f"[done] phase 20 passed in {time.perf_counter() - t0:.1f} s")
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
