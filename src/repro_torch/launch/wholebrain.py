"""Whole-brain demo — materialise → fit → save → serve under a memory cap.

Port of ``repro/launch/wholebrain.py``.  The paper's Table 1 whole-brain
subject (t≈264k targets) is the shape where even the row-streamed tier
dies: its accumulated ``(k, p, t)`` fold statistics alone are ~1 GB
(8-fold CV at p=128) and the unblocked statistics solve tops 1.4 GB
resident.  This driver runs the full loop on a synthetic subject of
exactly that target width (downscaled ``n`` — the target axis is what is
being proven) with every phase in its OWN subprocess, so each peak is an
honest per-phase high-water mark:

* **materialise** — ``RunStore.materialize_synthetic`` writes the
  CNeuroMod-shaped subject run by run (never holding (n, t)).
* **fit** (once per ``--t-block`` value) — ``wholebrain.fit_wholebrain``
  under a memory budget that dispatch resolves to ``method="colblocked"``;
  the child gates that the X-only Gram update and the column-block update
  each saw exactly one signature across all blocks, that X was read at
  most twice, and that its peaks stay under a cap the unblocked path
  provably could not survive (the child refuses to run if the unblocked
  estimate fits the cap).  The cap is ``--cap-mb``: the fit's
  ``device_memory_budget`` and the ceiling of the child's peak RSS
  (``ru_maxrss``).  On a CUDA device it caps the card's peak allocation
  (``torch.cuda.max_memory_allocated``) and the RSS the child adds over
  the RSS right after CUDA initialisation (``_rss_gate``), which the
  child reports beside the peak; a full-shape run on a card needs
  ``--cap-mb 1280``, the reference's own cap at this shape.  The first fit
  streams its weight shards through ``BundleWriter`` into an
  ``EncoderBundle``.
* **ab** — the same composition at a downscaled t on the plain path
  (``use_pallas=False``) and on the CUDA-kernel path (``use_pallas=True``),
  in turns, asserting bitwise λ parity and recording the roofline
  placement at the H100's peaks.  The kernels run only on a CUDA device:
  the child refuses otherwise, and a CPU parent records ``"fused_ab":
  null`` with the reason instead of spawning it.
* **crashfit** — the crash-resume gate's fits (``run_crash_gate``).
* **serve** — opens the bundle in an ``EncoderRegistry`` and serves
  column-windowed predictions (``EncoderService.predict_columns``),
  asserting only the touched weight shards were paged in.

Writes ``BENCH_wholebrain_torch.json`` (``…_smoke``/``…_crash`` for
``--smoke``/``--crash-only``): wall / peaks / bytes staged / signature
counts per fit, keyed by ``t_block``, plus the serve paging stats.
``--smoke`` shrinks ``n`` and the fold count (CI lane shape) — the target
axis stays FULL SCALE, so the cap proof is unchanged.

    python -m repro_torch.launch.wholebrain --device cpu --smoke
    python -m repro_torch.launch.wholebrain --crash-only --workdir W
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
_T_FULL = 262_144                       # paper Table 1 whole-brain order
_P = 128

# (n, n_folds, rows_per_run, chunk_rows, t_blocks)
_FULL = (1024, 8, 64, 256, (16_384, 20_480))   # 20_480: ragged 16k tail
_SMOKE = (256, 6, 64, 128, (16_384, 20_480))   # 20_480: ragged 16k tail


def _result(payload: dict) -> None:
    print("WHOLEBRAIN_RESULT " + json.dumps(payload), flush=True)


def _peak_rss_mb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _launches() -> dict:
    """The process's CUDA cross-Gram kernel launches so far, by kernel."""
    from repro_torch.kernels import gram
    return dict(gram.LAUNCHES)


def _device(args):
    from repro_torch.launch.obscli import resolve_device_arg
    return resolve_device_arg(args)


def _cuda_init_rss_mb(dev) -> tuple[float, float] | None:
    """On a CUDA device: initialise the CUDA stack the phases use (the
    context, then cuBLAS and cuSOLVER through one tiny ``eigh`` and the
    port's kernel library) and reset the card's peak allocation.  → the
    RSS high-water right after ``torch.cuda.init()`` and the context, and
    right after the whole stack: the runtime's share of the RSS, which
    ``_rss_gate`` does not charge to the phase.  The two apart show the
    libraries' share."""
    if dev.type != "cuda":
        return None
    import torch

    from repro_torch.kernels import _build
    torch.cuda.init()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    context = _peak_rss_mb()
    a = torch.eye(8, device=dev)
    torch.linalg.eigh(a @ a)
    _build.load()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return context, _peak_rss_mb()


def _rss_gate(what: str, cap_mb: float,
              init: tuple[float, float] | None) -> tuple[float, float]:
    """The per-phase RSS ceiling.  → (peak RSS, RSS the phase held).

    On the CPU the phase holds its whole peak (``ru_maxrss``), as in the
    reference, where the device is the host.  On a CUDA device the budget
    governs the card (the device-peak gate) and the host holds what the
    phase adds over the RSS right after CUDA initialisation: that alone
    can exceed any cap that still binds (on an H100 host that counts
    mapped library pages as resident, ``import torch`` measured 4,545 MB
    and the CUDA stack 5,038 MB).
    """
    peak = _peak_rss_mb()
    init_rss = None if init is None else init[1]
    held = peak - (init_rss or 0.0)
    if held >= cap_mb:
        raise SystemExit(
            f"{what} peaked at {peak:.0f} MB RSS"
            + ("" if init_rss is None else
               f", {held:.0f} MB over the {init_rss:.0f} MB right after "
               f"CUDA initialisation")
            + f" — over the {cap_mb} MB cap")
    return peak, held


def _rss_record(peak: float, held: float,
                init: tuple[float, float] | None) -> dict:
    """The result line's RSS keys: what the gate charged (``rss_held_mb``)
    and, on a CUDA device, both baselines and the RSS over the bare
    context (``rss_over_context_mb``, the libraries' pages included)."""
    return {"cuda_context_rss_mb": None if init is None else round(init[0], 1),
            "cuda_init_rss_mb": None if init is None else round(init[1], 1),
            "rss_held_mb": round(held, 1),
            "rss_over_context_mb": (None if init is None
                                    else round(peak - init[0], 1))}


def _device_peak_mb(dev) -> float | None:
    if dev.type != "cuda":
        return None
    import torch
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**20


def _materialise(args, dev) -> None:
    from repro_torch.data import fmri
    from repro_torch.data.store import MANIFEST_NAME, RunStore

    if not os.path.exists(os.path.join(args.store, MANIFEST_NAME)):
        spec = fmri.SubjectSpec(n=args.n, p=_P, t=args.t)
        RunStore.create(args.store, n_folds=args.n_folds)\
            .materialize_synthetic(spec, rows_per_run=args.rows_per_run,
                                   device=dev)


def phase_materialise(args) -> None:
    from repro_torch.data.store import RunStore

    dev = _device(args)
    t0 = time.time()
    _materialise(args, dev)
    store = RunStore.open(args.store)
    _result({"phase": "materialise", "wall_s": round(time.time() - t0, 2),
             "peak_rss_mb": round(_peak_rss_mb(), 1),
             "shape": list(store.shape),
             "store_gb": round(store.nbytes_resident() / 2**30, 2)})


def phase_fit(args) -> None:
    import numpy as np

    from repro_torch.data.store import RunStore
    from repro_torch.encoding.config import EncoderConfig
    from repro_torch.encoding.dispatch import chunked_stats_bytes, resolve
    from repro_torch.encoding.estimator import EncodingReport
    from repro_torch.wholebrain import BundleWriter, fit_wholebrain

    dev = _device(args)
    store = RunStore.open(args.store)
    n, p, t = store.shape
    cap_bytes = int(args.cap_mb * 2**20)
    # The cap must BIND: the unblocked statistics solve holds the
    # (k, p, p+t) fold statistics plus C_total/Â/W working arrays.  If
    # that estimate fits the cap, this run would prove nothing — refuse.
    unblocked_mb = (chunked_stats_bytes(args.n_folds, p, t)
                    + 3 * p * t * 4) / 2**20
    if unblocked_mb <= args.cap_mb:
        raise SystemExit(
            f"cap {args.cap_mb} MB does not bind: the unblocked path needs "
            f"only ~{unblocked_mb:.0f} MB — raise t or lower the cap")
    init = _cuda_init_rss_mb(dev)

    cfg = EncoderConfig(n_folds=args.n_folds, chunk_rows=args.chunk_rows,
                        device_memory_budget=cap_bytes,
                        target_block=args.t_block)
    decision = resolve(cfg, n, p, t, 1, device=dev)
    assert decision.method == "colblocked", decision
    t0 = time.time()
    if args.bundle:
        with BundleWriter(args.bundle, p=p, t=t, overwrite=True) as w:
            res = fit_wholebrain(store, cfg, t_block=decision.target_block,
                                 writer=w, collect=False,
                                 journal=args.journal or None, device=dev)
            report = EncodingReport(
                weights=None, best_lambda=res.best_lambda,
                cv_scores=res.cv_scores, lambdas=cfg.lambdas,
                decision=decision)
            w.commit(config=cfg, report=report,
                     lambda_by_target=res.lambda_by_target,
                     provenance={"source": "launch.wholebrain",
                                 "store": args.store,
                                 "t_block": decision.target_block})
    else:
        res = fit_wholebrain(store, cfg, t_block=decision.target_block,
                             collect=False, device=dev)
    wall = time.time() - t0
    tel = res.telemetry
    # THE deterministic gates (fresh process, so counts are absolute):
    # one signature for the X-only Gram accumulation, one for the
    # column-block update across ALL blocks — the fixed-shape contract on
    # both axes.
    if tel["gram_compile_delta"] != 1 or tel["colblock_compile_delta"] != 1:
        raise SystemExit(f"fixed-shape contract broken: gram compiled "
                         f"{tel['gram_compile_delta']}×, column-block "
                         f"update {tel['colblock_compile_delta']}×")
    # Single-X-pass composition gate: the stats pass rides block 0's
    # stream and the chunk cache replays X for blocks 1+, so X is read
    # at most twice (once + at worst a full re-stream when the cache
    # exceeds the budget) — never once per block.
    if tel["row_passes_x"] > 2:
        raise SystemExit(f"single-X-pass composition broken: "
                         f"{tel['row_passes_x']} row passes over X for "
                         f"{tel['n_blocks']} blocks (expected <= 2)")
    device_peak = _device_peak_mb(dev)
    if device_peak is not None and device_peak >= args.cap_mb:
        raise SystemExit(f"blocked fit peaked at {device_peak:.0f} MB on "
                         f"{dev} — over the {args.cap_mb} MB cap the "
                         f"unblocked path (~{unblocked_mb:.0f} MB) was "
                         f"excluded by")
    peak, held = _rss_gate(f"blocked fit (the unblocked path needs "
                           f"~{unblocked_mb:.0f} MB)", args.cap_mb, init)
    _result({"phase": "fit", "t_block": decision.target_block,
             "device": str(dev),
             "wall_s": round(wall, 2), "peak_rss_mb": round(peak, 1),
             **_rss_record(peak, held, init),
             "device_peak_mb": (None if device_peak is None
                                else round(device_peak, 1)),
             "unblocked_stats_mb": round(unblocked_mb, 1),
             "n_blocks": tel["n_blocks"],
             "bytes_staged_mb": round(tel["bytes_staged"] / 2**20, 1),
             "read_stall_s": round(tel["read_stall_s"], 2),
             "gram_compiles": tel["gram_compile_delta"],
             "colblock_compiles": tel["colblock_compile_delta"],
             "row_passes_x": tel["row_passes_x"],
             "x_cache_mb": round(tel["x_cache_bytes"] / 2**20, 2),
             "use_pallas": tel["use_pallas"],
             "kernel_launches": _launches(),
             "best_lambda": float(np.asarray(res.best_lambda)[0]),
             "saved_bundle": bool(args.bundle)})


def phase_ab(args) -> None:
    """Plain-vs-kernel A/B of the column-blocked fit (downscaled t).

    Runs the SAME composition (blocked CV, single-X-pass, chunk cache) with
    the kernel tier off and on, in turns (plain, kernel, kernel, plain),
    asserts λ is bitwise equal across all four fits, and places the faster
    side in roofline terms at the H100's data-sheet peaks.  The kernel
    tier runs only on a CUDA device; elsewhere the child refuses with
    ``EncoderConfig.resolve_use_pallas``'s message (the reference's
    interpret mode has no counterpart in the port).
    """
    import numpy as np
    import torch

    from repro_torch.data.store import RunStore
    from repro_torch.encoding.config import EncoderConfig
    from repro_torch.launch.roofline_report import (H100_MEM_BW,
                                                    H100_PEAK_FLOPS,
                                                    encoding_roofline)
    from repro_torch.wholebrain import fit_wholebrain

    dev = _device(args)
    try:
        EncoderConfig(use_pallas=True).resolve_use_pallas(dev)
    except ValueError as e:
        raise SystemExit(f"ab: the kernel-tier A/B {e}") from e
    _materialise(args, dev)
    store = RunStore.open(args.store)
    n, p, t = store.shape

    def run(up: bool):
        cfg = EncoderConfig(n_folds=args.n_folds,
                            chunk_rows=args.chunk_rows, use_pallas=up)
        t0 = time.time()
        res = fit_wholebrain(store, cfg, t_block=args.t_block,
                             collect=False, device=dev)
        torch.cuda.synchronize(dev)
        return time.time() - t0, res

    runs = {False: [], True: []}
    for up in (False, True, True, False):
        runs[up].append(run(up))
    lams = {float(np.asarray(res.best_lambda)[0])
            for side in runs.values() for _, res in side}
    if len(lams) != 1:
        raise SystemExit(f"λ diverged plain-vs-kernel: {sorted(lams)}")
    unfused_s = min(s for s, _ in runs[False])
    fused_s = min(s for s, _ in runs[True])
    fused = runs[True][0][1]
    if not fused.telemetry["use_pallas"]:
        raise SystemExit("the kernel side ran without the kernel tier")
    roof = encoding_roofline(n, p, t, n_folds=args.n_folds,
                             wall_s=min(unfused_s, fused_s),
                             peak_flops=H100_PEAK_FLOPS, mem_bw=H100_MEM_BW)
    _result({"phase": "ab", "n": n, "p": p, "t": t,
             "t_block": args.t_block, "chunk_rows": args.chunk_rows,
             "unfused_s": round(unfused_s, 3),
             "fused_s": round(fused_s, 3),
             "unfused_runs_s": [round(s, 3) for s, _ in runs[False]],
             "fused_runs_s": [round(s, 3) for s, _ in runs[True]],
             "kernel_tier": "cuda", "lambda_match": True,
             "row_passes_x": fused.telemetry["row_passes_x"],
             "kernel_launches": _launches(),
             "roofline": roof})


def phase_crashfit(args) -> None:
    """One blocked fit at crash-gate scale, journalled and optionally
    killed (``--kill-after-block``) or fed injected transient read
    faults (``--inject-read-faults``).

    Three invocations compose the parent's crash-resume gate: an
    uninterrupted reference, a child that ``os._exit``\\ s right after
    journalling block N (modelling SIGKILL — no cleanup handlers run),
    and a resume against the same journal that must replay blocks
    0..N and re-stream only the rest.  The child reports λ plus the
    resume/retry telemetry; bit-identity of the weight shards is the
    PARENT's check (raw ``.npy`` bytes across the two bundles).
    """
    import numpy as np

    from repro_torch import obs
    from repro_torch.data.store import RunStore
    from repro_torch.encoding.config import EncoderConfig
    from repro_torch.encoding.dispatch import resolve
    from repro_torch.encoding.estimator import EncodingReport
    from repro_torch.wholebrain import BundleWriter, fit_wholebrain
    from repro_torch.wholebrain.solver import journal_signature

    dev = _device(args)
    _materialise(args, dev)

    fault_policy = None
    injector = None
    if args.inject_read_faults:
        from repro_torch.resilience import faultsim
        from repro_torch.resilience.policy import FaultPolicy
        # Virtual time: retries are deterministic and the child never
        # actually sleeps — backoff delays only accumulate in a counter.
        fault_policy = FaultPolicy(max_attempts=3, seed=7).with_virtual_time()
        injector = faultsim.FaultInjector(seed=7)
        injector.plan("store.mmap", 1)        # first fold-matrix mmap
        injector.plan("store.chunk", 2)       # mid block 0's stream
        injector.plan("store.chunk", 7)       # a later block's re-stream
    store = RunStore.open(args.store, fault_policy=fault_policy)
    if injector is not None:
        from repro_torch.resilience import faultsim
        store = faultsim.wrap_store(store, injector)

    cfg = EncoderConfig(n_folds=args.n_folds, chunk_rows=args.chunk_rows,
                        target_block=args.t_block)
    journal = args.journal or None
    if journal is not None and args.kill_after_block >= 0:
        from repro_torch.resilience import faultsim
        from repro_torch.resilience.journal import FitJournal
        sig = journal_signature(store, cfg, t_block=args.t_block,
                                device=dev)
        journal = faultsim.KillAfterBlock(
            FitJournal.attach(journal, sig), args.kill_after_block)

    n, p, t = store.shape
    decision = resolve(cfg, n, p, t, 1, device=dev)
    t0 = time.time()
    with BundleWriter(args.bundle, p=p, t=t, overwrite=True) as w:
        res = fit_wholebrain(store, cfg, t_block=args.t_block,
                             writer=w, collect=False, journal=journal,
                             device=dev)
        report = EncodingReport(
            weights=None, best_lambda=res.best_lambda,
            cv_scores=res.cv_scores, lambdas=cfg.lambdas,
            decision=decision)
        w.commit(config=cfg, report=report,
                 lambda_by_target=res.lambda_by_target,
                 provenance={"source": "launch.wholebrain:crashfit"})
    tel = res.telemetry
    # Fixed-shape contract survives both resume and injected faults: the
    # column-block update sees exactly one signature; the Gram
    # accumulation one on a fresh fit and ZERO on resume (the X-stats
    # pass is replayed from the journal, never re-run).
    want_gram = 0 if tel["resumed"] else 1
    if (tel["gram_compile_delta"] != want_gram
            or tel["colblock_compile_delta"] != 1):
        raise SystemExit(
            f"fixed-shape contract broken under "
            f"{'resume' if tel['resumed'] else 'faults/clean run'}: gram "
            f"compiled {tel['gram_compile_delta']}× (want {want_gram}), "
            f"column-block update {tel['colblock_compile_delta']}×")
    counters = obs.snapshot().get("counters", {})
    retries = int(sum(v for k, v in counters.items()
                      if k.startswith("io_retries")))
    giveups = int(sum(v for k, v in counters.items()
                      if k.startswith("io_giveups")))
    if args.inject_read_faults and giveups:
        raise SystemExit(f"injected transient faults escalated to "
                         f"{giveups} give-ups")
    _result({"phase": "crashfit", "wall_s": round(time.time() - t0, 2),
             "n_blocks": tel["n_blocks"],
             "resumed": tel["resumed"],
             "blocks_replayed": tel["blocks_replayed"],
             "blocks_streamed": tel["blocks_streamed"],
             "row_passes_x": tel["row_passes_x"],
             "bytes_staged": tel["bytes_staged"],
             "gram_compiles": tel["gram_compile_delta"],
             "colblock_compiles": tel["colblock_compile_delta"],
             "io_retries": retries, "io_giveups": giveups,
             "kernel_launches": _launches(),
             "best_lambda": float(np.asarray(res.best_lambda)[0])})


def phase_serve(args) -> None:
    import numpy as np

    from repro_torch.serving_encoders.bundle import EncoderBundle
    from repro_torch.serving_encoders.registry import EncoderRegistry
    from repro_torch.serving_encoders.service import EncoderService

    dev = _device(args)
    init = _cuda_init_rss_mb(dev)
    t0 = time.time()
    bundle = EncoderBundle.open(args.bundle)
    p, t = bundle.shape
    reg = EncoderRegistry(device_memory_budget=64 * 2**20, wave_rows=64,
                          device=dev)
    reg.add("wholebrain", args.bundle)
    svc = EncoderService(reg, wave_rows=64)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((100, p)).astype(np.float32)
    # Three windowed requests: two distinct windows, then a repeat (cache
    # hit).  Each must page in ONLY its own shards.
    windows = [(1_000, 3_000), (t // 2 + 100, t // 2 + 2_100),
               (1_000, 3_000)]
    expect = set()
    for lo, hi in windows:
        P = svc.predict_columns("wholebrain", X, (lo, hi))
        if P.shape != (100, hi - lo):
            raise SystemExit(f"windowed serve shape {P.shape}")
        # Reference straight off the mmap'd shards.
        idxs = bundle.shards_for_columns(lo, hi)
        expect |= {("wholebrain", i) for i in idxs}
        cols = np.concatenate(
            [np.asarray(bundle.load_weight_shard(i, mmap=True),
                        np.float32) for i in idxs], axis=1)
        first = bundle.weight_shard_bounds()[idxs[0]][0]
        ref = X @ cols[:, lo - first:hi - first]
        if not np.allclose(P, ref, atol=1e-4):
            raise SystemExit("windowed serve mismatch")
    st = reg.stats()
    # The acceptance criterion: only the shards the windows touched are
    # resident — never the full bundle, never an untouched shard.
    if (st["loaded"] != 0 or set(reg.loaded_shards) != expect
            or st["shard_loads"] != len(expect) or st["shard_hits"] <= 0):
        raise SystemExit(f"shard paging wrong: {st}, resident "
                         f"{reg.loaded_shards}, expected {sorted(expect)}")
    peak, held = _rss_gate("serve", args.cap_mb, init)
    _result({"phase": "serve", "device": str(dev),
             "wall_s": round(time.time() - t0, 2),
             "peak_rss_mb": round(peak, 1),
             **_rss_record(peak, held, init),
             "weight_shards": bundle.manifest["weight_shards"],
             "shards_paged": st["shard_loads"],
             "shard_hits": st["shard_hits"],
             "resident_mb": round(st["resident_bytes"] / 2**20, 2),
             "compile_count": svc.compile_count})


def _spawn(phase: str, extra: list[str], *, device: str,
           expect_code: int = 0) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.wholebrain",
         "--phase", phase, "--device", device] + extra,
        capture_output=True, text=True, env=env)
    if proc.returncode != expect_code:
        raise SystemExit(f"{phase} child exited {proc.returncode} "
                         f"(expected {expect_code}):\n{proc.stdout}\n"
                         f"{proc.stderr}")
    if expect_code != 0:
        return {}            # a killed child never prints a result line
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("WHOLEBRAIN_RESULT ")][-1]
    return json.loads(line[len("WHOLEBRAIN_RESULT "):])


_CRASH_EXIT = 42             # KillAfterBlock's os._exit code


def run_crash_gate(workdir, *, n_folds: int, rows_per_run: int,
                   smoke: bool, kill_after_block: int, obs_extra,
                   device: str) -> dict:
    """The crash-resume gate: reference fit → killed fit → resumed fit.

    Asserts the resume replayed exactly the journalled blocks, streamed
    only the remainder (strictly fewer bytes staged than the reference),
    selected a bit-equal λ, and wrote weight shards whose raw ``.npy``
    bytes match the uninterrupted bundle's.  A fourth fit with injected
    transient read faults must retry through them with identical λ and
    unchanged signature counts.
    """
    import filecmp

    cg_n, cg_t, cg_tb, cg_chunk = ((128, 512, 128, 64) if smoke
                                   else (256, 1024, 256, 64))
    store = os.path.join(workdir, f"crash_subject_{cg_n}x{_P}x{cg_t}")
    base = ["--store", store, "--n", str(cg_n), "--t", str(cg_t),
            "--t-block", str(cg_tb), "--n-folds", str(n_folds),
            "--chunk-rows", str(cg_chunk),
            "--rows-per-run", str(rows_per_run)]
    bundle_ref = os.path.join(workdir, "crash_bundle_ref")
    bundle_res = os.path.join(workdir, "crash_bundle_resumed")
    jdir = os.path.join(workdir, "crash_journal")
    # Idempotent on a reused workdir: a previous run's artifacts would
    # otherwise spoof the "killed child published nothing" assertion.
    for stale in (bundle_ref, bundle_res, jdir):
        if os.path.isdir(stale):
            shutil.rmtree(stale)

    ref = _spawn("crashfit", base + ["--bundle", bundle_ref]
                 + obs_extra("crashref"), device=device)
    n_blocks = ref["n_blocks"]
    if not 0 <= kill_after_block < n_blocks - 1:
        raise SystemExit(f"--kill-after-block {kill_after_block} leaves "
                         f"nothing to resume ({n_blocks} blocks)")
    _spawn("crashfit", base + [
        "--bundle", bundle_res, "--journal", jdir,
        "--kill-after-block", str(kill_after_block)],
        device=device, expect_code=_CRASH_EXIT)
    if not os.path.isdir(jdir):
        raise SystemExit("killed child left no journal to resume from")
    if os.path.isdir(bundle_res):
        raise SystemExit("killed child published a bundle — the atomic "
                         "commit boundary leaked")
    res = _spawn("crashfit", base + ["--bundle", bundle_res,
                                     "--journal", jdir]
                 + obs_extra("crashresume"), device=device)

    want_replayed = kill_after_block + 1
    if (not res["resumed"] or res["blocks_replayed"] != want_replayed
            or res["blocks_streamed"] != n_blocks - want_replayed):
        raise SystemExit(f"resume accounting wrong: {res} (expected "
                         f"{want_replayed} replayed of {n_blocks})")
    if res["bytes_staged"] >= ref["bytes_staged"]:
        raise SystemExit(f"resume re-streamed as much as a fresh fit "
                         f"({res['bytes_staged']} vs "
                         f"{ref['bytes_staged']} bytes)")
    if res["best_lambda"] != ref["best_lambda"]:
        raise SystemExit(f"λ diverged across crash-resume: "
                         f"{res['best_lambda']} vs {ref['best_lambda']}")
    step_ref = os.path.join(bundle_ref, "step_0")
    step_res = os.path.join(bundle_res, "step_0")
    shards = sorted(f for f in os.listdir(step_ref) if f.startswith("W__"))
    if not shards or shards != sorted(
            f for f in os.listdir(step_res) if f.startswith("W__")):
        raise SystemExit("resumed bundle's weight shard set differs")
    for fname in shards:
        if not filecmp.cmp(os.path.join(step_ref, fname),
                           os.path.join(step_res, fname), shallow=False):
            raise SystemExit(f"weight shard {fname} not bit-identical "
                             f"after crash-resume")
    if os.path.isdir(jdir):
        raise SystemExit("journal survived a successful resume")

    faulty = _spawn("crashfit", base + [
        "--bundle", os.path.join(workdir, "crash_bundle_faulty"),
        "--inject-read-faults"] + obs_extra("crashfaulty"), device=device)
    if faulty["best_lambda"] != ref["best_lambda"]:
        raise SystemExit(f"λ diverged under injected read faults: "
                         f"{faulty['best_lambda']} vs "
                         f"{ref['best_lambda']}")
    if faulty["io_retries"] < 3 or faulty["io_giveups"]:
        raise SystemExit(f"fault injection did not exercise the retry "
                         f"path: {faulty}")
    return {"kill_after_block": kill_after_block, "n_blocks": n_blocks,
            "w_shards_bitwise": len(shards), "ref": ref, "resumed": res,
            "faulty": faulty}


def _print_crash(crash: dict) -> None:
    print(f"[wholebrain] crash-resume: killed after block "
          f"{crash['kill_after_block']}, resumed "
          f"{crash['resumed']['blocks_replayed']} replayed + "
          f"{crash['resumed']['blocks_streamed']} streamed of "
          f"{crash['n_blocks']}, {crash['w_shards_bitwise']} W shards "
          f"bit-identical; faulty run retried "
          f"{crash['faulty']['io_retries']}× with λ parity", flush=True)


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.obscli import (add_device_arg, add_obs_args,
                                           obs_session)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default=None,
                    help="(internal) child mode: "
                         "materialise|fit|ab|crashfit|serve")
    ap.add_argument("--store", default=None)
    ap.add_argument("--bundle", default=None)
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--t", type=int, default=_T_FULL,
                    help="target count (full whole-brain scale by default)")
    ap.add_argument("--n-folds", type=int, default=0)
    ap.add_argument("--rows-per-run", type=int, default=64)
    ap.add_argument("--chunk-rows", type=int, default=0)
    ap.add_argument("--t-block", type=int, default=0)
    ap.add_argument("--cap-mb", type=float, default=1024.0,
                    help="per-phase memory ceiling (peak RSS; on a CUDA "
                         "device the card's peak allocation and the RSS "
                         "added after CUDA initialisation); must be fatal "
                         "to the unblocked path (the fit child checks it "
                         "binds).  A full-shape run on a card needs 1280, "
                         "the reference's own cap at this shape: its "
                         "t_block 20,480 fit adds ~1,130 MB of RSS there")
    ap.add_argument("--smoke", action="store_true",
                    help="CI shape: downscaled n/folds, FULL-SCALE t")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--journal", default=None,
                    help="progress-journal dir: makes the fit resumable "
                         "(repro_torch.resilience.FitJournal)")
    ap.add_argument("--kill-after-block", type=int, default=-1,
                    help="crash gate: the killed child os._exits right "
                         "after journalling this block index (parent "
                         "default: block 1)")
    ap.add_argument("--inject-read-faults", action="store_true",
                    help="(crashfit child) seeded transient faults on "
                         "chunk reads + fold-matrix mmaps")
    ap.add_argument("--crash-only", action="store_true",
                    help="run ONLY the crash-resume gate (CI faults lane)")
    add_device_arg(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)

    if args.phase:                                 # child mode
        with obs_session(args):
            {"materialise": phase_materialise, "fit": phase_fit,
             "ab": phase_ab, "serve": phase_serve,
             "crashfit": phase_crashfit}[args.phase](args)
        return

    import tempfile

    device = str(_device(args))
    n, n_folds, rows_per_run, chunk_rows, t_blocks = (
        _SMOKE if args.smoke else _FULL)
    n = args.n or n
    n_folds = args.n_folds or n_folds
    chunk_rows = args.chunk_rows or chunk_rows
    workdir = args.workdir or tempfile.mkdtemp(prefix="wholebrain_")
    store = os.path.join(workdir, f"subject_{n}x{_P}x{args.t}")
    bundle = os.path.join(workdir, "bundle")
    if args.out is None:
        # Smoke runs with an explicit workdir keep their artifact there
        # (CI lanes read it from $RUNNER_TEMP); real runs land at the root,
        # beside (never over) the reference's BENCH_wholebrain*.json.
        out_root = workdir if args.smoke and args.workdir else REPO
        args.out = os.path.join(
            out_root, "BENCH_wholebrain_torch_crash.json" if args.crash_only
            else "BENCH_wholebrain_torch_smoke.json" if args.smoke
            else "BENCH_wholebrain_torch.json")

    kab = args.kill_after_block if args.kill_after_block >= 0 else 1

    def obs_extra(tag: str) -> list[str]:
        # Phase children own the tracer: fan the parent's obs flags out
        # with a phase-suffixed path per subprocess.
        extra = []
        for flag, path in (("--trace-out", args.trace_out),
                           ("--metrics-out", args.metrics_out)):
            if path is not None:
                root, ext = os.path.splitext(path)
                extra += [flag, f"{root}.{tag}{ext}"]
        return extra

    if args.crash_only:
        crash = run_crash_gate(workdir, n_folds=n_folds,
                               rows_per_run=rows_per_run, smoke=args.smoke,
                               kill_after_block=kab, obs_extra=obs_extra,
                               device=device)
        _print_crash(crash)
        with open(args.out, "w") as f:
            json.dump({"smoke": args.smoke, "device": device,
                       "crash_resume": crash}, f, indent=2)
            f.write("\n")
        print(f"# wrote {args.out}")
        return

    print(f"[wholebrain] materialising {n}x{_P}x{args.t} subject ...",
          flush=True)
    mat = _spawn("materialise", [
        "--store", store, "--n", str(n), "--t", str(args.t),
        "--n-folds", str(n_folds), "--rows-per-run", str(rows_per_run)]
        + obs_extra("materialise"), device=device)
    print(f"[wholebrain] materialise: {mat['wall_s']}s "
          f"rss={mat['peak_rss_mb']}MB store={mat['store_gb']}GB",
          flush=True)

    fits = []
    for i, t_block in enumerate(t_blocks):
        extra = ["--store", store, "--t-block", str(t_block),
                 "--n-folds", str(n_folds), "--chunk-rows", str(chunk_rows),
                 "--cap-mb", str(args.cap_mb)] \
            + obs_extra(f"fit{t_block}")
        if i == 0:
            extra += ["--bundle", bundle]
        fit = _spawn("fit", extra, device=device)
        fits.append(fit)
        on_card = ("" if fit["device_peak_mb"] is None else
                   f" (held {fit['rss_held_mb']}MB over "
                   f"{fit['cuda_init_rss_mb']}MB after CUDA init; "
                   f"{fit['rss_over_context_mb']}MB over the bare context) "
                   f"device_peak={fit['device_peak_mb']}MB")
        print(f"[wholebrain] fit t_block={t_block}: {fit['wall_s']}s "
              f"rss={fit['peak_rss_mb']}MB{on_card} (unblocked would need "
              f"{fit['unblocked_stats_mb']}MB) blocks={fit['n_blocks']} "
              f"staged={fit['bytes_staged_mb']}MB "
              f"compiles={fit['gram_compiles']}+{fit['colblock_compiles']} "
              f"λ={fit['best_lambda']}", flush=True)
    lams = {f["best_lambda"] for f in fits}
    if len(lams) != 1:
        raise SystemExit(f"λ selection diverged across t_block values: "
                         f"{lams}")

    # Plain-vs-kernel A/B at a downscaled t; λ parity is asserted in the
    # child.  The kernel tier exists only on a CUDA device.
    ab_n, ab_t, ab_tb, ab_chunk = ((128, 512, 128, 64) if args.smoke
                                   else (512, 2048, 512, 128))
    ab_reason = None
    if device.startswith("cuda"):
        ab_store = os.path.join(workdir, f"ab_subject_{ab_n}x{_P}x{ab_t}")
        ab = _spawn("ab", ["--store", ab_store, "--n", str(ab_n),
                           "--t", str(ab_t), "--t-block", str(ab_tb),
                           "--n-folds", str(n_folds),
                           "--chunk-rows", str(ab_chunk),
                           "--rows-per-run", str(rows_per_run)]
                    + obs_extra("ab"), device=device)
        roof = ab["roofline"]
        print(f"[wholebrain] kernel A/B ({ab_n}x{_P}x{ab_t}, "
              f"{ab['kernel_tier']}): plain {ab['unfused_s']}s vs kernel "
              f"{ab['fused_s']}s, λ match, x passes={ab['row_passes_x']}, "
              f"{roof['peak_fraction']:.2e} of the H100 f32 peak "
              f"({roof['bottleneck']}-bound)", flush=True)
    else:
        ab = None
        ab_reason = (f"the kernel tier runs only on a CUDA device, not "
                     f"{device}: no A/B")
        print(f"[wholebrain] kernel A/B skipped: {ab_reason}", flush=True)

    crash = run_crash_gate(workdir, n_folds=n_folds,
                           rows_per_run=rows_per_run, smoke=args.smoke,
                           kill_after_block=kab, obs_extra=obs_extra,
                           device=device)
    _print_crash(crash)

    serve = _spawn("serve", ["--bundle", bundle,
                             "--cap-mb", str(args.cap_mb)]
                   + obs_extra("serve"), device=device)
    print(f"[wholebrain] serve: {serve['wall_s']}s "
          f"rss={serve['peak_rss_mb']}MB paged "
          f"{serve['shards_paged']}/{serve['weight_shards']} shards "
          f"({serve['resident_mb']}MB resident)", flush=True)

    payload = {"n": n, "p": _P, "t": args.t, "n_folds": n_folds,
               "chunk_rows": chunk_rows, "rss_cap_mb": args.cap_mb,
               "smoke": args.smoke, "device": device, "materialise": mat,
               "fit_vs_t_block": fits, "fused_ab": ab,
               "fused_ab_reason": ab_reason,
               "crash_resume": crash, "serve": serve}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
