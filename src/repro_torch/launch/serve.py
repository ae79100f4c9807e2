"""Serving driver: batched LLM decode, or the brain-encoder serving loop
and its worker fleet.

Port of ``repro/launch/serve.py``, with the reference's flags, printed
lines and gates; ``--device`` (default CUDA, which fails without a card)
is the port's one addition, and the fleet parent forwards it to its
workers.

LLM mode (prefill + greedy decode)::

    python -m repro_torch.launch.serve --arch <id> --smoke --batch 2 \
        --prompt-len 16 --gen 16

builds the arch's model with random weights (``init`` from a seeded
``torch.Generator``), prefills a random batch and decodes ``--gen``
greedy tokens; on CUDA the hand-written kernels run where the model's
switches reach them (``configs.for_device``).  The audio arch
(``seamless-m4t-medium``, ``EncDecLM``) prefills ``--prompt-len`` source
frames and one token, and decodes from position 1, as the reference
does; as there, its self cache then holds one position (the prefill
batch has one token and no ``decode_len``), so every decoded token
attends to itself alone in self-attention.

Encoder mode (materialise → fit → save → serve loop)::

    python -m repro_torch.launch.serve --encoders 3 --bundle-dir /tmp/b \
        --serve-steps 5 --wave-rows 64

fits one ``BrainEncoder`` per synthetic subject, persists each as an
``EncoderBundle``, then serves wave-batched prediction traffic against the
bundle fleet through ``EncoderRegistry`` + ``EncoderService`` — the
"fit once, serve many" workflow end to end.

Fleet mode — N workers, ONE artifact dir, shared page cache::

    python -m repro_torch.launch.serve --encoders 6 --bundle-dir /tmp/b \
        --workers 4 --serve-steps 5

``--workers N`` fits the fleet once in the parent, then launches N worker
*processes* against the same bundle directory (on one card, each worker
holds its own CUDA context).  Each worker runs its own ``FleetRegistry``
(mmap'd read-only weight reads) and publishes its loads/evictions to the
shared file-locked ``residency.json``; the parent prints the fleet
residency view when the workers drain.  Per-worker knobs: ``--worker-id``
(set by the parent), ``--max-pending-rows`` (bounded admission — overflow
is a typed rejection, not a stall), and ``--replay-trace PATH`` to serve
the checked-in deterministic mixed-traffic trace instead of random ragged
traffic.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def _run_fleet_parent(args, dev) -> None:
    """Fit the fleet once, launch ``--workers`` child processes against
    the shared bundle dir, then print the fleet residency view."""
    import json

    from repro_torch.serving_encoders import RESIDENCY_MAP, ResidencyMap
    from repro_torch.serving_encoders.traffic import (build_synthetic_fleet,
                                                      load_trace)

    # Fit ONCE in the parent so the workers never race on bundle writes —
    # they open the finished artifacts read-only.
    if args.replay_trace is None:
        build_synthetic_fleet(args.bundle_dir, args.encoders,
                              n=args.n, p=128, t=args.targets, device=dev)
    else:
        spec = load_trace(args.replay_trace)
        build_synthetic_fleet(args.bundle_dir, spec.n_models,
                              n=args.n, p=spec.p, t=spec.t, device=dev)
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    env["PYTHONPATH"] = src + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    base = [sys.executable, "-m", "repro_torch.launch.serve",
            "--device", str(dev),
            "--bundle-dir", args.bundle_dir,
            "--n", str(args.n), "--targets", str(args.targets),
            "--wave-rows", str(args.wave_rows),
            "--serve-steps", str(args.serve_steps),
            "--requests-per-step", str(args.requests_per_step),
            "--budget-mb", str(args.budget_mb),
            "--max-pending-rows", str(args.max_pending_rows)]
    if args.encoders is not None:
        base += ["--encoders", str(args.encoders)]
    if args.replay_trace is not None:
        base += ["--replay-trace", args.replay_trace]

    def worker_argv(wid: str) -> list[str]:
        # Observability flags fan out per worker: each process owns its
        # tracer/registry, so each gets a worker-suffixed output path.
        argv = base + ["--worker-id", wid]
        for flag, path in (("--trace-out", args.trace_out),
                           ("--metrics-out", args.metrics_out)):
            if path is not None:
                root, ext = os.path.splitext(path)
                argv += [flag, f"{root}.{wid}{ext}"]
        return argv

    kill_idx = args.kill_worker
    if kill_idx >= args.workers:
        raise SystemExit(f"--kill-worker {kill_idx} but only "
                         f"{args.workers} workers")
    procs = []
    for i in range(args.workers):
        argv = worker_argv(f"w{i}")
        if i == kill_idx:
            argv += ["--self-kill-after-flush", "1"]
        procs.append(subprocess.Popen(argv, env=env))
    codes = [proc.wait() for proc in procs]
    rmap = ResidencyMap(os.path.join(args.bundle_dir, RESIDENCY_MAP))

    killed_id = None
    if kill_idx >= 0:
        # The liveness gate: one worker SIGKILLs itself mid-trace.  Its
        # lease (residency row) survives it; a replacement under a FRESH
        # id re-runs the victim's workload so the drain still completes;
        # expire_dead must then reap exactly the dead id's stale claim.
        import signal
        if codes[kill_idx] != -signal.SIGKILL:
            raise SystemExit(f"worker w{kill_idx} should have died by "
                             f"SIGKILL mid-trace, exited {codes[kill_idx]}")
        codes[kill_idx] = 0
        killed_id = f"w{kill_idx}"
        restart = subprocess.Popen(worker_argv(f"w{kill_idx}r"), env=env)
        rc = restart.wait()
        if rc:
            raise SystemExit(f"restarted worker w{kill_idx}r exited {rc}")

    print(f"fleet residency after drain: "
          f"{json.dumps(rmap.snapshot(), sort_keys=True)}")
    if any(codes):
        raise SystemExit(f"worker exit codes {codes}")

    if killed_id is not None:
        rows = rmap.snapshot()["workers"]
        if killed_id not in rows:
            raise SystemExit(f"{killed_id} died without leaving a lease — "
                             f"nothing proves expiry works")
        survivors = sorted(w for w in rows if w != killed_id)
        if survivors:
            raise SystemExit(f"cleanly-drained workers left rows behind: "
                             f"{survivors}")
        # Deterministic TTL: the parent observes the dead stamp strictly
        # in its past, so half the observed age expires exactly that row.
        now = time.time()
        age = now - rows[killed_id]["heartbeat"]
        dead = rmap.expire_dead(age / 2, now=now)
        if dead != [killed_id]:
            raise SystemExit(f"expire_dead reaped {dead}, "
                             f"expected [{killed_id!r}]")
        if rmap.snapshot()["workers"]:
            raise SystemExit("stale lease survived expire_dead")
        print(f"lease gate: {killed_id} SIGKILLed after 1 flush, "
              f"w{kill_idx}r re-ran its trace, stale lease "
              f"(age {age:.2f}s) expired ✓")
    print(f"{args.workers} workers drained cleanly ✓")


def _run_encoder_mode(args, dev) -> None:
    import numpy as np

    from repro_torch.serving_encoders import (RESIDENCY_MAP, EncoderRegistry,
                                              EncoderService, FleetFrontend,
                                              FleetRegistry, ResidencyMap)
    from repro_torch.serving_encoders.fleet import replay
    from repro_torch.serving_encoders.traffic import (build_synthetic_fleet,
                                                      load_trace,
                                                      ragged_requests,
                                                      replay_requests)

    if args.workers > 1 and args.worker_id is None:
        _run_fleet_parent(args, dev)
        return

    spec = None
    if args.replay_trace is not None:
        # The trace pins the fleet's shapes and size — serve exactly the
        # workload the benchmarks replay.
        spec = load_trace(args.replay_trace)
        p, t, n_models = spec.p, spec.t, spec.n_models
    else:
        p, t, n_models = 128, args.targets, args.encoders
    fleet = build_synthetic_fleet(args.bundle_dir, n_models,
                                  n=args.n, p=p, t=t, device=dev)

    reg_kw = dict(device_memory_budget=int(args.budget_mb * 2**20),
                  wave_rows=args.wave_rows, device=dev)
    if args.worker_id is not None:
        rmap = ResidencyMap(os.path.join(args.bundle_dir, RESIDENCY_MAP))
        registry = FleetRegistry(worker_id=args.worker_id,
                                 residency_map=rmap, **reg_kw)
    else:
        registry = EncoderRegistry(**reg_kw)
    for name, path in fleet:
        registry.add(name, path)
    service = EncoderService(registry, wave_rows=args.wave_rows,
                             prefetch_next=True)
    frontend = FleetFrontend(service,
                             max_pending_rows=args.max_pending_rows)
    tag = f"[{args.worker_id}] " if args.worker_id else ""
    names = [name for name, _ in fleet]

    if args.self_kill_after_flush > 0:
        # Fault-injection hook for the fleet liveness gate: die by real
        # SIGKILL right after the Nth flush lands — the residency row
        # (lease) published during that flush is left stale on disk.
        import signal
        inner_flush = frontend.flush
        flushes = [0]

        def _flush_then_die(**kw):
            out = inner_flush(**kw)
            flushes[0] += 1
            if flushes[0] >= args.self_kill_after_flush:
                os.kill(os.getpid(), signal.SIGKILL)
            return out

        frontend.flush = _flush_then_die

    if spec is not None:
        reqs = replay_requests(spec, names)
        t0 = time.perf_counter()
        results, rejections = replay(frontend, reqs)
        wall = (time.perf_counter() - t0) * 1e3
        faults = sum(1 for r in results if r is not None and r.error)
        print(f"{tag}replayed {len(reqs)} trace requests in {wall:.1f} ms "
              f"({len(rejections)} backpressure rejections, "
              f"{faults} faults)")
    else:
        # Per-worker seed: distinct traffic per worker.  As in the
        # reference, str hashes are salted per process unless
        # PYTHONHASHSEED is set, so a worker's draw varies between runs.
        seed = 0 if args.worker_id is None else \
            abs(hash(args.worker_id)) % 2**31
        rng = np.random.default_rng(seed)
        step_ms = []
        for step in range(args.serve_steps):
            for req in ragged_requests(rng, names, p, args.wave_rows,
                                       args.requests_per_step):
                try:
                    frontend.submit(req)
                except Exception:
                    frontend.flush()
                    frontend.submit(req)
            t0 = time.perf_counter()
            frontend.flush()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if args.worker_id is not None:
                # Explicit lease refresh between serving windows — a
                # steady-state worker whose residency stops changing
                # would otherwise look dead to expire_dead.
                registry.heartbeat()
        warm = step_ms[1:] or step_ms          # first step pays the compile
        print(f"{tag}served {args.serve_steps} steps × "
              f"{args.requests_per_step} requests: "
              f"p50={np.percentile(warm, 50):.1f} ms "
              f"p99={np.percentile(warm, 99):.1f} ms per step "
              f"(first/cold {step_ms[0]:.1f} ms)")
    import json as _json
    s = service.stats
    print(f"{tag}waves={s.waves} rows={s.rows} pad_rows={s.pad_rows} "
          f"compiled_predicts={service.compile_count} (1 per wave shape) "
          f"tenants={len(s.per_tenant)}")
    print(f"{tag}service: {_json.dumps(s.to_dict(), sort_keys=True)}")
    print(f"{tag}registry: {registry.stats()}")
    if args.worker_id is not None:
        registry.close()


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.obscli import (add_device_arg, add_obs_args,
                                           obs_session, resolve_device_arg)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LLM mode: model architecture id")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    # -- encoder serving mode ------------------------------------------------
    ap.add_argument("--encoders", type=int, default=None,
                    help="encoder mode: number of synthetic subjects to "
                         "materialise → fit → save → serve")
    ap.add_argument("--bundle-dir", default="encoder_bundles",
                    help="where EncoderBundles are saved/reused")
    ap.add_argument("--n", type=int, default=512,
                    help="encoder mode: time samples per subject")
    ap.add_argument("--targets", type=int, default=256)
    ap.add_argument("--wave-rows", type=int, default=64,
                    help="fixed wave shape (rows) of the predict program")
    ap.add_argument("--serve-steps", type=int, default=5)
    ap.add_argument("--requests-per-step", type=int, default=8)
    ap.add_argument("--budget-mb", type=float, default=256.0,
                    help="registry device-memory budget (LRU eviction)")
    # -- fleet mode ----------------------------------------------------------
    ap.add_argument("--workers", type=int, default=1,
                    help="fleet mode: launch N worker processes against "
                         "one bundle dir (shared page cache via mmap'd "
                         "weights + file-locked residency.json)")
    ap.add_argument("--worker-id", default=None,
                    help="run as ONE fleet worker under this id "
                         "(normally set by the --workers parent)")
    ap.add_argument("--max-pending-rows", type=int, default=4096,
                    help="bounded-admission queue depth in rows; overflow "
                         "is a typed ServiceError rejection (backpressure)")
    ap.add_argument("--replay-trace", default=None,
                    help="encoder mode: serve this checked-in mixed-traffic "
                         "trace (e.g. benchmarks/traces/mixed_v1.json) "
                         "instead of random ragged traffic")
    ap.add_argument("--kill-worker", type=int, default=-1,
                    help="fleet liveness gate: SIGKILL this worker index "
                         "after its first flush, restart it under a fresh "
                         "id, and assert expire_dead reaps the stale lease")
    ap.add_argument("--self-kill-after-flush", type=int, default=0,
                    help="(internal worker hook) raise SIGKILL on self "
                         "right after the Nth flush")
    add_device_arg(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device_arg(args)

    if args.encoders is not None or args.replay_trace is not None:
        if args.workers > 1 and args.worker_id is None:
            # The fleet parent fits the fleet but serves nothing — the obs
            # flags fan out to the workers (suffixed paths), not to the
            # parent.
            _run_encoder_mode(args, dev)
        else:
            with obs_session(args):
                _run_encoder_mode(args, dev)
        return
    if args.arch is None:
        ap.error("--arch is required in LLM mode (or pass --encoders N)")
    _run_llm_mode(args, dev)


def _run_llm_mode(args, dev) -> None:
    import torch

    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import build_model

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.smoke(cfg)
    cfg = configs.for_device(cfg, dev)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev.type).manual_seed(0), device=dev)

    batch = make_batch(torch.Generator(dev.type).manual_seed(1), cfg,
                       args.batch, args.prompt_len, kind="prefill",
                       device=dev)
    t0 = clock()
    logits, cache = model.prefill(params, batch)
    print(f"prefill: {clock()-t0:.2f}s  logits {tuple(logits.shape)}")

    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    start_pos = args.prompt_len if cfg.family != "audio" else 1
    out_tokens = [tok]
    t0 = clock()
    for i in range(args.gen - 1):
        logits, cache = model.decode_step(params, cache, tok, start_pos + i)
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        out_tokens.append(tok)
    dt = clock() - t0
    toks = torch.cat(out_tokens, dim=1)
    print(f"decoded {args.gen} tokens × batch {args.batch} in {dt:.2f}s "
          f"({args.gen*args.batch/max(dt,1e-9):.1f} tok/s)")
    print("sample tokens:", toks[0, :12].tolist())


if __name__ == "__main__":
    main()
