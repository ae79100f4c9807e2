"""Brain-encoding driver — the paper's full pipeline, end to end.

Port of ``repro/launch/encode.py``: stimulus features (backbone hidden
states or synthetic VGG16-shaped features) → ``BrainEncoder`` (solver
picked by complexity-driven dispatch from the problem shape and the number
of ranks: the mutualised RidgeCV on one, B-MOR or dual B-MOR on several)
→ Pearson-r encoding map + null permutation control.  The flags, phases
and printed lines are the reference's; ``--device`` (default CUDA, which
fails without a card) and ``--dist-backend`` are the port's additions.

    python -m repro_torch.launch.encode --device cpu --backbone vgg16
    python -m repro_torch.launch.encode --backbone zamba2-2.7b --n 8192
    python -m repro_torch.launch.encode --store DIR --budget-mb 64
    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.encode --solver bmor

Under ``torch.distributed.run`` every rank runs the whole pipeline on the
same data; the device count is the world size (the reference's
``jax.device_count()``), the process group is ``nccl`` on CUDA and
``gloo`` on the CPU (``--dist-backend gloo`` for ranks sharing one card),
and only rank 0 prints its lines and writes bundles and reports.

On CUDA the in-memory fits launch the ``xty_folds`` kernel, the streamed
``--store`` fits ``xty_folds_masked``, and the backbones' SSD within-chunk
term ``ssd_intra`` (the kernel tier is on iff the device is CUDA:
``EncoderConfig.use_pallas=None`` for the fit, ``configs.for_device`` for
the backbone).  ``--solver bmor|bmor_dual`` needs a process group (one
rank is enough), and ``--target-shards`` at most the world's ranks.
Every architecture gives its final hidden states as features: a ``vlm``
batch carries the vision stub's prefix rows as well, and for the audio
arch (``seamless-m4t-medium``) they are the decoder's, one row per
target token of a batch with as many source frames, as in the reference.
"""
from __future__ import annotations

import argparse
import sys


def _run_store_mode(args, dev) -> None:
    """Out-of-core path: materialise a synthetic subject once, stream it.

    ``--store DIR`` either opens an existing ``RunStore`` or writes one
    (CNeuroMod-shaped synthetic runs via ``materialize_synthetic``), then
    fits through ``BrainEncoder.fit(store=...)`` under ``--budget-mb`` —
    dispatch pins the streamed fold-statistics path whenever the resident
    estimate exceeds the budget.
    """
    import os

    from repro_torch.core import compat
    from repro_torch.data import fmri
    from repro_torch.data.store import MANIFEST_NAME, RunStore
    from repro_torch.encoding import BrainEncoder, EncoderConfig
    from repro_torch.encoding.dispatch import estimated_resident_bytes

    existing = os.path.exists(os.path.join(args.store, MANIFEST_NAME))
    compat.barrier()            # every rank looked before rank 0 writes
    if existing:
        store = RunStore.open(args.store)
        print(f"opened store {args.store}: shape {store.shape}")
    else:
        spec = fmri.SubjectSpec(n=args.n, p=128, t=args.targets)
        if compat.rank() == 0:
            store = RunStore.create(args.store)
            store.materialize_synthetic(
                spec, rows_per_run=max(1, min(spec.n, 4 * args.chunk_rows)),
                device=dev)
        compat.barrier()
        store = RunStore.open(args.store)
        print(f"materialised synthetic subject into {args.store}: "
              f"shape {store.shape}")

    n, p, t = store.shape
    budget = int(args.budget_mb * 2**20)
    enc = BrainEncoder(EncoderConfig(device_memory_budget=budget,
                                     chunk_rows=args.chunk_rows,
                                     prefetch=args.prefetch), device=dev)
    enc.fit(store=store)
    d = enc.report_.decision
    # The reference passes jax.device_count() as the target shard count
    # of the estimate.
    devices = compat.device_count()
    resident = estimated_resident_bytes(n, p, t, devices)
    print(f"resident estimate {resident / 2**20:.1f} MB vs budget "
          f"{args.budget_mb:.1f} MB on {devices} device(s)")
    print(f"dispatch: solver={d.solver} method={d.method} "
          f"data_shards={d.data_shards} ({d.rationale})")
    if enc.stream_stats_ is not None:
        ss = enc.stream_stats_
        print(f"stream: prefetch={'on' if ss['prefetch'] else 'off'} "
              f"chunks={ss['chunks']} "
              f"staged={ss['bytes_staged'] / 2**20:.1f} MB "
              f"read_stall={ss['read_stall_s']:.2f}s "
              f"compute_stall={ss['compute_stall_s']:.2f}s "
              f"accumulation compiles={ss['compile_count']} "
              f"[{ss['schema']}]")
    print(f"{enc.report_.solver_label} fit: λ = {enc.report_.best_lambda}, "
          f"CV scores {enc.report_.cv_scores.round(4)}")
    if args.save_bundle:
        _save_bundle_with_report(enc, args.save_bundle,
                                 provenance={"source": "run_store",
                                             "store": args.store,
                                             "shape": list(store.shape)})


def _save_bundle_with_report(encoder, bundle_dir: str,
                             provenance: dict | None = None) -> None:
    """Persist the fitted encoder + machine-readable run provenance.

    The bundle directory gets the ``EncoderBundle`` payload; ``report.json``
    (``EncodingReport.to_json``) rides next to it so downstream tooling can
    read solver/λ/CV provenance without touching the arrays.
    """
    import os

    from repro_torch.core import compat

    path = encoder.save(bundle_dir, overwrite=True, provenance=provenance)
    if compat.rank() == 0:
        with open(os.path.join(path, "report.json"), "w") as f:
            f.write(encoder.report_.to_json())
    compat.barrier()
    print(f"bundle saved → {path} (report.json alongside)")


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch.obscli import (add_device_arg, add_obs_args,
                                           obs_session, resolve_device_arg)

    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="vgg16",
                    help="arch id or 'vgg16' for the paper's feature shape")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n", type=int, default=512, help="time samples")
    ap.add_argument("--targets", type=int, default=256)
    ap.add_argument("--solver", default="auto",
                    help="auto|ridge|mor|bmor|bmor_dual|banded")
    ap.add_argument("--target-shards", type=int, default=None,
                    help="pin the target-batch shard count (default: dispatch)")
    ap.add_argument("--store", default=None,
                    help="out-of-core mode: RunStore directory (materialised "
                         "with synthetic runs on first use, then streamed)")
    ap.add_argument("--chunk-rows", type=int, default=8192,
                    help="row-batch size of the streaming accumulation")
    ap.add_argument("--prefetch", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="overlap the next chunk's disk read with the "
                         "current accumulation (--no-prefetch for the "
                         "serial A/B; results are bit-identical)")
    ap.add_argument("--budget-mb", type=float, default=64.0,
                    help="device-memory budget (MB) for --store dispatch")
    ap.add_argument("--save-bundle", default=None,
                    help="persist the fitted encoder as an EncoderBundle "
                         "directory (+ report.json run provenance) for the "
                         "serving subsystem")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="process-group backend under torch.distributed.run "
                         "(default: nccl on CUDA, gloo on the CPU; gloo for "
                         "several ranks on one card)")
    add_device_arg(ap)
    add_obs_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device_arg(args)

    import contextlib
    import os

    from repro_torch.core import compat

    ranked = "WORLD_SIZE" in os.environ and not compat.is_initialized()
    if ranked:
        dev = compat.init_from_env(dev, args.dist_backend)
    try:
        # Every rank runs the same pipeline; only rank 0 prints.
        with open(os.devnull, "w") as devnull, \
                contextlib.redirect_stdout(devnull if compat.rank()
                                           else sys.stdout), \
                obs_session(args):
            _run(args, dev)
    finally:
        if ranked:
            compat.shutdown()


def _run(args, dev) -> None:
    if args.store is not None:
        _run_store_mode(args, dev)
        return

    import math

    import torch

    from repro_torch import configs
    from repro_torch.data import fmri, synthetic
    from repro_torch.encoding import EncoderConfig, pipeline
    from repro_torch.models import build_model

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(dev.type).manual_seed(seed)

    n, t = args.n, args.targets

    # 1. Stimulus features X.
    if args.backbone == "vgg16":
        spec = fmri.SubjectSpec(n=n, p=128, t=t)
        X, Y, mask = fmri.generate(spec, gen(0), device=dev)
        print(f"synthetic VGG16-shaped features: X{tuple(X.shape)} "
              f"Y{tuple(Y.shape)}")
    else:
        cfg = configs.get_config(args.backbone)
        if args.smoke:
            cfg = configs.smoke(cfg)
        cfg = configs.for_device(cfg, dev)
        model = build_model(cfg)
        params = model.init(gen(1), device=dev)
        seq = 16
        batch = synthetic.make_batch(gen(2), cfg, n // seq, seq, device=dev)
        h = model.hidden_states(params, batch)             # (B, S, d)
        del params
        X = h.reshape(-1, h.shape[-1]).float()
        # Population σ (ddof 0), as jnp.std.
        X = (X - X.mean(0)) / (X.std(0, correction=0) + 1e-6)
        spec = fmri.SubjectSpec(n=X.shape[0], p=X.shape[1], t=t)
        _, Y, mask = fmri.generate(spec, gen(0), device=dev)
        # Plant signal from THESE features so encoding is learnable.
        f32 = dict(dtype=torch.float32, device=dev)
        W_true = torch.randn((X.shape[1], t), generator=gen(3),
                             **f32) / math.sqrt(X.shape[1])
        W_true = W_true * mask.float()[None, :]
        Y = X @ W_true * 2.0 + torch.randn(tuple(Y.shape), generator=gen(4),
                                           **f32)
        print(f"backbone features from {cfg.name}: X{tuple(X.shape)} "
              f"Y{tuple(Y.shape)}")

    # 2-4. 90/10 split → standardize (train-fitted) → fit → evaluate, through
    # the unified estimator API; the dispatch layer picks ridge vs (dual)
    # B-MOR from the problem shape and the number of ranks (§3 cost model).
    enc_cfg = EncoderConfig(solver=args.solver,
                            target_shards=args.target_shards)
    state = pipeline.run(X, Y, enc_cfg, detrend_targets=False, n_perms=5,
                         device=dev)
    report, ev = state.report, state.evaluation

    d = report.decision
    print(f"dispatch: solver={d.solver} mesh={d.data_shards}x"
          f"{d.target_shards} ({d.rationale})")
    print(f"{report.solver_label} fit: per-batch λ = {report.best_lambda}")

    if args.save_bundle:
        _save_bundle_with_report(
            state.encoder, args.save_bundle,
            provenance={"source": "pipeline", "backbone": args.backbone,
                        "n": args.n, "targets": args.targets})

    r_np = ev.pearson_r
    m = mask.cpu().numpy()
    print(f"test Pearson r: responsive targets mean={r_np[m].mean():.3f}  "
          f"non-responsive mean={r_np[~m].mean():.3f}")
    ok = r_np[m].mean() > 5 * ev.null_abs_r
    print(f"null permutation |r|: mean={ev.null_abs_r:.4f} "
          + ("(aligned encoding is significant, paper §4.2)" if ok else
             "(WARNING: responsive targets do not clear the null floor)"))


if __name__ == "__main__":
    main()
