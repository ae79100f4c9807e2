"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``, with its flags and printed lines
(``step … loss=… gnorm=… (…s)`` at every tenth of the run and at its last
step, then ``done``) plus ``--device`` (default CUDA, which fails without
a card): the synthetic token stream (``TokenStream``) → the train step
(``launch/steps.py``: loss, backward with per-layer remat, AdamW) →
a checkpoint of ``{"params", "opt"}`` every ``--ckpt-every`` steps, to
``<ckpt-dir>/step_N``.

    python -m repro_torch.launch.train --arch gemma2-2b --smoke \
        --steps 6 --batch 2 --seq 16 --device cpu

The step runs over a mesh (``launch/steps.py``: parameters and moments
are DTensors placed by ``--rules``).  Run as one process, the driver
makes a world of one and trains on a (1, 1) mesh; under
``python -m torch.distributed.run --nproc-per-node N`` every rank joins
the world (``core.compat.init_from_env``), and the mesh is
``make_host_mesh(model=2)`` when N is even and > 1, else (N, 1).  Every
rank draws the same parameters and batches and keeps its block of them;
rank 0 prints and writes the checkpoints (gathered whole).
``--production-mesh`` builds the (16, 16) mesh and ``--multi-pod`` the
(2, 16, 16) one: in a world of another size they fail with the mesh's
error, which names the 256 or 512 ranks they need.  The config is built
without ``configs.for_device``, so the hand-written kernels, which have
no backward, stay off, as the reference's driver builds its config.
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch.launch.obscli import add_device_arg, resolve_device_arg

# The reference's logical-axis rule tables (repro/models/params.py RULES).
RULE_NAMES = ("tp", "tp_fsdp", "tp_cacheseq")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: a world of 256 ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh: a world of 512 ranks")
    ap.add_argument("--rules", default="tp", choices=RULE_NAMES,
                    help="the sharding rule table that places the weights")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device_arg(args)

    from repro_torch.core import compat
    from repro_torch.launch import mesh as mesh_lib

    own = not compat.is_initialized()
    if own:
        dev = (compat.init_from_env(dev) if "RANK" in os.environ
               else compat.init_world_of_one(dev))
    try:
        if args.production_mesh or args.multi_pod:
            mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                                 device=dev)
        else:
            n = compat.device_count()
            mesh = mesh_lib.make_host_mesh(
                model=2 if n % 2 == 0 and n > 1 else 1, device=dev)
        _train(args, mesh, dev)
    finally:
        if own:
            compat.shutdown()


def _train(args, mesh, dev) -> None:
    import torch

    from repro_torch import checkpoint, configs, convert
    from repro_torch.core import compat
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.steps import build_train_step, is_dtensor
    from repro_torch.models import build_model
    from repro_torch.models.config import InputShape
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.smoke(cfg)
    shape = InputShape("cli", args.seq, args.batch, "train")
    bundle = build_train_step(cfg, mesh, shape, rules=args.rules,
                              opt=AdamWConfig(lr=args.lr))
    # Every rank draws the same parameters and keeps its block.
    params = convert.shard_params(
        build_model(cfg).init(torch.Generator(dev).manual_seed(0),
                              device=dev), cfg, mesh, args.rules)
    opt_state = adamw_init(params)
    lead = compat.rank() == 0

    stream = TokenStream(cfg, args.batch, args.seq, device=dev)
    t0 = time.time()
    for step in range(args.steps):
        batch = stream.batch_at(step)
        params, opt_state, metrics = bundle.fn(params, opt_state, batch)
        if lead and (step % max(1, args.steps // 10) == 0
                     or step == args.steps - 1):
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)")
        if args.ckpt_every and args.ckpt_dir and \
                (step + 1) % args.ckpt_every == 0:
            # Gathered whole on every rank (collective); rank 0 writes.
            whole = tree_map(lambda t: t.full_tensor() if is_dtensor(t)
                             else t, {"params": params, "opt": opt_state})
            if lead:
                checkpoint.save(args.ckpt_dir, step + 1, whole)
            compat.barrier()
    if lead:
        print("done")


if __name__ == "__main__":
    main()
