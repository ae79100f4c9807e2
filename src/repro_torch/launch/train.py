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

The port trains on one device.  The config is built without
``configs.for_device``, so the hand-written kernels, which have no
backward, stay off, as the reference's driver builds its config.
``--production-mesh``/``--multi-pod`` need the device mesh (ROADMAP
queue 1 item 12) and refuse; ``--rules`` must name one of the reference's
rule tables and changes nothing on one device.
"""
from __future__ import annotations

import argparse
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
                    help="the pod mesh: not ported (ROADMAP queue 1 item "
                         "12's mesh), refuses")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: not ported, refuses")
    ap.add_argument("--rules", default="tp", choices=RULE_NAMES,
                    help="sharding rule table; the port trains on one "
                         "device, where every table places everything "
                         "alike, so it changes nothing")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise SystemExit("error: --production-mesh/--multi-pod need the "
                         "device mesh, which is not ported yet (ROADMAP "
                         "queue 1 item 12: mesh.py); the port trains on one "
                         "device")
    dev = resolve_device_arg(args)

    import torch

    from repro_torch import checkpoint, configs
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import build_model
    from repro_torch.models.config import InputShape
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.smoke(cfg)
    shape = InputShape("cli", args.seq, args.batch, "train")
    bundle = build_train_step(cfg, shape, opt=AdamWConfig(lr=args.lr))
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0),
                                   device=dev)
    opt_state = adamw_init(params)

    stream = TokenStream(cfg, args.batch, args.seq, device=dev)
    t0 = time.time()
    for step in range(args.steps):
        batch = stream.batch_at(step)
        params, opt_state, metrics = bundle.fn(params, opt_state, batch)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time()-t0:.1f}s)")
        if args.ckpt_every and args.ckpt_dir and \
                (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
    print("done")


if __name__ == "__main__":
    main()
