"""Perf hillclimb runner: dry-run one (arch × shape) with optimisation
levers applied, so before/after roofline terms are comparable.

Port of ``repro/launch/perf.py``, on ``launch.dryrun``'s fake world,
``_compile`` and ``_costs``; the roofline terms are
``hlo_analysis.roofline_terms`` at one H100's peaks (``launch.mesh``).

Levers (combinable):
  --flash N              enable blockwise attention above seq N
  --pad-heads N          pad query-head count (zero wo rows) to divide TP
  --mb-unroll            unrolled grad accumulation (accepted; the port's
                         accumulation reduces once either way: launch.steps)
  --microbatch M         grad-accumulation factor (train shapes)
  --rules tp|tp_fsdp     weight sharding rule table

Example:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch llava-next-34b \\
      --shape prefill_32k --flash 8192 --pad-heads 64 --json perf.jsonl

The dry run needs no card (``launch.dryrun``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def label(args) -> str:
    """The record's label from the levers set, as the reference builds it."""
    return args.label or "+".join(
        k for k, v in [("flash", args.flash),
                       ("padheads", args.pad_heads),
                       ("padvocab", args.pad_vocab),
                       ("mbunroll", args.mb_unroll or None),
                       (f"mb{args.microbatch}", args.microbatch)] if v)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--flash", type=int, default=None)
    ap.add_argument("--flash-block", type=int, default=512)
    ap.add_argument("--pad-heads", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None,
                    help="override SSD chunk length (ssm archs)")
    ap.add_argument("--pad-vocab", type=int, default=None,
                    help="pad vocab to divide the tensor axis (zero rows)")
    ap.add_argument("--ce-chunks", type=int, default=None,
                    help="chunked-vocab logsumexp CE (train shapes)")
    ap.add_argument("--mb-unroll", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--rules", default="tp")
    ap.add_argument("--batch", type=int, default=None,
                    help="override global batch (serving wave size)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--label", default="")
    ap.add_argument("--json", default=None)
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.launch import dryrun, hlo_analysis, mesh as mesh_lib
    from repro_torch.launch.steps import build_step
    from repro_torch.models.config import INPUT_SHAPES

    cfg = configs.get_config(args.arch)
    changes = {}
    if args.flash is not None:
        changes.update(flash_threshold=args.flash,
                       flash_block=args.flash_block)
    if args.pad_heads is not None:
        if args.pad_heads < cfg.n_heads:
            ap.error(f"--pad-heads {args.pad_heads} < {cfg.n_heads} heads")
        changes.update(n_heads=args.pad_heads)
    if args.chunk is not None:
        if cfg.ssm is None:
            ap.error(f"--chunk: {args.arch} has no SSM")
        changes.update(ssm=dataclasses.replace(cfg.ssm, chunk=args.chunk))
    if args.pad_vocab is not None:
        if args.pad_vocab < cfg.vocab:
            ap.error(f"--pad-vocab {args.pad_vocab} < vocab {cfg.vocab}")
        changes.update(vocab=args.pad_vocab)
    if args.ce_chunks is not None:
        changes.update(ce_vocab_chunks=args.ce_chunks)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)

    shape = INPUT_SHAPES[args.shape]
    if args.batch is not None:
        shape = dataclasses.replace(shape, global_batch=args.batch)
    dryrun.fake_world(dryrun.WORLD[args.multi_pod])
    mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                         device="cpu")
    step_kw = {}
    if shape.kind == "train":
        if args.microbatch is not None:
            step_kw["microbatch"] = args.microbatch
        if args.mb_unroll:
            step_kw["microbatch_unroll"] = True

    # Memory run (production program).
    t0 = time.time()
    bundle = build_step(cfg, mesh, shape, rules=args.rules, **step_kw)
    traced = dryrun._compile(bundle, mesh)
    mem = traced.memory_analysis()
    scan_cost = dryrun._costs(traced)
    rec = {
        "arch": args.arch, "shape": args.shape,
        "mesh": "2x16x16" if args.multi_pod else "16x16",
        "rules": args.rules,
        "label": label(args),
        "compile_s": round(time.time() - t0, 1),
        "memory": hlo_analysis.memory_dict(mem),
        "scan_counted": scan_cost,
    }

    if not args.no_probes:
        probe = {}
        pk = dict(step_kw)
        pk["microbatch"] = 1
        pk.pop("microbatch_unroll", None)
        if shape.kind != "train":
            pk = {}
        for k in (1, 2):
            cfg_k = dryrun._shrink_depth(cfg, k)
            b_k = build_step(cfg_k, mesh, shape, rules=args.rules,
                             unroll=True, **pk)
            probe[k] = dryrun._costs(dryrun._compile(b_k, mesh))
        R = cfg.n_layers // len(cfg.pattern)
        rec.update(dryrun._extrapolate(probe, R))
        terms = hlo_analysis.roofline_terms(
            rec["flops"], rec["hlo_bytes"],
            sum(rec["collective_bytes"].values()))
        rec.update(terms)

    print(json.dumps(rec, indent=1))
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
