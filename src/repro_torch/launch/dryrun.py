"""Multi-pod dry run: prove every (architecture × input shape × mesh)
combination runs on the production mesh, with no allocation.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step on 512 forced host devices.  The port traces each
``steps.build_step`` once on fake tensors (``FakeTensorMode``: shapes,
dtypes and devices, no storage), as rank 0 of a ``fake`` process group
of 256 ranks (512 with ``--multi-pod``), in one CPU process:
parameters, moments and caches are DTensors over fake local blocks, the
batch, the decode tokens and ``pos`` fake tensors of their global shape,
as the steps take them.  The fake group's collectives move nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k [--multi-pod] [--rules tp] [--json out.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Outputs per combination: memory per device (the local blocks of the
inputs the step reads: XLA drops the parameters a program never reads,
as seamless's encoder in decode; the outputs; the outputs that are the
inputs' own storage, where the reference donates; the peak of what the
step allocates), the costs that ``hlo_analysis.count_costs``
counts at the ops rank 0 runs (FLOPs, unfused bytes, collective bytes by
op kind): the roofline's inputs.

Like the reference's, the dry run claims no card and needs none: its
fake tensors are CPU tensors, with or without a card.  The kernel
switches stay off, as ``configs.get_config`` gives them: a kernel cannot
run on a fake tensor, and ``kernels.ops`` raises if it is handed one.

The port's layer loop is a Python loop (``models/scanning.py``), so the
main trace already counts every layer once per layer: ``scan_counted``
keeps the reference's key, and in the port it is the direct count.  The
cost probes (1 and 2 pattern repeats, microbatch 1) run as in the
reference, and the record's ``flops``, ``hlo_bytes`` and
``collective_bytes`` are extrapolated from them as the reference's are.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# Ranks of the production meshes: (16, 16), and (2, 16, 16) multi-pod.
WORLD = {False: 256, True: 512}


def fake_world(n_ranks: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of
    ``n_ranks`` (torch's test backend: every collective returns at once
    and moves nothing)."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore), "
            "which this torch does not have") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def _fake_mode():
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
    except ImportError as e:
        raise RuntimeError("the dry run needs torch._subclasses.fake_tensor."
                           "FakeTensorMode, which this torch does not have"
                           ) from e
    return FakeTensorMode()


def _shrink_depth(cfg, k: int):
    """Config with k pattern repeats (for the cost probes)."""
    kw = {"n_layers": k * len(cfg.pattern)}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = k
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass
class Traced:
    """One traced step: its costs (``hlo_analysis.Costs``) and its memory
    per device (the reference's ``memory_analysis()`` fields)."""
    costs: object
    memory: dict

    def memory_analysis(self) -> dict:
        return self.memory


def _is_spec(tree) -> bool:
    """A ``batch_spec``: name → (shape, dtype)."""
    return isinstance(tree, dict) and all(
        isinstance(v, tuple) for v in tree.values())


def _fake_inputs(bundle, mesh, fake):
    """→ (the step's inputs on fake tensors, storage id → the bytes of
    its local block on this rank, for every input).  Parameters, moments
    and caches are DTensors of fake local blocks; the batch, the tokens,
    ``pos`` and the optimizer's step counter plain fake tensors of their
    global shape, as the steps take them (the step counter as
    ``adamw_init`` makes it), counted at their ``in_shardings`` block."""
    import torch

    from repro_torch.models.params import tree_map

    blocks = {}

    def fake_tensor(shape, dtype, block):
        with fake:
            t = torch.zeros(shape, dtype=dtype, device=mesh.device)
        blocks[id(t.untyped_storage())] = block.numel() * dtype.itemsize
        return t

    def plain(meta, sh):
        block = sh.local_block(torch.empty(meta.shape, device="meta"))
        return fake_tensor(meta.shape, meta.dtype, block)

    def placed(meta, sh):
        block = sh.local_block(torch.empty(meta.shape, device="meta"))
        return sh.wrap(fake_tensor(block.shape, meta.dtype, block),
                       meta.shape)

    args = []
    for tree, sh in zip(bundle.abstract_inputs, bundle.in_shardings):
        if _is_spec(tree):
            args.append({k: plain(torch.empty(s, dtype=dt, device="meta"),
                                  sh[k]) for k, (s, dt) in tree.items()})
        elif isinstance(tree, torch.Tensor):
            args.append(plain(tree, sh))
        elif set(tree) == {"mu", "nu", "step"}:
            args.append({"mu": tree_map(placed, tree["mu"], sh["mu"]),
                         "nu": tree_map(placed, tree["nu"], sh["nu"]),
                         "step": plain(tree["step"], sh["step"])})
        else:
            args.append(tree_map(placed, tree, sh))
    return tuple(args), blocks


def _storages(tree) -> dict:
    """id of storage → bytes, over every tensor of ``tree`` (a DTensor's
    local block)."""
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.models.spmd import is_dtensor

    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            out[id(t.untyped_storage())] = t.numel() * t.element_size()
    return out


def _compile(bundle, mesh) -> Traced:
    """Run the step once on fake inputs under ``hlo_analysis.count_costs``
    (the reference lowers and compiles it) → its costs and memory."""
    from repro_torch.launch import hlo_analysis

    mesh.device_mesh                # built outside fake mode
    fake = _fake_mode()
    args, blocks = _fake_inputs(bundle, mesh, fake)
    with fake, hlo_analysis.count_costs() as costs:
        out = bundle.fn(*args)
    ins, outs = _storages(args), _storages(out)
    memory = {
        "argument_size_in_bytes": sum(n for s, n in blocks.items()
                                      if s in costs.read),
        "output_size_in_bytes": sum(outs.values()),
        "alias_size_in_bytes": sum(n for s, n in outs.items() if s in ins),
        "temp_size_in_bytes": costs.peak_bytes,
        "generated_code_size_in_bytes": 0,
    }
    return Traced(costs, memory)


def _costs(traced: Traced) -> dict:
    return traced.costs.as_dict()


def _extrapolate(probe: dict, R: int) -> dict:
    """f(R) = f1 + (R − 1)·(f2 − f1) for every cost of the two probes."""
    def ext(a, b):
        return a + (R - 1) * (b - a)
    return {
        "flops": ext(probe[1]["flops"], probe[2]["flops"]),
        "hlo_bytes": ext(probe[1]["hlo_bytes"], probe[2]["hlo_bytes"]),
        "collective_bytes": {
            op: ext(probe[1]["collective_bytes"][op],
                    probe[2]["collective_bytes"][op])
            for op in probe[1]["collective_bytes"]},
    }


def _need_world(multi_pod: bool) -> None:
    """Raise, naming the world the production mesh needs, unless this
    process holds it."""
    from repro_torch.core import compat

    want = WORLD[multi_pod]
    if compat.device_count() != want or not compat.is_initialized():
        held = (f"a world of {compat.device_count()}"
                if compat.is_initialized() else "no process group")
        raise RuntimeError(
            f"the dry run of the {'2x16x16' if multi_pod else '16x16'} mesh "
            f"runs as rank 0 of a {want}-rank world (dryrun.fake_world("
            f"{want}), as main() makes it); this process holds {held}")


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            rules: str = "tp", verbose: bool = True,
            probes: bool = True) -> dict:
    from repro_torch import configs
    from repro_torch.launch import hlo_analysis, mesh as mesh_lib
    from repro_torch.launch.steps import build_step
    from repro_torch.models.config import INPUT_SHAPES

    _need_world(multi_pod)
    cfg = configs.get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")

    # Main trace: production settings (grad-accum microbatching).  Proves
    # the combination runs and gives its memory.
    t0 = time.time()
    bundle = build_step(cfg, mesh, shape, rules=rules)
    traced = _compile(bundle, mesh)
    t_main = time.time() - t0
    mem = traced.memory_analysis()
    scan_cost = _costs(traced)

    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "rules": rules,
        "n_devices": len(mesh.ranks),
        "compile_s": round(t_main, 1),
        "memory": hlo_analysis.memory_dict(mem),
        # The main trace's own counters: in the port the direct count of
        # every layer (module docstring).
        "scan_counted": scan_cost,
    }

    if probes:
        # Two shallow variants (1 and 2 pattern repeats, microbatch 1)
        # → per-repeat slope → totals: f(R) = f1 + (R-1)·(f2-f1).
        t0 = time.time()
        probe = {}
        for k in (1, 2):
            cfg_k = _shrink_depth(cfg, k)
            kw = {"microbatch": 1} if shape.kind == "train" else {}
            b_k = build_step(cfg_k, mesh, shape, rules=rules, unroll=True,
                             **kw)
            probe[k] = _costs(_compile(b_k, mesh))
        R = cfg.n_layers // len(cfg.pattern)
        rec["probe_s"] = round(time.time() - t0, 1)
        rec.update(_extrapolate(probe, R))
    else:
        rec["flops"] = scan_cost["flops"]
        rec["hlo_bytes"] = scan_cost["hlo_bytes"]
        rec["collective_bytes"] = scan_cost["collective_bytes"]

    if verbose:
        print(f"== {arch} × {shape_name} × {rec['mesh']} (rules={rules}) ==")
        print("memory_analysis:", mem)
        print("cost_analysis (probe-extrapolated): "
              f"flops={rec['flops']:.3e} bytes={rec['hlo_bytes']:.3e}")
        print("collective_bytes:",
              {k: f"{v:.3e}" for k, v in rec["collective_bytes"].items()})
        sys.stdout.flush()
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="tp")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the cost probes (memory-only run)")
    ap.add_argument("--json", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models.config import INPUT_SHAPES

    if args.all:
        combos = [(a, s) for a in configs.ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    fake_world(WORLD[args.multi_pod])
    records, failures = [], []
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, multi_pod=args.multi_pod,
                          rules=args.rules, probes=not args.no_probes)
            records.append(rec)
            if args.json:  # append incrementally — crash-safe
                with open(args.json, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except Exception as e:  # noqa: BLE001 — report every combo
            failures.append((arch, shape, repr(e)))
            print(f"FAILED {arch} × {shape}: {e!r}", file=sys.stderr)
    print(f"\n{len(records)} passed, {len(failures)} failed")
    for a, s, e in failures:
        print(f"  FAIL {a} × {s}: {e}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
