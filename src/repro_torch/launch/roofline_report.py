"""Roofline report generator: dry-run JSONL → the roofline table; and
the roofline placement of a ridge-CV fit and of a serving pass.

Port of ``repro/launch/roofline_report.py``.  Per (arch × shape) of a
``launch.dryrun``/``launch.perf`` JSONL: the three roofline terms
(seconds, per device, from ``hlo_analysis.roofline_terms`` at one H100's
peaks: the dense bf16 tensor-core rate, HBM3, NVLink), the dominant
bottleneck, MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference) with N =
active parameters (MoE experts scaled by top-k/E), and the useful-compute
ratio MODEL_FLOPS / counted FLOPs.

Usage (CPU, no card): PYTHONPATH=src python -m \
    repro_torch.launch.roofline_report dryrun.jsonl [--json]

``encoding_roofline`` (which the whole-brain driver's ``ab`` phase
reports) and ``predict_roofline`` keep the reference's CPU envelope as
their default; ``H100_PEAK_FLOPS``/``H100_MEM_BW`` are the data-sheet
peaks of the H100 SXM part at its 700 W limit (67 TFLOP/s f32 outside
the tensor cores, 3.35 TB/s of HBM3), which a driver passes when it runs
on a CUDA card.  ``H100_NVLINK_BW`` is the same data sheet's NVLink
figure (900 GB/s per card, the sum over its 18 links in both
directions): a data-sheet number, not a measurement.
"""
from __future__ import annotations

import argparse
import json
import math

from repro_torch.core.complexity import RidgeWorkload, t_m, t_w, t_w_folded
from repro_torch.launch.hlo_analysis import roofline_terms

_HINTS = {
    "compute": "raise tensor-core utilisation: bigger per-device batch, "
               "bf16 operands with f32 accumulation, fused products",
    "memory": "cut HBM3 traffic: fused/blockwise attention, avoid f32 "
              "intermediates, better remat policy",
    "collective": "overlap collectives with compute; reduce-scatter grads "
                  "(FSDP) instead of all-reduce; keep the model axis "
                  "inside one NVLink domain",
}


# Conservative single-socket CPU envelope for the out-of-core ridge bench
# (one core, f32 FMA): ~50 GFLOP/s compute, ~20 GB/s sustained DRAM/disk
# staging bandwidth.
CPU_PEAK_FLOPS = 50e9
CPU_MEM_BW = 20e9
# NVIDIA H100 SXM data sheet: f32 FMA rate outside the tensor cores and
# HBM3 bandwidth.
H100_PEAK_FLOPS = 67e12
H100_MEM_BW = 3.35e12
# NVIDIA H100 SXM data sheet: NVLink bandwidth per card.
H100_NVLINK_BW = 900e9


def encoding_roofline(n: int, p: int, t: int, *, r: int = 11,
                      n_folds: int = 5, wall_s: float | None = None,
                      bytes_staged: int | None = None,
                      peak_flops: float = CPU_PEAK_FLOPS,
                      mem_bw: float = CPU_MEM_BW) -> dict:
    """Roofline placement of one out-of-core ridge-CV fit.

    Model FLOPs come from the analytic complexity model: the single-pass
    fold statistics (``n·p²`` Gram + ``n·p·t`` cross-moments,
    ``t_w_folded``), the mutualised factorisation ``T_M``, and the
    target application ``T_W`` — ×2 for multiply+add.  Bytes default to
    one read of the rows (``n·(p+t)`` f32) unless the streamed tier's
    ``bytes_staged`` is given; ``wall_s`` adds the achieved FLOP/s as a
    fraction of ``peak_flops``.  Informational only: nothing gates on it.
    """
    w = RidgeWorkload(n=n, p=p, t=t, r=r, n_folds=n_folds)
    mults = t_w_folded(w) + float(n) * p * t + t_m(w) + t_w(w)
    flops = 2.0 * mults
    nbytes = int(bytes_staged) if bytes_staged else n * (p + t) * 4
    out = {
        "model_flops": flops,
        "bytes": nbytes,
        "flop_per_byte": flops / nbytes if nbytes else float("nan"),
        "peak_flop_per_byte": peak_flops / mem_bw,
    }
    # One fit on one device moves no collective bytes: the compute and
    # memory terms and the larger of the two, as the reference reports.
    terms = roofline_terms(flops, nbytes, 0.0, peak_flops=peak_flops,
                           hbm_bw=mem_bw)
    out.update(t_compute_s=terms["t_compute_s"],
               t_memory_s=terms["t_memory_s"],
               bottleneck=("compute" if terms["t_compute_s"]
                           >= terms["t_memory_s"] else "memory"))
    if wall_s:
        out["achieved_flops"] = flops / wall_s
        out["peak_fraction"] = flops / wall_s / peak_flops
    return out


def predict_roofline(rows: int, p: int, t: int, *,
                     wall_s: float | None = None,
                     bytes_staged: int | None = None,
                     peak_flops: float = CPU_PEAK_FLOPS,
                     mem_bw: float = CPU_MEM_BW) -> dict:
    """Roofline placement of one serving prediction pass (Ŷ = X·W).

    FLOPs are the ``2·rows·p·t`` product; bytes default to the nominal
    traffic (``rows·(p+t)`` in and out, one read of the ``p·t`` weights)
    unless the serving loop reports its ``bytes_staged``.  Informational
    only, as ``encoding_roofline``."""
    flops = 2.0 * rows * p * t
    nbytes = (int(bytes_staged) if bytes_staged
              else rows * (p + t) * 4 + p * t * 4)
    terms = roofline_terms(flops, nbytes, 0.0, peak_flops=peak_flops,
                           hbm_bw=mem_bw)
    out = {
        "model_flops": flops,
        "bytes": nbytes,
        "flop_per_byte": flops / nbytes if nbytes else float("nan"),
        "peak_flop_per_byte": peak_flops / mem_bw,
        "t_compute_s": terms["t_compute_s"],
        "t_memory_s": terms["t_memory_s"],
        "bottleneck": ("compute" if terms["t_compute_s"]
                       >= terms["t_memory_s"] else "memory"),
    }
    if wall_s:
        out["achieved_flops"] = flops / wall_s
        out["peak_fraction"] = flops / wall_s / peak_flops
    return out


def active_params(arch: str) -> tuple[int, int]:
    """(total, active) parameter counts from the config's parameter
    definitions (nothing allocated)."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models.params import leaves

    cfg = configs.get_config(arch)
    total = active = 0
    scale = (cfg.moe.top_k / cfg.moe.n_experts) if cfg.moe else 1.0
    for d in leaves(build_model(cfg).param_defs()):
        n = math.prod(d.shape)
        total += n
        active += int(n * scale) if "expert" in d.axes else n
    return total, active


def model_flops_per_device(arch: str, shape_name: str,
                           n_devices: int = 256) -> float:
    from repro_torch.models.config import INPUT_SHAPES
    shape = INPUT_SHAPES[shape_name]
    _, n_active = active_params(arch)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_devices
    # decode: one token per request
    return 2.0 * n_active * shape.global_batch / n_devices


def report(jsonl_path: str, md: bool = True) -> str:
    """The roofline table of a dry-run JSONL: the first record of each
    (arch, shape, mesh, rules), single-pod (16x16) records only."""
    rows = []
    seen = set()
    with open(jsonl_path) as f:
        records = [json.loads(line) for line in f]
    for r in records:
        key = (r["arch"], r["shape"], r.get("mesh"), r.get("rules", "tp"))
        if key in seen:
            continue
        seen.add(key)
        if r.get("mesh") != "16x16":
            continue
        coll = sum(r["collective_bytes"].values())
        terms = roofline_terms(r["flops"], r["hlo_bytes"], coll)
        mf = model_flops_per_device(r["arch"], r["shape"])
        ratio = mf / r["flops"] if r["flops"] else float("nan")
        rows.append({
            "arch": r["arch"], "shape": r["shape"],
            "rules": r.get("rules", "tp"),
            "tc": terms["t_compute_s"], "tm": terms["t_memory_s"],
            "tx": terms["t_collective_s"],
            "bottleneck": terms["bottleneck"],
            "model_flops": mf, "hlo_flops": r["flops"], "ratio": ratio,
            "temp_gb": r.get("memory", {}).get("temp_size_in_bytes", 0) / 1e9,
        })
    if not md:
        return json.dumps(rows, indent=1)
    out = ["| arch | shape | t_compute | t_memory | t_collective | "
           "bottleneck | 6ND/HLO | temp GB | next lever |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} ({r['rules']}) "
            f"| {r['tc']:.3e} | {r['tm']:.3e} | {r['tx']:.3e} "
            f"| **{r['bottleneck']}** | {r['ratio']:.2f} "
            f"| {r['temp_gb']:.1f} | {_HINTS[r['bottleneck']]} |")
    return "\n".join(out)


__all__ = ["CPU_MEM_BW", "CPU_PEAK_FLOPS", "H100_MEM_BW", "H100_NVLINK_BW",
           "H100_PEAK_FLOPS", "active_params", "encoding_roofline",
           "model_flops_per_device", "predict_roofline", "report"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    print(report(args.jsonl, md=not args.json))
