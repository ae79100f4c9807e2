"""Roofline placement of an out-of-core ridge-CV fit (paper §3 terms).

Port of ``encoding_roofline`` (``repro/launch/roofline_report.py``) and of
the one-device part of the ``roofline_terms`` it calls
(``repro/launch/hlo_analysis.py``), which the whole-brain driver's ``ab``
phase reports.  The reference's CPU
envelope stays the default; ``H100_PEAK_FLOPS``/``H100_MEM_BW`` are the
data-sheet peaks of the H100 SXM part at its 700 W limit (67 TFLOP/s f32
outside the tensor cores, 3.35 TB/s of HBM3), which a driver passes when
it runs on a CUDA card.

The rest of the reference module — the dry-run roofline table and
``predict_roofline``'s bench callers — is ROADMAP queue 1 item 12.
"""
from __future__ import annotations

from repro_torch.core.complexity import RidgeWorkload, t_m, t_w, t_w_folded

# Conservative single-socket CPU envelope for the out-of-core ridge bench
# (one core, f32 FMA): ~50 GFLOP/s compute, ~20 GB/s sustained DRAM/disk
# staging bandwidth.
CPU_PEAK_FLOPS = 50e9
CPU_MEM_BW = 20e9
# NVIDIA H100 SXM data sheet: f32 FMA rate outside the tensor cores and
# HBM3 bandwidth.
H100_PEAK_FLOPS = 67e12
H100_MEM_BW = 3.35e12


def roofline_terms(flops: float, nbytes: float, *, peak_flops: float,
                   mem_bw: float) -> dict:
    """The compute and memory roofline terms (seconds) and the larger one.

    The reference's ``roofline_terms`` (``hlo_analysis.py``) adds a third,
    collective term over the TPU's inter-chip links; one device moves no
    collective bytes, so the port keeps the two terms that carry meaning
    (multi-device is ROADMAP queue 1 item 9)."""
    t_compute = flops / peak_flops
    t_memory = nbytes / mem_bw
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "bottleneck": "compute" if t_compute >= t_memory else "memory"}


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
        **roofline_terms(flops, nbytes, peak_flops=peak_flops,
                         mem_bw=mem_bw),
    }
    if wall_s:
        out["achieved_flops"] = flops / wall_s
        out["peak_fraction"] = flops / wall_s / peak_flops
    return out


__all__ = ["CPU_MEM_BW", "CPU_PEAK_FLOPS", "H100_MEM_BW", "H100_PEAK_FLOPS",
           "encoding_roofline", "roofline_terms"]
