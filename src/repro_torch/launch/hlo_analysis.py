"""Collective byte counts and the three-term roofline of a step.

Port of ``repro/launch/hlo_analysis.py``.  The reference parses the
compiled XLA module's text and sums the output shapes of every
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute.  PyTorch has no HLO text, so the port counts at the
step's collectives themselves: every collective a sharded step issues
(``models.spmd``'s operators and AdamW's norm) is recorded with its op
kind, mesh axes and bytes while ``count_collectives()`` is open:

    with hlo_analysis.count_collectives() as tally:
        bundle.fn(params, opt_state, batch)
    hlo_analysis.collective_bytes(tally)   # {"all-reduce": …, …}

Byte counts are per rank: an ``all_reduce``'s operand, a gather's
output buffer, a ``reduce_scatter``'s input, as the reference counts the
per-device shapes of its partitioned module.  Collectives of one rank
are skipped by the step, and so are not counted.
"""
from __future__ import annotations

from typing import Any

from repro_torch.launch.mesh import (HBM_BW, ICI_BW_PER_LINK,
                                     PEAK_FLOPS_BF16)
from repro_torch.models.spmd import Tally
from repro_torch.models.spmd import counting as count_collectives

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# NVLink 4 links of one H100.
NVLINK_LINKS = 18


def collective_bytes(tally: Tally) -> dict[str, float]:
    """Bytes of the tallied collectives, keyed by the reference's five op
    kinds."""
    totals: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for (kind, _axes), (_count, nbytes) in tally.ops.items():
        totals[kind] += float(nbytes)
    return totals


def total_collective_bytes(tally: Tally) -> float:
    return sum(collective_bytes(tally).values())


def memory_dict(mem: Any) -> dict:
    """The reference's memory fields, from an object or a dict that holds
    them (e.g. ``argument_size_in_bytes`` from the step's inputs,
    ``temp_size_in_bytes`` from ``torch.cuda.max_memory_allocated``)."""
    out = {}
    for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "generated_code_size_in_bytes",
                 "alias_size_in_bytes"):
        v = mem.get(attr) if isinstance(mem, dict) else getattr(mem, attr,
                                                                None)
        if v is not None:
            out[attr] = int(v)
    return out


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float, *,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW,
                   ici_bw: float = ICI_BW_PER_LINK,
                   ici_links: int = NVLINK_LINKS) -> dict:
    """Three-term roofline (seconds): compute, memory and collective, and
    the largest.  All inputs are per device; the defaults are one H100's
    (``launch.mesh``): the dense bf16 peak, HBM3, NVLink's 18 links."""
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bw
    t_collective = coll_bytes / (ici_bw * ici_links)
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_collective), key=lambda kv: kv[1])
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": dom[0],
    }


__all__ = ["NVLINK_LINKS", "Tally", "collective_bytes", "count_collectives",
           "memory_dict", "roofline_terms", "total_collective_bytes"]
