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

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of
the compiled module.  ``count_costs()`` counts them at the aten ops one
rank runs, on real or on fake tensors alike (the dry run's), together
with the collectives above and the peak of the bytes the ops allocate:

    with hlo_analysis.count_costs() as costs:
        bundle.fn(*inputs)
    costs.as_dict()   # {"flops", "hlo_bytes", "collective_bytes"}
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import (HBM_BW, ICI_BW_PER_LINK,
                                     PEAK_FLOPS_BF16)
from repro_torch.models.spmd import Tally, is_dtensor
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


class Costs:
    """What one rank ran while ``count_costs()`` was open.

    * ``flops``: ``FlopCounterMode``'s count: a product is 2·m·n·k, XLA's
      convention; the elementwise ops, which XLA also counts, are not.
    * ``hlo_bytes``: over every aten op that is not a view (a view op
      that returns a copy counts), the bytes of its tensor inputs and
      outputs.  This is XLA's "bytes accessed" without fusion: an upper
      bound on it.
    * ``tally``: the collectives (``collective_bytes(costs.tally)``).
    * ``peak_bytes``: the largest sum of the storages the ops allocated
      that were alive at once (the inputs' own storages are not counted).
    * ``read``: the ids of the storages that the counted ops took as
      inputs: which inputs the program reads.
    """

    def __init__(self, tally: Tally):
        self.flops = 0
        self.hlo_bytes = 0
        self.tally = tally
        self.live_bytes = 0
        self.peak_bytes = 0
        self.read: set[int] = set()

    def as_dict(self) -> dict:
        """The reference's ``dryrun._costs`` record."""
        return {"flops": float(self.flops),
                "hlo_bytes": float(self.hlo_bytes),
                "collective_bytes": collective_bytes(self.tally)}

    def _freed(self, nbytes: int) -> None:
        self.live_bytes -= nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _plain_tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and not is_dtensor(t)]


# The ops by which a mode takes in a tensor made from Python data
# (``torch.tensor``): fake mode dispatches them, a real run does not.
_LIFTS = (torch.ops.aten.lift_fresh.default,
          torch.ops.aten.lift_fresh_copy.default)


class _ByteCounter(TorchDispatchMode):
    """Adds each non-view aten op's tensor bytes to ``costs.hlo_bytes``
    and follows the storages the ops allocate until they are freed."""

    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        self.finalizers: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace != "aten" or func in _LIFTS:
            return out
        ins = _plain_tensors((args, kwargs))
        outs = _plain_tensors(out)
        known = {id(t.untyped_storage()) for t in ins}
        new = [t for t in outs if id(t.untyped_storage()) not in known]
        # A view op may return a copy (``to`` to another dtype): then it
        # moved bytes.
        if not func.is_view or new:
            self.costs.hlo_bytes += sum(_nbytes(t) for t in ins + outs)
            self.costs.read |= known
        for t in new:
            st = t.untyped_storage()
            if id(st) in known:
                continue
            known.add(id(st))
            nbytes = st.nbytes()
            self.costs.live_bytes += nbytes
            self.costs.peak_bytes = max(self.costs.peak_bytes,
                                        self.costs.live_bytes)
            self.finalizers.append(weakref.finalize(st, self.costs._freed,
                                                    nbytes))
        return out


@contextlib.contextmanager
def count_costs():
    """→ a ``Costs`` of every op, byte and collective that the code in the
    block runs on this rank (its backward too).  Real and fake tensors
    give the same counts for the same program."""
    with count_collectives() as tally:
        costs = Costs(tally)
        bytes_mode = _ByteCounter(costs)
        flops = FlopCounterMode(display=False)
        try:
            with flops, bytes_mode:
                yield costs
        finally:
            for f in bytes_mode.finalizers:
                f.detach()
            costs.flops = flops.get_total_flops()


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


__all__ = ["NVLINK_LINKS", "Costs", "Tally", "collective_bytes",
           "count_collectives", "count_costs", "memory_dict",
           "roofline_terms", "total_collective_bytes"]
