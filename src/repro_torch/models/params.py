"""Parameter definition trees: one source of truth for shapes, dtypes,
logical sharding axes and initialisers.

Port of ``repro/models/params.py``, plus ``zeros`` for the decode caches.
A model's ``param_defs()`` is a nested dict with ``ParamDef`` leaves.
From that one tree come:

* ``abstract(tree)``  → ``meta``-device tensors of the same shapes and
  dtypes, which allocate nothing;
* ``init(tree, generator)`` → materialised parameters, drawn from an
  explicit ``torch.Generator`` on the generator's device;
* ``specs(tree, rules, axis_sizes)`` → a spec per leaf: a tuple with one
  entry per dimension, ``None``, a mesh axis name or a tuple of names,
  as the reference's ``PartitionSpec`` holds it.  ``launch.steps`` turns
  specs into DTensor placements.

Logical axis names are mapped to mesh axes by a rule table (``RULES``),
so switching the sharding strategy is a change of table, not of model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.device import resolve_device

# Logical axes used by the model zoo.
#   embed   — d_model dimension
#   mlp     — FFN hidden dimension
#   heads   — attention query heads (sharded over tensor axis)
#   kv      — KV heads
#   vocab   — vocabulary dimension
#   expert  — MoE expert dimension
#   state   — SSM state dimension
#   layer   — stacked layer dimension, never sharded
#   None    — replicated

# Rule tables: logical axis → mesh axis (or None).
RULES = {
    # Paper-faithful baseline: tensor parallel over "model", batch over
    # "data" (+"pod"); weights replicated over data.
    "tp": {
        "embed": None, "mlp": "model", "heads": "model", "kv": "model",
        "vocab": "model", "expert": "model", "state": None, "layer": None,
        "conv": None, "dt": None, "batch": None, "cache_seq": None,
    },
    # FSDP variant: the weights' embed dim also sharded over data.
    "tp_fsdp": {
        "embed": "data", "mlp": "model", "heads": "model", "kv": "model",
        "vocab": "model", "expert": "model", "state": None, "layer": None,
        "conv": None, "dt": None, "batch": None, "cache_seq": None,
    },
    # Decode variant: the KV cache's sequence dim sharded over the model
    # axis, for archs whose KV head count leaves the tensor axis idle.
    "tp_cacheseq": {
        "embed": None, "mlp": "model", "heads": "model", "kv": "model",
        "vocab": "model", "expert": "model", "state": None, "layer": None,
        "conv": None, "dt": None, "batch": None, "cache_seq": "model",
    },
}

Spec = tuple  # per dimension: None, an axis name or a tuple of names


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """A single parameter: shape + dtype + logical axes + initialiser."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # "normal" | "zeros" | "ones" | "scaled"
    scale: float | None = None    # stddev override for "normal"/"scaled"
    fan_in: int | None = None     # explicit fan-in when the heuristic fails

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a nested dict (keys in sorted order, as
    ``jax.tree_util`` orders them), and over the matching leaves of the
    trees ``rest`` of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def abstract(tree) -> dict:
    """``meta``-device tensors of every leaf's shape and dtype: the inputs
    a step is described by, with no storage allocated."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), tree)


def specs(tree, rules: dict | str = "tp",
          axis_sizes: dict[str, int] | None = None) -> dict:
    """A spec tree from the logical-axis rule table.

    ``axis_sizes`` (mesh axis → size) enables divisibility checking: a
    logical axis whose dimension its mesh axes do not divide is left
    replicated (e.g. 2 KV heads on a 4-wide model axis, or a vocab that
    is not a multiple of 16).  A mesh axis is used once per spec, and the
    first logical axis wins (MoE weights (expert, embed, ·, mlp):
    "expert" takes the model axis, so the per-expert mlp dim stays
    unsharded).
    """
    table = RULES[rules] if isinstance(rules, str) else rules

    def one(d: ParamDef) -> Spec:
        out = []
        used: set = set()
        for dim, a in zip(d.shape, d.axes):
            m = table.get(a, None) if a else None
            flat = m if isinstance(m, tuple) else (m,)
            if m is not None and any(f in used for f in flat):
                m = None
            if m is not None and axis_sizes is not None:
                if dim % math.prod(axis_sizes.get(f, 1) for f in flat):
                    m = None
            if m is not None:
                used.update(f for f in flat if f)
            # One axis in a tuple is that axis, as PartitionSpec holds it.
            out.append(m[0] if isinstance(m, tuple) and len(m) == 1 else m)
        return tuple(out)

    return tree_map(one, tree)


def _std(d: ParamDef) -> float:
    # Fan-in: explicit when given, else the product of all input dims —
    # every dim except the output (last) one and any stacked "layer" axis.
    if d.fan_in is not None:
        fan_in = d.fan_in
    else:
        in_dims = [s for s, a in zip(d.shape[:-1], d.axes[:-1])
                   if a != "layer"]
        fan_in = math.prod(in_dims) if in_dims else d.shape[-1]
    return d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))


def init(tree, generator: torch.Generator,
         dtype_override: torch.dtype | None = None, *,
         device: torch.device | str | None = None) -> dict:
    """Materialise parameters on ``device`` (CUDA unless ``device="cpu"``),
    drawn from ``generator``, which must live there.

    ``zeros``/``ones`` leaves are constant; every other leaf is drawn in
    float32 from N(0, std²), std = ``scale`` or ``1/sqrt(fan_in)``, and cast
    to its dtype (or ``dtype_override``).  Leaves draw in sorted-key order
    from the one generator, so a seed fixes every parameter.
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw on "
                         f"{dev}; make it with torch.Generator({dev.type!r})")

    def one(d: ParamDef) -> torch.Tensor:
        dt = dtype_override or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(_std(d)).to(dt)

    return tree_map(one, tree)


def count_params(tree) -> int:
    return sum(math.prod(d.shape) for d in leaves(tree))


def param_bytes(tree) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in leaves(tree))


def stack_layers(n: int, layer_tree) -> dict:
    """Prefix every ``ParamDef`` with a stacked layer axis of size n.  As
    the reference's, the explicit ``fan_in`` is not carried, so a stacked
    leaf's std comes from its non-layer input dims."""
    return tree_map(lambda d: ParamDef(
        (n, *d.shape), ("layer", *d.axes), dtype=d.dtype, init=d.init,
        scale=d.scale), layer_tree)


def zeros(tree, *, device: torch.device | str | None = None) -> dict:
    """Zero tensors of a ``ParamDef`` tree on ``device`` (CUDA unless
    ``device="cpu"``): a decode cache's initial value."""
    dev = resolve_device(device)
    return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype, device=dev),
                    tree)
