"""AdamW with decoupled weight decay and global-norm gradient clipping.

Port of ``repro/optim/adamw.py``, on nested dicts of tensors (the
parameter trees of ``models.params``).  The moments are f32 whatever the
parameter dtype; the arithmetic keeps the reference's order: the clip
scale ``min(1, c/(‖g‖ + 1e-9))``, the moments, the bias corrections at
the f32 step, ``u + wd·p`` in f32, then the cast back to the parameter's
dtype.  ``global_norm`` sums the leaves in the reference's leaf order
(dict keys sorted).  ``adamw_update`` writes the parameters and moments
in place, so a step holds one copy of them, not two.

The leaves may be DTensors (a sharded train step's parameters, moments
and gradients, placed alike): the update is elementwise, so it runs on
each one's local shard; ``global_norm`` sums each leaf's local squares
over the mesh dims that shard it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.models import spmd
from repro_torch.models.params import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float | None = 1.0


def adamw_init(params: Any) -> dict:
    """f32 zero moments shaped (and placed) as ``params`` and an int32 step
    of 0."""
    def zeros(p):
        z = torch.zeros(spmd.local(p).shape, dtype=torch.float32,
                        device=p.device)
        return spmd.like(z, p) if spmd.is_dtensor(p) else z

    step_dev = spmd.local(leaves(params)[0]).device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over the leaves, in order, of Σ x²), in f32.  A DTensor leaf's
    Σ x² is its local shard's, summed over the mesh dims that shard it:
    one ``all_reduce`` per mesh dim for all the leaves sharded alike."""
    xs = leaves(tree)
    sums = [torch.sum(torch.square(spmd.local(x).float())) for x in xs]
    groups: dict = {}
    for i, x in enumerate(xs):
        if not spmd.is_dtensor(x):
            continue
        dims = tuple(d for d, pl in enumerate(x.placements)
                     if isinstance(pl, Shard) and x.device_mesh.size(d) > 1)
        if dims:
            groups.setdefault((id(x.device_mesh), dims),
                              (x.device_mesh, []))[1].append(i)
    for (_, dims), (mesh, idx) in groups.items():
        v = torch.stack([sums[i] for i in idx])
        for d in dims:
            spmd.record("all-reduce", mesh.mesh_dim_names[d],
                        v.numel() * v.element_size())
            dist.all_reduce(v, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            sums[i] = v[j]
    return torch.sqrt(sum(sums))


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 lr_scale: torch.Tensor | float = 1.0
                 ) -> tuple[Any, dict, dict]:
    """→ (params, state, metrics {grad_norm, lr}).  ``params`` and the
    state's moments and step are updated in place, leaf by leaf (the
    reference donates them to its step), and returned; each leaf's
    arithmetic is the reference's, op by op."""
    step = spmd.local(state["step"])
    step.add_(1)
    gnorm = global_norm(grads)
    scale = (None if cfg.grad_clip_norm is None else
             torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = cfg.lr * lr_scale
    with torch.no_grad():
        for p, g, m, v in zip(*(map(spmd.local, leaves(t)) for t in (
                params, grads, state["mu"], state["nu"]))):
            g = g.float() if scale is None else g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
    return params, state, {
        "grad_norm": gnorm,
        "lr": torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)}
