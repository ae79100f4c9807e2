"""AdamW with decoupled weight decay and global-norm gradient clipping.

Port of ``repro/optim/adamw.py``, on nested dicts of tensors (the
parameter trees of ``models.params``).  The moments are f32 whatever the
parameter dtype; the arithmetic keeps the reference's order: the clip
scale ``min(1, c/(‖g‖ + 1e-9))``, the moments, the bias corrections at
the f32 step, ``u + wd·p`` in f32, then the cast back to the parameter's
dtype.  ``global_norm`` sums the leaves in the reference's leaf order
(dict keys sorted).  ``adamw_update`` writes the parameters and moments
in place, so a step holds one copy of them, not two.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

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
    """f32 zero moments shaped as ``params`` and an int32 step of 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step_dev = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over the leaves, in order, of Σ x²), in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 lr_scale: torch.Tensor | float = 1.0
                 ) -> tuple[Any, dict, dict]:
    """→ (params, state, metrics {grad_norm, lr}).  ``params`` and the
    state's moments and step are updated in place, leaf by leaf (the
    reference donates them to its step), and returned; each leaf's
    arithmetic is the reference's, op by op."""
    step = state["step"]
    step.add_(1)
    gnorm = global_norm(grads)
    scale = (None if cfg.grad_clip_norm is None else
             torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = cfg.lr * lr_scale
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["mu"]), leaves(state["nu"])):
            g = g.float() if scale is None else g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
    return params, state, {
        "grad_norm": gnorm,
        "lr": torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)}
