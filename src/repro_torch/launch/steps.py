"""The training step on one device.

Port of the training half of ``repro/launch/steps.py``: ``build_train_step``
returns the step callable ``train_step(params, opt_state, batch) →
(params, opt_state, metrics)`` and the definition trees of its inputs.
Gradients come from ``torch.autograd.grad`` of ``model.loss``, with the
model's per-layer ``remat``; with ``microbatch`` M > 1 (and a batch that
splits into M) the batch is cut into M equal microbatches along its
leading axis, their gradients summed in f32 in microbatch order and
divided by M, and the loss is the mean of theirs, as in the reference.
Then ``adamw_update``, which updates the parameters and the optimizer
state in place: the step returns the trees it was given.

The reference also returns the step's shardings over a device mesh, and
builds the prefill and decode steps with them; those, and the rule
tables, come with the mesh (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.data.synthetic import batch_spec
from repro_torch.models import build_model
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.params import ParamDef, leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_update


@dataclasses.dataclass
class StepBundle:
    """One step: the callable and its inputs' definitions, positional
    (``ParamDef`` trees for the parameters and optimizer state, the
    ``batch_spec`` for the batch)."""
    fn: Callable
    abstract_inputs: tuple


def _value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """→ (loss, the gradient of every parameter leaf, as a tree)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves(live)))
    # tree_map visits the leaves in the order leaves() lists them.
    return loss.detach(), tree_map(lambda _: next(grads), params)


def build_train_step(cfg: ModelConfig, shape: InputShape,
                     opt: AdamWConfig = AdamWConfig(), remat: bool = True,
                     microbatch: int = 1) -> StepBundle:
    model = build_model(cfg)
    # Remat lives inside the models (one recomputed body per layer).
    model.remat = remat
    defs = model.param_defs()

    def f32(d: ParamDef) -> ParamDef:
        return ParamDef(d.shape, d.axes, dtype=torch.float32, init="zeros")

    abs_opt = {"mu": tree_map(f32, defs), "nu": tree_map(f32, defs),
               "step": ParamDef((), (), dtype=torch.int32, init="zeros")}
    bspec = batch_spec(cfg, shape.global_batch, shape.seq_len, "train")
    M = microbatch if (microbatch > 1 and
                       shape.global_batch % microbatch == 0) else 1

    def train_step(params, opt_state, batch):
        if M == 1:
            loss, grads = _value_and_grad(model.loss, params, batch)
        else:
            # Gradient accumulation over M microbatches: activation memory
            # scales 1/M while the arithmetic is unchanged.
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(M):
                mb = {k: x.reshape(M, x.shape[0] // M, *x.shape[1:])[i]
                      for k, x in batch.items()}
                loss_i, g = _value_and_grad(model.loss, params, mb)
                for a, x in zip(leaves(grads), leaves(g)):
                    a.add_(x.float())
                losses.append(loss_i)
                del g
            for a in leaves(grads):
                a.div_(M)
            loss = torch.mean(torch.stack(losses))
        params, opt_state, metrics = adamw_update(opt, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return StepBundle(fn=train_step, abstract_inputs=(defs, abs_opt, bspec))
