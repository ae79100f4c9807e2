"""Step functions and their shardings for every (architecture × input
shape), over a device mesh.

Port of ``repro/launch/steps.py``.  ``build_step`` returns the step
callable, its inputs' definitions (``meta`` tensors: nothing allocated)
and the in/out shardings over a ``core.compat`` mesh.

Sharding policy, as in the reference:

* train/prefill: batch over ("pod", "data") when it divides, else
  replicated; parameters per the logical-axis rule table (default "tp":
  heads/mlp/vocab/experts over "model"; "tp_fsdp" also splits the
  weights' embed dim over the data axes).
* decode: batch over the data axes when it divides; otherwise (B = 1)
  the KV cache's *sequence* dim is split over the data axes instead, and
  the softmax is combined over them (flash-decode).  "tp_cacheseq" pins
  the cache sequence to "model".

Where the reference hands a whole-array step to GSPMD, the port runs the
partitioned program itself (``models.spmd``): parameters, optimizer
moments, caches and logits are DTensors on the mesh's ``DeviceMesh``
(placements from ``specs``); a step takes each one's local shard, runs
the model on the shards with the collectives the partitioning needs, and
returns DTensors.  Every mesh, one rank's too, takes them in that one
form (``convert.shard_params`` places a whole parameter tree).  The
batch and the decode tokens are plain tensors, the global batch, the
same on every rank: each rank takes its block.

There is no ``donate_argnums``: the train step updates the parameters
and moments in place (AdamW on the DTensors' local shards), and the
decode step writes the cache in place; each returns the objects it was
given.  A world of one is a (1, 1) mesh on the same code path.

The train step's gradients come from ``torch.autograd.grad`` of
``model.loss``, with per-layer remat; with ``microbatch`` M > 1 (and a
batch that splits into data shards × M) each rank cuts its block into M
microbatches whose gradients are summed in f32 and divided by M.  The
data-parallel gradient is the ``all_reduce`` over the data axes divided
by their size (a ``tp_fsdp`` weight's comes from its gather's
``reduce_scatter``).  The kernels stay off for training: they have no
backward (``kernels.ops``).

Two keywords of the reference, which only the dry run's cost probes and
``perf`` pass, are accepted and change nothing:

* ``unroll`` (every step): the reference scans its layers with
  ``lax.scan`` and unrolls them for the probes; the port's layer loops
  are Python loops either way (``models.scanning.scan_blocks``).
* ``microbatch_unroll`` (train): the reference's scanned accumulation
  all-reduces each microbatch's gradient, and its unrolled one lets XLA
  merge the M all-reduces into one of the summed gradients.  The port's
  accumulation already sums the M gradients locally and reduces once
  after the loop, so its gradient all-reduce bytes are those of the
  reference's unrolled form, 1/M of its scanned one's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.data.synthetic import batch_spec
from repro_torch.launch.mesh import data_axes
from repro_torch.models import build_model, spmd
from repro_torch.models.spmd import is_dtensor, local  # noqa: F401
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.params import (RULES, ParamDef, abstract, leaves,
                                       specs, tree_map)
from repro_torch.optim import AdamWConfig, adamw_update


def _data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def rule_table(mesh, batch: int, rules: str = "tp") -> dict:
    """Resolve the logical-axis table for this mesh + batch size."""
    t = dict(RULES[rules])
    daxes = data_axes(mesh)
    shardable = batch % _data_size(mesh) == 0
    t["batch"] = daxes if shardable else None
    if t.get("cache_seq") is None:          # rule tables may pin it
        t["cache_seq"] = None if shardable else daxes
    # FSDP rules reference a bare "data" axis; with a pod axis the weight
    # shards span both.
    if t.get("embed") == "data":
        t["embed"] = daxes
    return t


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``.  ``spec`` has
    one entry per tensor dim (None, an axis name or a tuple of names)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(dim)`` for the
        dim whose entry names the axis (axes of one entry split it
        outer-first, as the reference's tuples do), else ``Replicate``."""
        out = []
        for name in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec) if name in _axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local_block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``t``."""
        for dim, e in enumerate(self.spec):
            axes = _axes(e)
            if axes:
                k = self.mesh.size(axes)
                n = t.shape[dim] // k
                t = t.narrow(dim, self.mesh.axis_index(axes) * n, n)
        return t

    def wrap(self, local: torch.Tensor, shape) -> Any:
        """``local`` (this rank's block) as the DTensor of global
        ``shape``."""
        shape = torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh.device_mesh,
                                  self.placements, run_check=False,
                                  shape=shape, stride=stride)

    def distribute(self, t: torch.Tensor) -> Any:
        """The whole tensor ``t`` (the same on every rank) as a DTensor
        that owns a copy of this rank's block (steps update it in
        place)."""
        return self.wrap(self.local_block(t).clone(
            memory_format=torch.contiguous_format), t.shape)


def named(mesh, spec_tree):
    """A ``NamedSharding`` per spec of the tree."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def batch_shardings(mesh, spec: dict, batch: int) -> dict:
    daxes = data_axes(mesh)
    bspec = daxes if batch % _data_size(mesh) == 0 else None
    return {k: NamedSharding(mesh, (bspec, *([None] * (len(shape) - 1))))
            for k, (shape, _) in spec.items()}


def _local_in(t, sh: NamedSharding) -> torch.Tensor:
    """The local shard of a placed step input (a parameter, a moment, a
    cache leaf: DTensors placed as ``sh``, on every mesh, one rank's
    too)."""
    if not is_dtensor(t):
        raise TypeError(f"a plain tensor of shape {tuple(t.shape)} where "
                        f"the step takes a DTensor placed as {sh.spec} "
                        f"(convert.shard_params)")
    if tuple(t.placements) != sh.placements:
        raise ValueError(f"input placed {t.placements}, the step wants "
                         f"{sh.placements}")
    return t.to_local()


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one step: the callable, its inputs'
    definitions, positional (``meta`` tensors for parameters, optimizer
    state and caches, the ``batch_spec`` for a batch), and the shardings
    of its inputs and outputs (``NamedSharding`` trees)."""
    fn: Callable
    abstract_inputs: tuple
    in_shardings: tuple
    out_shardings: Any


def _fsdp_dims(spec: tuple, daxes: tuple[str, ...]) -> list[int]:
    return [d for d, e in enumerate(spec) if _axes(e) and
            set(_axes(e)) <= set(daxes)]


def _gather_fsdp(tree, spec_tree, daxes):
    """Every weight dim split over the data axes made whole (tp_fsdp)."""
    def one(t, spec):
        for d in _fsdp_dims(spec, daxes):
            t = spmd.gather(t, _axes(spec[d]), d)
        return t
    return tree_map(one, tree, spec_tree)


def _value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """→ (loss, the gradient of every parameter leaf, as a tree)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves(live)))
    # tree_map visits the leaves in the order leaves() lists them.
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _batch_in(batch: dict, bsh: dict) -> dict:
    """This rank's block of each batch tensor (the global batch, the same
    on every rank)."""
    return {k: bsh[k].local_block(x) for k, x in batch.items()}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, mesh, shape: InputShape,
                     rules: str = "tp",
                     opt: AdamWConfig = AdamWConfig(),
                     remat: bool = True,
                     microbatch: int = 1,
                     microbatch_unroll: bool = False,
                     unroll: bool = False) -> StepBundle:
    del microbatch_unroll, unroll       # no effect (module docstring)
    model = build_model(cfg)
    # Remat lives inside the models (one recomputed body per layer).
    model.remat = remat
    defs = model.param_defs()
    table = rule_table(mesh, shape.global_batch, rules)
    pspecs = specs(defs, table, mesh.shape)
    psh = named(mesh, pspecs)

    def f32(d: ParamDef) -> ParamDef:
        return ParamDef(d.shape, d.axes, dtype=torch.float32, init="zeros")

    abs_opt = abstract({"mu": tree_map(f32, defs), "nu": tree_map(f32, defs),
                        "step": ParamDef((), (), dtype=torch.int32,
                                         init="zeros")})
    opt_sh = {"mu": psh, "nu": psh, "step": NamedSharding(mesh, ())}
    bspec = batch_spec(cfg, shape.global_batch, shape.seq_len, "train")
    bsh = batch_shardings(mesh, bspec, shape.global_batch)

    daxes = data_axes(mesh)
    D = _data_size(mesh)
    batch_sharded = table["batch"] is not None
    shardable = shape.global_batch % (D * microbatch) == 0
    M = microbatch if (microbatch > 1 and shardable) else 1
    fsdp = tree_map(lambda s: bool(_fsdp_dims(s, daxes)), pspecs)

    def loss_fn(p, b):
        return model.loss(_gather_fsdp(p, pspecs, daxes), b)

    def train_step(params, opt_state, batch):
        ctx = spmd.Spmd(mesh, table, batch_sharded=batch_sharded)
        p_loc = tree_map(_local_in, params, psh)
        b_loc = _batch_in(batch, bsh)
        with spmd.running(ctx):
            if M == 1:
                loss, grads = _value_and_grad(loss_fn, p_loc, b_loc)
            else:
                # Gradient accumulation over M microbatches: activation
                # memory scales 1/M while the arithmetic is unchanged.
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), p_loc)
                losses = []
                for i in range(M):
                    mb = {k: x.reshape(M, x.shape[0] // M, *x.shape[1:])[i]
                          for k, x in b_loc.items()}
                    loss_i, g = _value_and_grad(loss_fn, p_loc, mb)
                    for a, x in zip(leaves(grads), leaves(g)):
                        a.add_(x.float())
                    losses.append(loss_i)
                    del g
                for a in leaves(grads):
                    a.div_(M)
                loss = torch.mean(torch.stack(losses))
            if D > 1:
                loss = _data_mean(ctx, grads, fsdp, loss, daxes, D,
                                  batch_sharded)
        grads = tree_map(spmd.like, grads, params)
        params, opt_state, metrics = adamw_update(opt, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    metrics_sh = {k: NamedSharding(mesh, ())
                  for k in ("grad_norm", "lr", "loss")}
    return StepBundle(
        fn=train_step,
        abstract_inputs=(abstract(defs), abs_opt, bspec),
        in_shardings=(psh, opt_sh, bsh),
        out_shardings=(psh, opt_sh, metrics_sh),
    )


def _data_mean(ctx: spmd.Spmd, grads, fsdp, loss: torch.Tensor,
               daxes: tuple[str, ...], D: int, batch_sharded: bool
               ) -> torch.Tensor:
    """Data parallel: every gradient (in place) and the loss become the
    mean over the data shards.  The gradients that the data shards hold
    whole are summed by one ``all_reduce`` per dtype over the data axes;
    a tp_fsdp weight's was summed by its gather's ``reduce_scatter``.  A
    batch that is not sharded gave every data shard the whole gradient,
    so only the tp_fsdp sums need dividing."""
    if batch_sharded:
        by_dtype: dict = {}
        for g, is_fsdp in zip(leaves(grads), leaves(fsdp)):
            if not is_fsdp:
                by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = ctx.all_reduce(torch.cat([g.reshape(-1) for g in group]),
                                  daxes)
            for g, part in zip(group, flat.split([g.numel()
                                                  for g in group])):
                g.copy_(part.view_as(g))
        loss = ctx.all_reduce(loss.contiguous(), daxes) / D
    for g, is_fsdp in zip(leaves(grads), leaves(fsdp)):
        if batch_sharded or is_fsdp:
            g.div_(D)
    return loss


# ---------------------------------------------------------------------------
# Prefill step
# ---------------------------------------------------------------------------

def _logits_sharding(cfg: ModelConfig, mesh, shape: InputShape
                     ) -> NamedSharding:
    daxes = data_axes(mesh)
    shardable = shape.global_batch % _data_size(mesh) == 0
    vocab_ok = cfg.vocab % mesh.shape["model"] == 0
    return NamedSharding(mesh, (daxes if shardable else None, None,
                                "model" if vocab_ok else None))


def _cache_defs(model, shape: InputShape):
    return model.cache_defs(shape.global_batch, shape.seq_len)


def _out_cache(mesh, ctx: spmd.Spmd, cache: dict) -> dict:
    """The cache a prefill placed (``spmd.place_tree``) as DTensors."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(t[k], f"{path}{k}/") for k in sorted(t)}
        spec, shape = ctx.placed[path.rstrip("/")]
        return NamedSharding(mesh, spec).wrap(t, shape)
    return walk(cache, "")


def _placed_params(mesh, model, shape: InputShape, rules: str):
    """→ (parameter defs, rule table, specs, shardings) of a step."""
    defs = model.param_defs()
    table = rule_table(mesh, shape.global_batch, rules)
    pspecs = specs(defs, table, mesh.shape)
    return defs, table, pspecs, named(mesh, pspecs)


def build_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                       rules: str = "tp", unroll: bool = False) -> StepBundle:
    del unroll                          # no effect (module docstring)
    model = build_model(cfg)
    defs, table, pspecs, psh = _placed_params(mesh, model, shape, rules)
    daxes = data_axes(mesh)
    bspec = batch_spec(cfg, shape.global_batch, shape.seq_len, "prefill")
    bsh = batch_shardings(mesh, bspec, shape.global_batch)
    cache_sh = named(mesh, specs(_cache_defs(model, shape), table,
                                 mesh.shape))
    logits_sh = _logits_sharding(cfg, mesh, shape)

    def prefill_step(params, batch):
        ctx = spmd.Spmd(mesh, table, batch_sharded=table["batch"] is not None)
        p_loc = tree_map(_local_in, params, psh)
        b_loc = _batch_in(batch, bsh)
        if cfg.family == "audio":
            b_loc["decode_len"] = shape.seq_len
        with spmd.running(ctx), torch.inference_mode():
            logits, cache = model.prefill(
                _gather_fsdp(p_loc, pspecs, daxes), b_loc)
        gshape = (shape.global_batch, *logits.shape[1:-1], cfg.vocab)
        return logits_sh.wrap(logits, gshape), _out_cache(mesh, ctx, cache)

    return StepBundle(
        fn=prefill_step,
        abstract_inputs=(abstract(defs), bspec),
        in_shardings=(psh, bsh),
        out_shardings=(logits_sh, cache_sh),
    )


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _seq_axes(cache: dict) -> dict[str, tuple[str, ...]]:
    """Path → the mesh axes that split each cache leaf's sequence dim
    (dim 2 of every stacked cache leaf), read off the DTensors."""
    out: dict[str, tuple[str, ...]] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}{k}/" if k not in ("k", "v") else path)
            return
        names = t.device_mesh.mesh_dim_names
        axes = tuple(n for n, pl in zip(names, t.placements)
                     if isinstance(pl, Shard) and pl.dim == 2)
        out[path.rstrip("/")] = axes
    walk(cache, "")
    return out


def build_decode_step(cfg: ModelConfig, mesh, shape: InputShape,
                      rules: str = "tp", unroll: bool = False) -> StepBundle:
    del unroll                          # no effect (module docstring)
    model = build_model(cfg)
    defs, table, pspecs, psh = _placed_params(mesh, model, shape, rules)
    daxes = data_axes(mesh)
    cdefs = _cache_defs(model, shape)
    cache_sh = named(mesh, specs(cdefs, table, mesh.shape))
    shardable = shape.global_batch % _data_size(mesh) == 0
    tok_sh = NamedSharding(mesh, (daxes if shardable else None, None))
    abs_tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                          device="meta")
    abs_pos = torch.empty((), dtype=torch.int32, device="meta")
    pos_sh = NamedSharding(mesh, ())
    logits_sh = _logits_sharding(cfg, mesh, shape)

    def decode_step(params, cache, tokens, pos):
        ctx = spmd.Spmd(mesh, table, batch_sharded=table["batch"] is not None)
        p_loc = tree_map(_local_in, params, psh)
        c_loc = tree_map(_local_in, cache, cache_sh)
        ctx.cache_seq.update(_seq_axes(cache))
        tok = tok_sh.local_block(tokens)
        with spmd.running(ctx), torch.inference_mode():
            logits, _ = model.decode_step(
                _gather_fsdp(p_loc, pspecs, daxes), c_loc, tok, pos)
        gshape = (shape.global_batch, 1, cfg.vocab)
        return logits_sh.wrap(logits, gshape), cache

    return StepBundle(
        fn=decode_step,
        abstract_inputs=(abstract(defs), abstract(cdefs), abs_tok, abs_pos),
        in_shardings=(psh, cache_sh, tok_sh, pos_sh),
        out_shardings=(logits_sh, cache_sh),
    )


def build_step(cfg: ModelConfig, mesh, shape: InputShape,
               rules: str = "tp", **kw) -> StepBundle:
    """Dispatch on the input-shape kind; applies the long_500k window
    override automatically."""
    if shape.name == "long_500k":
        cfg = cfg.with_sliding_windows()
    if shape.kind == "train":
        # Production default: 4 microbatches (gradient accumulation) keep
        # the per-device activation footprint down.
        if len(mesh.ranks) >= 64:
            kw.setdefault("microbatch", 4)
        return build_train_step(cfg, mesh, shape, rules, **kw)
    kw.pop("microbatch", None)
    kw.pop("microbatch_unroll", None)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, rules, **kw)
    return build_decode_step(cfg, mesh, shape, rules, **kw)
