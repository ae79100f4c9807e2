"""The program each rank runs inside a sharded step.

The reference hands its whole-array step to GSPMD, which partitions it
over the mesh and inserts the collectives.  The port writes the
partitioned program out (Megatron-style tensor parallelism over the
``model`` axis, batch over the data axes): a step (``launch/steps.py``)
takes every parameter's local shard out of its DTensor, and the model
code runs on those shards under ``running(Spmd(...))``.  The blocks read
their local head, expert, hidden and vocab counts from the shards'
shapes, and call the operators below where the partitioned program needs
a collective:

* ``to_model(x)``   — identity forward, ``all_reduce`` over ``model`` in
  the backward: put on a replicated activation before a computation that
  each rank does for its own heads (or experts, hidden units, vocab
  rows), so its gradient sums every rank's part;
* ``from_model(x)`` — ``all_reduce`` over ``model`` forward, identity
  backward: the sum of each rank's partial output (a row-parallel
  product, the vocab-parallel lookup);
* ``gather_model`` / ``max_model`` / ``psum`` — inference-only gathers
  and reductions (the SSM conv cache's channels, the vocab logsumexp's
  max, the flash-decode combine over a sharded cache sequence);
* ``gather`` — ``all_gather`` forward, ``reduce_scatter`` backward: a
  weight dimension sharded over the data axes (``tp_fsdp``) made whole
  for the forward, and the tokens of MoE groups that span data ranks
  (``data_gather``/``data_block``).

Outside ``running`` (one device, no step) there is no context: every
operator is the identity and the shards are the whole tensors, so the
unsharded model and the sharded one are one code path.  A (1, 1) mesh
runs the same program with collectives of one rank, which are skipped.
The context is a stack that ``running`` pushes and pops, as torch's own
modes are, so that the blocks reach it without a parameter added to
every model function.

Every collective is recorded in the context's tally (op kind, mesh axes,
bytes); ``counting()`` collects them, for ``launch.hlo_analysis``.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import data_axes
from repro_torch.models.params import ParamDef, specs

Axes = tuple[str, ...]


def _as_axes(a) -> Axes:
    if a is None:
        return ()
    return (a,) if isinstance(a, str) else tuple(a)


class Tally:
    """Collectives a step issued: (op kind, axes) → [count, bytes]; the
    kinds are the reference's HLO op names."""

    def __init__(self):
        self.ops: dict[tuple[str, Axes], list[int]] = defaultdict(
            lambda: [0, 0])

    def add(self, kind: str, axes: Axes, nbytes: int) -> None:
        row = self.ops[(kind, tuple(axes))]
        row[0] += 1
        row[1] += int(nbytes)


# Tallies being filled (``counting``): every step context built meanwhile
# records into the innermost one.
_COUNTING: list[Tally] = []


@contextlib.contextmanager
def counting():
    """→ a ``Tally`` of every collective the steps run in the block."""
    tally = Tally()
    _COUNTING.append(tally)
    try:
        yield tally
    finally:
        _COUNTING.pop()


def record(kind: str, axes, nbytes: int) -> None:
    """Count a collective issued outside a step context (AdamW's norm)."""
    if _COUNTING:
        _COUNTING[-1].add(kind, _as_axes(axes), nbytes)


class Spmd:
    """One rank's view of a sharded step: the mesh, the resolved rule
    table, whether the batch is sharded, and the placed cache leaves
    (path → the axes splitting the cache sequence, read by ``seq_axes``;
    path → spec and global shape, read by the step)."""

    def __init__(self, mesh, table: dict, *, batch_sharded: bool):
        if list(mesh.ranks) != sorted(mesh.ranks):
            # The gathers concatenate in group order, the ranks' order.
            raise ValueError(f"a step's mesh lays out its ranks in "
                             f"ascending order, not {mesh.ranks}")
        self.mesh = mesh
        self.table = table
        self.m = mesh.shape.get("model", 1)
        self.data = data_axes(mesh)
        self.batch_shards = mesh.size(self.data) if batch_sharded else 1
        self.cache_seq: dict[str, Axes] = {}
        # Cache leaf path → (spec, global shape), as ``place_tree`` put it.
        self.placed: dict[str, tuple] = {}
        self.tally = _COUNTING[-1] if _COUNTING else Tally()

    def spec(self, d: ParamDef) -> tuple:
        """The spec the rule table gives a leaf (global shape)."""
        return specs(d, self.table, self.mesh.shape)

    def size(self, axes) -> int:
        axes = _as_axes(axes)
        return math.prod(self.mesh.shape[a] for a in axes) if axes else 1

    def index(self, axes) -> int:
        axes = _as_axes(axes)
        return self.mesh.axis_index(axes) if axes else 0

    # -- collectives (skipped over one rank) --------------------------------
    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced in place over ``axes`` (contiguous), returned."""
        axes = _as_axes(axes)
        if self.size(axes) == 1:
            return t
        self.tally.add("all-reduce", axes, t.numel() * t.element_size())
        dist.all_reduce(t, op=op, group=self.mesh.group(axes))
        return t

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axes``, concatenated on ``dim`` in
        axis order."""
        axes = _as_axes(axes)
        n = self.size(axes)
        if n == 1:
            return t
        t = t.contiguous().reshape(1, *t.shape)
        out = t.new_empty((n, *t.shape[1:]))
        self.tally.add("all-gather", axes, out.numel() * out.element_size())
        dist.all_gather_into_tensor(out, t, group=self.mesh.group(axes))
        return torch.cat(out.unbind(0), dim=dim)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int
                       ) -> torch.Tensor:
        """Sum of ``t`` over ``axes``, this rank's block of ``dim``."""
        axes = _as_axes(axes)
        n = self.size(axes)
        if n == 1:
            return t
        blocks = torch.stack(t.chunk(n, dim=dim)).reshape(1, -1)
        out = blocks.new_empty((t.numel() // n,))
        self.tally.add("reduce-scatter", axes,
                       blocks.numel() * blocks.element_size())
        dist.reduce_scatter_tensor(out, blocks.reshape(-1),
                                   group=self.mesh.group(axes))
        shape = list(t.shape)
        shape[dim] //= n
        return out.reshape(shape)


_STACK: list[Spmd] = []


@contextlib.contextmanager
def running(ctx: Spmd):
    """Run the model code under ``ctx`` (a step's sharded program)."""
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


def current() -> Spmd | None:
    return _STACK[-1] if _STACK else None


def model_size() -> int:
    ctx = current()
    return ctx.m if ctx is not None else 1


def partial(n_local: int, n_global: int) -> bool:
    """Whether a dim of ``n_global`` entries is split over ``model`` here
    (this rank holds ``n_local`` of them)."""
    return n_local < n_global


def model_block(n_global: int) -> tuple[int, int]:
    """This rank's [start, stop) of a dim of ``n_global`` entries split
    evenly over ``model`` (the whole dim without a context)."""
    ctx = current()
    if ctx is None or ctx.m == 1:
        return 0, n_global
    size = n_global // ctx.m
    i = ctx.index("model")
    return i * size, (i + 1) * size


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.spmd = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.spmd.all_reduce(g.contiguous().clone(), "model"), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return ctx.all_reduce(x.contiguous().clone(), "model")

    @staticmethod
    def backward(fctx, g):
        return g, None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; in the backward, the gradient summed over ``model``."""
    ctx = current()
    if ctx is None or ctx.m == 1 or not (torch.is_grad_enabled()
                                         and x.requires_grad):
        return x
    return _ToModel.apply(x, ctx)


def from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of every ``model`` rank's ``x`` (gradient passed as is)."""
    ctx = current()
    if ctx is None or ctx.m == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _FromModel.apply(x, ctx)
    return ctx.all_reduce(x.contiguous().clone(), "model")


def max_model(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over ``model`` (no gradient)."""
    ctx = current()
    if ctx is None or ctx.m == 1:
        return x
    return ctx.all_reduce(x.detach().contiguous().clone(), "model",
                          op=dist.ReduceOp.MAX)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every ``model`` rank's block of ``x``, concatenated on ``dim``
    (inference only)."""
    ctx = current()
    if ctx is None or ctx.m == 1:
        return x
    return ctx.all_gather(x, "model", dim)


def local_kv(k: torch.Tensor, v: torch.Tensor, h_local: int,
             n_heads: int, n_kv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The KV heads (dim 2) that this rank's ``h_local`` query heads read,
    when the query heads are split over ``model`` and the ``n_kv`` K/V
    heads are whole (their count does not divide the axis).  Query head
    i reads KV head i // (n_heads / n_kv).  K/V split over ``model`` are
    already the rank's own heads' and come back as they are."""
    if h_local == n_heads or k.shape[2] < n_kv:
        return k, v
    group = n_heads // n_kv
    h0, _ = model_block(n_heads)
    if h_local % group == 0 or group % h_local == 0:
        lo = h0 // group
        hi = (h0 + h_local - 1) // group + 1
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.arange(h0, h0 + h_local, device=k.device) // group
    return k.index_select(2, idx), v.index_select(2, idx)


def vocab_lookup(tok: torch.Tensor, tokens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Embedding rows of ``tokens`` from a table whose vocab rows may be
    split over ``model``: each rank looks up the tokens it holds, zeros
    elsewhere, and the ranks' rows are summed."""
    if tok.shape[0] == vocab:
        return tok[tokens]
    v0, _ = model_block(vocab)
    idx = tokens.long() - v0
    hit = (idx >= 0) & (idx < tok.shape[0])
    rows = tok[idx.clamp(0, tok.shape[0] - 1)]
    return from_model(rows * hit[..., None].to(rows.dtype))


def seq_axes(path: str) -> Axes:
    """Mesh axes that split the sequence dim of the cache at ``path``
    (empty when the cache's sequence is whole)."""
    ctx = current()
    return ctx.cache_seq.get(path, ()) if ctx is not None else ()


def size_of(axes) -> int:
    ctx = current()
    return ctx.size(axes) if ctx is not None else 1


def index_of(axes) -> int:
    ctx = current()
    return ctx.index(axes) if ctx is not None else 0


def psum(x: torch.Tensor, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``axes`` (inference only; a copy)."""
    ctx = current()
    if ctx is None or ctx.size(axes) == 1:
        return x
    return ctx.all_reduce(x.detach().contiguous().clone(), axes, op=op)


def global_batch(b_local: int) -> int:
    ctx = current()
    return b_local * (ctx.batch_shards if ctx is not None else 1)


def _place(ctx: Spmd, t: torch.Tensor, d: ParamDef, spec: tuple
           ) -> torch.Tensor:
    """A tensor the model computed, brought to this rank's block of the
    leaf ``d`` (global shape) placed as ``spec``.

    Each dim of ``t`` is whole, or split over ``model`` (computed from
    this rank's heads), or, on the ``batch`` axis, already this rank's
    batch block.  A whole dim is cut to the rank's block; a ``model``
    block the placement does not split on ``model`` is gathered first.
    """
    for dim, (name, n, want) in enumerate(zip(d.axes, d.shape, spec)):
        if name == "batch":
            continue
        have = t.shape[dim]
        want_axes = _as_axes(want)
        if ctx.m > 1 and have * ctx.m == n and want_axes != ("model",):
            t = ctx.all_gather(t, "model", dim)
            have = n
        if have == n and want_axes:
            k = ctx.size(want_axes)
            t = t.narrow(dim, ctx.index(want_axes) * (n // k), n // k)
        elif have != n // ctx.size(want_axes):
            raise ValueError(f"cannot place a dim of {have} as {want} of "
                             f"{n} (axes {d.axes})")
    return t.contiguous()


def place_tree(tree: dict, defs: dict) -> dict:
    """A cache the model computed (a tree of tensors), each leaf brought
    to this rank's block of the placement the rule table gives its
    ``ParamDef`` in ``defs`` (global shapes); ``note_cache`` records the
    placements.  Without a context, ``tree`` as it is."""
    ctx = current()
    if ctx is None:
        return tree
    note_cache(defs)
    out: dict = {}

    def walk(t, d, path, dst):
        for k in sorted(d):
            if isinstance(d[k], dict):
                dst[k] = {}
                walk(t[k], d[k], f"{path}{k}/", dst[k])
            else:
                dst[k] = _place(ctx, t[k], d[k], ctx.placed[path + k][0])
    walk(tree, defs, "", out)
    return out


def note_cache(defs: dict, prefix: str = "") -> None:
    """Record, for each leaf of the cache's ``ParamDef`` tree ``defs``
    (global shapes), its spec and shape (``Spmd.placed``, read by the
    step) and the mesh axes that split its ``cache_seq`` dim
    (``Spmd.cache_seq``, read by ``seq_axes``)."""
    ctx = current()
    if ctx is None:
        return
    for k in sorted(defs):
        d = defs[k]
        if isinstance(d, dict):
            note_cache(d, f"{prefix}{k}/")
            continue
        spec = ctx.spec(d)
        ctx.placed[prefix + k] = (spec, tuple(d.shape))
        if "cache_seq" in d.axes:
            axes = _as_axes(spec[d.axes.index("cache_seq")])
            path = prefix.rstrip("/") if k in ("k", "v") else prefix + k
            ctx.cache_seq[path] = axes


def local_zeros(d: ParamDef, device) -> torch.Tensor:
    """Zeros of this rank's block of a ``ParamDef`` leaf (global shape)."""
    ctx = current()
    shape = d.shape
    if ctx is not None:
        shape = tuple(n // ctx.size(a) for n, a in zip(d.shape, ctx.spec(d)))
    return torch.zeros(shape, dtype=d.dtype, device=device)


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage); a plain tensor as
    it is."""
    return t.to_local() if is_dtensor(t) else t


def like(local: torch.Tensor, dt) -> torch.Tensor:
    """``local`` (a block shaped as the DTensor ``dt``'s local shard) as a
    DTensor placed as ``dt``, sharing ``local``'s storage."""
    return DTensor.from_local(local, dt.device_mesh, dt.placements,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.spmd, fctx.axes, fctx.dim = ctx, axes, dim
        return ctx.all_gather(x, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return (fctx.spmd.reduce_scatter(g.contiguous(), fctx.axes,
                                         fctx.dim), None, None, None)


def gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """A dim split over ``axes`` made whole: gathered in the forward; in
    the backward its gradient is summed over those axes and cut back to
    this rank's block."""
    ctx = current()
    if ctx is None or ctx.size(axes) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, ctx, _as_axes(axes), dim)
    return ctx.all_gather(x, _as_axes(axes), dim)


def data_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole batch (dim 0) of a batch-sharded activation (``gather``
    over the data axes); as it is when the batch is not sharded."""
    ctx = current()
    if ctx is None or ctx.batch_shards == 1:
        return x
    return gather(x, ctx.data, 0)


def data_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the batch (dim 0) of a whole-batch tensor."""
    ctx = current()
    if ctx is None or ctx.batch_shards == 1:
        return x
    n = x.shape[0] // ctx.batch_shards
    return x.narrow(0, ctx.index(ctx.data) * n, n)
