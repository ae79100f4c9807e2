"""Multi-device over ``torch.distributed``: the port's counterpart of
``repro/core/compat.py`` (the ``shard_map``/``make_mesh`` shims).

The reference runs one controller over a device mesh: ``shard_map`` hands
each device its block and ``jax.lax.psum`` sums over a mesh axis.  The
port is SPMD over processes instead, as ``python -m torch.distributed.run``
starts them: every rank runs the same entry point on the same host arrays,
takes its own block (``encoding.sharding.ShardingPlan``), computes on its
device, and the collectives of a ``Mesh`` stand in for JAX's:

* ``Mesh.psum(t, axis)``       — ``all_reduce`` (sum) on the axis' group;
* ``Mesh.axis_index(axis)``    — this rank's coordinate, row-major over a
  tuple of axes (``jax.lax.axis_index``);
* ``Mesh.all_gather(t, axis, dim)`` — the blocks of every rank along the
  axis, concatenated in axis order: what the reference returns as one
  global array, every rank ends with in full.

The gather is one ``all_reduce`` that both backends run on CPU and CUDA
tensors alike (gloo has no ``all_gather`` for CUDA tensors): each rank
writes its block into its own slot of a zero-filled buffer, and the
buffer's bytes are summed as integers.  Every element has one non-zero
addend, so the sum is the block's bit pattern exactly, ``-0.0`` and NaN
payloads included (a floating-point slot sum would turn ``-0.0`` into
``+0.0``).

There is no in-process emulation of devices: ``make_mesh`` needs an
initialised default process group with as many ranks as the mesh (all
of them, or the ``devices=`` subset named).  ``init_world_of_one``
makes the world of one process that a (1, 1) mesh runs in.  A mesh also
exposes a ``torch.distributed.device_mesh.DeviceMesh`` over the same
ranks and axis names (``Mesh.device_mesh``), the mesh its DTensors live
on.
Every collective runs under an ``obs`` span (``dist.psum``,
``dist.gather``) with its axis and bytes; under a tracer the span waits
for the card before and after, so it times the collective alone.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.device import resolve_device, sync_if_traced

# Seconds a collective (or the rendezvous) may wait before it fails: a
# rank that died or never arrived fails the run instead of hanging it.
DEFAULT_TIMEOUT_S = 300.0

Axis = str | tuple[str, ...]

# Meshes already built in this process group, by (shape, names, device):
# their groups are reused, since new_group is collective and not free.
# Every rank builds the same meshes in the same order, so the cache hits
# alike on every rank.  A mesh's groups time out as the default group
# that init_from_env created does.
_MESHES: dict[tuple, "Mesh"] = {}
_TIMEOUT_S = [DEFAULT_TIMEOUT_S]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """The world size of the default process group, else 1 (the
    reference's ``jax.device_count()``)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, else 0."""
    return dist.get_rank() if is_initialized() else 0


def init_from_env(device: torch.device | str | None = None,
                  backend: str | None = None, *,
                  init_method: str = "env://",
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group of a process that
    ``torch.distributed.run`` (or a caller setting the same variables)
    started: ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
    environment.  → this rank's device.

    A CUDA rank's card is ``cuda:{LOCAL_RANK % torch.cuda.device_count()}``
    (made the current device), so ranks beyond the card count share cards.
    The backend is ``nccl`` for CUDA and ``gloo`` for the CPU unless the
    caller names ``gloo`` for CUDA (several ranks on one card: NCCL
    refuses two ranks on one GPU); NCCL on the CPU raises.
    """
    rank_ = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices only, not "
                         f"{dev}; use gloo on the CPU")
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank_,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    _TIMEOUT_S[0] = timeout_s
    return dev


def init_world_of_one(device: torch.device | str | None = None
                      ) -> torch.device:
    """Join a default process group of this one process (rank 0 of 1,
    over an in-process store: no address, no file), so a (1, 1) mesh can
    be built without ``torch.distributed.run``.  NCCL for CUDA, gloo for
    the CPU.  → the device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    _TIMEOUT_S[0] = DEFAULT_TIMEOUT_S
    return dev


def shutdown() -> None:
    """Leave the default process group (a no-op without one)."""
    _MESHES.clear()
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank of the default group (a no-op without one)."""
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class Mesh:
    """A named grid of ranks (row-major in rank order) with one process
    group per axis and per tuple of axes — what the reference's
    ``jax.sharding.Mesh`` names, over processes.  Build it with
    ``make_mesh``; ``device`` is where this rank's blocks live."""

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 device: torch.device, timeout_s: float,
                 ranks: Sequence[int] | None = None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = device
        sizes = tuple(self.shape.values())
        # The world rank at each mesh position, row-major.
        self.ranks = tuple(range(math.prod(sizes)) if ranks is None
                           else (int(r) for r in ranks))
        me = dist.get_rank()
        self.member = me in self.ranks
        self.coords = (dict(zip(self.axis_names, _unravel(
            self.ranks.index(me), sizes))) if self.member else None)
        self._device_mesh = None
        # new_group is collective over the whole world: every rank creates
        # every group, in this one order, and keeps the ones it is in.
        self._groups: dict[frozenset, object] = {}
        timeout = datetime.timedelta(seconds=timeout_s)
        idx = range(len(sizes))
        for r in range(1, len(sizes) + 1):
            for axes in itertools.combinations(idx, r):
                others = [i for i in idx if i not in axes]
                for fixed in itertools.product(*(range(sizes[i])
                                                 for i in others)):
                    ranks = []
                    for free in itertools.product(*(range(sizes[i])
                                                    for i in axes)):
                        c = [0] * len(sizes)
                        for i, v in zip(others, fixed):
                            c[i] = v
                        for i, v in zip(axes, free):
                            c[i] = v
                        ranks.append(self.ranks[_ravel(c, sizes)])
                    group = dist.new_group(sorted(ranks), timeout=timeout)
                    if me in ranks:
                        key = frozenset(self.axis_names[i] for i in axes)
                        self._groups[key] = group

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over this mesh's ranks and axis names, built
        on first use (collective: every rank of the world asks for it in
        the same order)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh(
                self.device.type,
                torch.tensor(self.ranks).reshape(tuple(self.shape.values())),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    @staticmethod
    def _axes(axis: Axis) -> tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def size(self, axis: Axis) -> int:
        """Ranks along ``axis`` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in self._axes(axis))

    def axis_index(self, axis: Axis) -> int:
        """This rank's coordinate along ``axis``; for a tuple, row-major
        over its names in the order given (``jax.lax.axis_index``)."""
        i = 0
        for a in self._axes(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axis: Axis):
        """The process group of the ranks along ``axis`` that hold this
        rank (a name or a tuple of names)."""
        if not self.member:
            raise RuntimeError(f"rank {dist.get_rank()} is not in this mesh "
                               f"(ranks {self.ranks})")
        return self._groups[frozenset(self._axes(axis))]

    def psum(self, t: torch.Tensor, axis: Axis) -> torch.Tensor:
        """Sum of ``t`` over the ranks along ``axis`` (``jax.lax.psum``).
        → the sum, in a contiguous tensor (``t`` itself when it is one)."""
        t = t.contiguous()
        if self.size(axis) == 1:
            return t
        with obs.span("dist.psum", axis=str(axis),
                      bytes=t.numel() * t.element_size()):
            sync_if_traced(t.device)
            dist.all_reduce(t, group=self.group(axis))
            sync_if_traced(t.device)
        return t

    def all_gather(self, t: torch.Tensor, axis: Axis,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated on ``dim`` in axis
        order, bit for bit (see the module docstring).  Every rank passes
        the same shape."""
        n = self.size(axis)
        if n == 1:
            return t
        buf = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
        buf[self.axis_index(axis)] = t
        raw = buf.view(-1).view(torch.uint8)
        if raw.numel() % 4 == 0:
            raw = raw.view(torch.int32)
        with obs.span("dist.gather", axis=str(axis),
                      bytes=raw.numel() * raw.element_size()):
            sync_if_traced(t.device)
            dist.all_reduce(raw, group=self.group(axis))
            sync_if_traced(t.device)
        return torch.cat(buf.unbind(0), dim=dim)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank coords {self.coords}, "
                f"{self.device})")


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def _unravel(r: int, sizes: Sequence[int]) -> list[int]:
    out = []
    for s in reversed(sizes):
        out.append(r % s)
        r //= s
    return out[::-1]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              devices: Sequence[int] | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """A ``Mesh`` of the whole world, ranks laid out row-major, or of the
    ranks ``devices`` (the reference's device subset), laid out row-major
    in the order given.

    Raises unless the default process group is initialised with a world
    size equal to the product of ``axis_shapes`` (with ``devices``: unless
    they are that many distinct ranks of the world), and when the group's
    backend is NCCL and ``device`` is not a CUDA device.  Every rank of
    the world builds the mesh (its groups are made collectively); a rank
    outside ``devices`` holds one that it cannot run collectives on
    (``Mesh.member`` is False).  ``device`` defaults to the current CUDA
    device.  A mesh of the same shape, names, ranks and device is built
    once per process group and reused."""
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(axis_shapes)} and names "
                         f"{tuple(axis_names)} differ in length")
    want = math.prod(axis_shapes)
    if not is_initialized():
        raise RuntimeError(
            f"a {tuple(axis_shapes)} mesh needs {want} ranks, but no "
            f"torch.distributed process group is initialised: start the "
            f"ranks with python -m torch.distributed.run and call "
            f"compat.init_from_env()")
    world = dist.get_world_size()
    if devices is None and world != want:
        raise ValueError(
            f"a {tuple(axis_shapes)} mesh over axes {tuple(axis_names)} "
            f"needs a world of exactly {want} ranks, this one has {world}")
    if devices is not None:
        devices = tuple(int(r) for r in devices)
        if len(devices) != want or len(set(devices)) != want or \
                not all(0 <= r < world for r in devices):
            raise ValueError(
                f"a {tuple(axis_shapes)} mesh needs {want} distinct ranks "
                f"of the world of {world}, got devices={devices}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices only, not "
                         f"{dev}")
    key = (tuple(int(s) for s in axis_shapes), tuple(axis_names), devices,
           str(dev))
    if key not in _MESHES:
        _MESHES[key] = Mesh(axis_shapes, axis_names, dev, _TIMEOUT_S[0],
                            ranks=devices)
    return _MESHES[key]


__all__ = ["DEFAULT_TIMEOUT_S", "Mesh", "barrier", "device_count",
           "init_from_env", "init_world_of_one", "is_initialized",
           "make_mesh", "rank", "shutdown"]
