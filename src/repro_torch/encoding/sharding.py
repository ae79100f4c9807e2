"""ShardingPlan — mesh construction and data placement, in one object.

Port of ``repro/encoding/sharding.py``.  A plan maps a ``(n, p) × (n, t)``
ridge problem onto a ``(data, model)`` mesh of ranks
(``core.compat.make_mesh``): rows are rounded to a multiple of the
data-shard count, targets are zero-padded to a multiple of the
target-shard count (the caller slices the padded weight columns off
again), and ``place`` hands this rank its block on the mesh's device.
Rows shard contiguously in mesh order, row-major over the data axes; the
columns of ``Y`` over the target axis.  The reference's
``x_spec``/``y_spec`` become the rank's row and column windows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import compat
from repro_torch.device import as_tensor


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """How a ``(n, p) × (n, t)`` ridge problem maps onto the rank mesh.

    ``data_shards`` splits rows (time samples) — the Gram/psum axis;
    ``target_shards`` splits the columns of Y — the paper's batch axis (c
    in Eq. 7).  ``replicate_rows=True`` is the dual regime, where the
    kernel is small and every rank holds all rows.  ``data_axis`` may be a
    tuple of mesh axes (rows sharded row-major over them).
    """

    data_shards: int = 1
    target_shards: int = 1
    data_axis: str | tuple[str, ...] = "data"
    target_axis: str = "model"
    replicate_rows: bool = False

    @property
    def device_count(self) -> int:
        return self.data_shards * self.target_shards

    def build_mesh(self, device: torch.device | str | None = None
                   ) -> compat.Mesh:
        """The ``(data_shards, target_shards)`` mesh over every rank of the
        default process group (whose world must be exactly that size)."""
        if self.device_count > compat.device_count():
            raise ValueError(f"plan wants {self.device_count} devices, "
                             f"have {compat.device_count()}")
        if not isinstance(self.data_axis, str):
            raise ValueError("build_mesh names one data axis; build a mesh "
                             "over a tuple of data axes with make_mesh")
        return compat.make_mesh((self.data_shards, self.target_shards),
                                (self.data_axis, self.target_axis),
                                device=device)

    # -- shape rounding ------------------------------------------------------
    def round_rows(self, n: int) -> int:
        """Largest row count ≤ n divisible by the data-shard count."""
        if self.replicate_rows:
            return n
        return (n // self.data_shards) * self.data_shards

    def padded_targets(self, t: int) -> int:
        """Smallest target count ≥ t divisible by the target-shard count."""
        c = self.target_shards
        return ((t + c - 1) // c) * c

    def prepare(self, X, Y):
        """Round rows / zero-pad targets so shapes divide the mesh.

        ``X``/``Y`` are numpy arrays or tensors.  → ``(X', Y', t)`` with the
        original target count ``t``; the padded weight columns are sliced
        off again by the caller (``BrainEncoder.fit``).
        """
        t = Y.shape[1]
        keep = self.round_rows(X.shape[0])
        X, Y = X[:keep], Y[:keep]
        pad = self.padded_targets(t) - t
        if pad:
            if isinstance(Y, torch.Tensor):
                Y = torch.cat([Y, Y.new_zeros((Y.shape[0], pad))], dim=1)
            else:
                Y = np.concatenate(
                    [Y, np.zeros((Y.shape[0], pad), Y.dtype)], axis=1)
        return X, Y, t

    # -- placement -----------------------------------------------------------
    def row_window(self, mesh: compat.Mesh, n: int) -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of ``n`` (all of them when rows
        are replicated); ``n`` must divide over the data axis."""
        if self.replicate_rows:
            return 0, n
        c = mesh.size(self.data_axis)
        if n % c:
            raise ValueError(f"n={n} rows do not divide over {c} data "
                             f"shards (round them with prepare)")
        i = mesh.axis_index(self.data_axis)
        return i * (n // c), (i + 1) * (n // c)

    def col_window(self, mesh: compat.Mesh, t: int) -> tuple[int, int]:
        """This rank's target columns ``[lo, hi)`` of ``t``."""
        c = mesh.size(self.target_axis)
        if t % c:
            raise ValueError(f"t={t} targets do not divide over {c} target "
                             f"shards (pad them with prepare)")
        i = mesh.axis_index(self.target_axis)
        return i * (t // c), (i + 1) * (t // c)

    def place(self, mesh: compat.Mesh, X, Y
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's blocks ``(X_l, Y_l)`` on ``mesh.device``: its row
        window of ``X`` and its row × column window of ``Y``."""
        lo, hi = self.row_window(mesh, X.shape[0])
        clo, chi = self.col_window(mesh, Y.shape[1])
        return (as_tensor(_contiguous(X[lo:hi]), mesh.device),
                as_tensor(_contiguous(Y[lo:hi, clo:chi]), mesh.device))


def _contiguous(a):
    return a.contiguous() if isinstance(a, torch.Tensor) \
        else np.ascontiguousarray(a)


__all__ = ["ShardingPlan"]
