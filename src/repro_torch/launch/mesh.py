"""Production and host meshes over the ``torch.distributed`` world.

Port of ``repro/launch/mesh.py``.  Both meshes are ``core.compat``
meshes (one process a rank), so the port has one mesh type; each also
exposes the ``DeviceMesh`` over the same ranks and axis names
(``Mesh.device_mesh``), on which the steps' DTensors live.

Single pod: 16×16 = 256 ranks, axes (data, model).
Multi-pod:  2×16×16 = 512 ranks, axes (pod, data, model); only
data-parallel collectives cross the "pod" axis.

On H100 hosts of 8 cards a 16-wide ``model`` axis spans two hosts, so
its collectives leave NVLink; the reference's shape is kept for parity.

Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

from repro_torch.core import compat


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) or (2, 16, 16) mesh; raises, naming the 256 or 512
    ranks it needs, in a world of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes, device=device)


def make_host_mesh(model: int = 2, data: int | None = None, pod: int = 1,
                   device=None):
    """A small mesh over every rank of the world (tests, examples and the
    drivers): (data, model), or (pod, data, model) when ``pod`` > 1."""
    n = compat.device_count()
    if data is None:
        data = n // (model * pod)
    if pod * data * model != n:
        raise ValueError(f"a host mesh of pod {pod} × data {data} × model "
                         f"{model} does not cover the world of {n} ranks")
    if pod > 1:
        return compat.make_mesh((pod, data, model), ("pod", "data", "model"),
                                device=device)
    return compat.make_mesh((data, model), ("data", "model"), device=device)


# NVIDIA H100 80GB HBM3 (SXM, 700 W) constants for the roofline analysis
# (per card): the dense bf16 tensor-core peak, the HBM3 rate, and NVLink 4
# (900 GB/s over 18 links).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # bytes/s
ICI_BW_PER_LINK = 50e9          # bytes/s per link


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch/time dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
