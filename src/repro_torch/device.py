"""Where the port runs: CUDA unless the caller asks for the CPU.

There is no silent fallback: with no CUDA device and no explicit
``device="cpu"``, the entry points raise.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a CUDA device); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


def host_view(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing ``a``'s memory, without a copy.

    numpy has no bfloat16, so bf16 data travels as its 16-bit patterns:
    ``uint16`` arrays (how ``RunStore`` keeps bf16 shards) and ml_dtypes
    ``bfloat16`` arrays both come back as ``torch.bfloat16``.  A read-only
    array (a store memmap, a prefetched chunk) is shared too: the caller
    must not write through the tensor.
    """
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        a = a.view(np.int16)
        bf16 = True
    else:
        bf16 = False
    with warnings.catch_warnings():
        # torch warns that it cannot mark the tensor read-only; the port
        # only reads chunks, so the shared memory is never written.
        warnings.filterwarnings("ignore", message="The given NumPy array "
                                "is not writable")
        t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def as_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device``; float64 becomes float32, as
    JAX does without x64 mode, and 16-bit patterns become bfloat16 (see
    ``host_view``).

    For a CUDA device a C-contiguous host array is read in place
    (read-only chunks included) and the host→device copy is the only copy;
    it is queued with ``non_blocking=True``, so a caller that recycles
    pinned host memory must synchronise the stream first.  A CPU tensor
    must own writable memory, so a read-only array is copied once on the
    host.
    """
    to_cuda = torch.device(device).type == "cuda"
    if isinstance(a, np.ndarray):
        t = host_view(np.require(a, requirements=("C",) if to_cuda
                                 else ("C", "W")))
    else:
        t = torch.as_tensor(a)
    if t.dtype == torch.float64:
        t = t.float()
    # Never non_blocking towards the host: the tensor could be read before
    # its copy lands.
    return t.to(device, non_blocking=to_cuda)
