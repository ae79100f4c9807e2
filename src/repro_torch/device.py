"""Where the port runs: CUDA unless the caller asks for the CPU.

There is no silent fallback: with no CUDA device and no explicit
``device="cpu"``, the entry points raise.
"""
from __future__ import annotations

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


def as_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device``; float64 becomes float32, as
    JAX does without x64 mode."""
    t = torch.from_numpy(np.require(a, requirements=("C", "W"))) \
        if isinstance(a, np.ndarray) else torch.as_tensor(a)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)
