"""Plain PyTorch versions of the port's kernels (f32 accumulation).

The CPU path runs these, the tests hold them against ``repro.kernels.ref``
and the Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  On a CUDA device the main path never calls them.
"""
from __future__ import annotations

from typing import Sequence

import torch


def xty(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``XᵀY`` in f32.  (n, p), (n, q) → (p, q)."""
    return torch.matmul(x.T.float(), y.float())


def gram(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` in f32.  (n, p) → (p, p)."""
    return xty(x, x)


def xty_folds(x: torch.Tensor, y: torch.Tensor,
              bounds: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Per-fold ``out[f] = X[lo:hi]ᵀ Y[lo:hi]`` in f32.  → (k, p, q)."""
    return torch.stack([xty(x[lo:hi], y[lo:hi]) for lo, hi in bounds])


def xty_folds_masked(x: torch.Tensor, z: torch.Tensor,
                     onehot: torch.Tensor) -> torch.Tensor:
    """Per-slot masked ``out[s] = (x · onehot[:, s])ᵀ z`` in f32.

    The reference's XLA formula (``repro/core/foldstats.py:241-244``): the
    masked operand ``(s, m, p)`` is built, then contracted over rows.
    x: (m, p), z: (m, q), onehot: (m, s) → (s, p, q).
    """
    xw = x.float()[None] * onehot.float().T[:, :, None]
    return torch.einsum("smp,mq->spq", xw, z.float())
