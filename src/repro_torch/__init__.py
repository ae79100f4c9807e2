"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Each module mirrors the module of the same path in the JAX package, which
stays the reference.  The port imports neither ``jax`` nor ``repro``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.

Exports are lazy (PEP 562), so ``import repro_torch`` does not import torch.
"""
from __future__ import annotations

import importlib

_LAZY = {
    "BrainEncoder": ("repro_torch.encoding.estimator", "BrainEncoder"),
    "EncoderConfig": ("repro_torch.encoding.config", "EncoderConfig"),
    "EncodingReport": ("repro_torch.encoding.estimator", "EncodingReport"),
    "EvaluationReport": ("repro_torch.encoding.estimator",
                         "EvaluationReport"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    module, attr = _LAZY[name]
    return getattr(importlib.import_module(module), attr)
