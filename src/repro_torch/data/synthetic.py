"""Synthetic token batches for the feature backbones.

Port of ``repro/data/synthetic.py`` (``batch_spec``, ``make_batch``) for
the families the port runs (``ssm``, ``hybrid``): a batch is ``tokens``,
int32 ids drawn uniformly from ``[0, vocab)`` with an explicit
``torch.Generator``.  The draws differ from the reference's ``jax.random``
draws.  The vision and audio stubs' embedding inputs come with their
families (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def batch_spec(cfg: ModelConfig, batch: int, seq: int,
               kind: str = "train") -> dict[str, tuple[tuple[int, ...],
                                                       torch.dtype]]:
    """The (shape, dtype) of each tensor of one input batch, by name."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} batches (prefix/source embeddings) are not ported "
            f"yet: ROADMAP queue 1 item 12")
    if kind == "decode":
        return {"tokens": ((batch, 1), torch.int32)}
    return {"tokens": ((batch, seq), torch.int32)}


def make_batch(generator: torch.Generator, cfg: ModelConfig, batch: int,
               seq: int, kind: str = "train", *,
               device: torch.device | str | None = None
               ) -> dict[str, torch.Tensor]:
    """Materialise ``batch_spec`` on ``device`` (CUDA unless
    ``device="cpu"``) from ``generator``, which must live there."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw on "
                         f"{dev}; make it with torch.Generator({dev.type!r})")
    return {name: torch.randint(0, cfg.vocab, shape, generator=generator,
                                device=dev, dtype=dtype)
            for name, (shape, dtype) in batch_spec(cfg, batch, seq,
                                                   kind).items()}
