"""Synthetic batches for every ported architecture family and shape.

Port of ``repro/data/synthetic.py`` (``batch_spec``, ``make_batch``): a
batch is ``tokens``, int32 ids drawn uniformly from ``[0, vocab)``, and
for the ``vlm`` family the vision stub's ``prefix_embeds`` (bf16 draws of
N(0, 1)) over the first half of the sequence, all from an explicit
``torch.Generator``.  The draws differ from the reference's ``jax.random``
draws.  The audio stub's source embeddings come with ``EncDecLM``
(ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def batch_spec(cfg: ModelConfig, batch: int, seq: int,
               kind: str = "train") -> dict[str, tuple[tuple[int, ...],
                                                       torch.dtype]]:
    """The (shape, dtype) of each tensor of one input batch, by name."""
    if kind == "decode":
        return {"tokens": ((batch, 1), torch.int32)}
    if cfg.family == "audio":
        raise NotImplementedError(
            "audio batches (source embeddings) are not ported yet: ROADMAP "
            "queue 1 item 12")
    if cfg.family == "vlm":
        half = seq // 2
        return {"prefix_embeds": ((batch, half, cfg.d_model), torch.bfloat16),
                "tokens": ((batch, seq - half), torch.int32)}
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
    out = {}
    for name, (shape, dtype) in batch_spec(cfg, batch, seq, kind).items():
        if dtype.is_floating_point:
            out[name] = torch.randn(shape, generator=generator, device=dev,
                                    dtype=torch.float32).to(dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, shape, generator=generator,
                                      device=dev, dtype=dtype)
    return out
