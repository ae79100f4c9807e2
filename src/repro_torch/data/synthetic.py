"""Synthetic batches for every ported architecture family and shape.

Port of ``repro/data/synthetic.py`` (``batch_spec``, ``make_batch``,
``TokenStream``): a batch is ``tokens``, int32 ids drawn uniformly from
``[0, vocab)``, plus the modality stubs' embeddings (bf16 draws of
N(0, 1)): for the ``vlm`` family ``prefix_embeds`` over the first half
of the sequence, for the ``audio`` family the source frames
``src_embeds`` (the whole sequence in a prefill, which then has one
token; half of it in a training batch).  All come from an explicit
``torch.Generator``, so the draws differ from the reference's
``jax.random`` draws.
"""
from __future__ import annotations

import numpy as np
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
        if kind == "prefill":
            # Encoder-heavy prefill: the whole sequence is source frames.
            return {"src_embeds": ((batch, seq, cfg.d_model),
                                   torch.bfloat16),
                    "tokens": ((batch, 1), torch.int32)}
        half = seq // 2
        return {"src_embeds": ((batch, half, cfg.d_model), torch.bfloat16),
                "tokens": ((batch, seq - half), torch.int32)}
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


class TokenStream:
    """Deterministic shard-aware synthetic training stream (the training
    driver's data).

    Batch ``step`` of shard ``shard`` is drawn from a generator seeded by
    (seed, step·n_shards + shard) alone, so every data-parallel shard
    reads its own data and a restart at a step reproduces it.
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, shard: int = 0, n_shards: int = 1, *,
                 device: torch.device | str | None = None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.shard, self.n_shards = seed, shard, n_shards
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        index = step * self.n_shards + self.shard
        seed = int(np.random.SeedSequence([self.seed, index])
                   .generate_state(1, np.uint64)[0])
        g = torch.Generator(self.device).manual_seed(seed)
        return make_batch(g, self.cfg, self.batch, self.seq, "train",
                          device=self.device)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
