"""Token samplers for the serving engine.

Port of ``repro/serving/sampler.py``.  The draw comes from an explicit
``torch.Generator`` on the logits' device; its ids differ from
``jax.random.categorical``'s, while the kept set (greedy, ``top_k``,
``top_p``) is the reference's.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 → greedy
    top_k: int | None = None      # restrict to k highest logits
    top_p: float | None = None    # nucleus sampling


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """f32 logits / temperature with every token outside the ``top_k`` /
    ``top_p`` kept set at −inf.  ``top_k`` keeps every logit ≥ the k-th
    largest (ties included); ``top_p`` keeps the logits ≥ that of the
    smallest prefix (by descending logit) whose mass reaches ``top_p``."""
    logits = logits.float() / cfg.temperature
    if cfg.top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    if cfg.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1)
        # As the reference's take_along_axis, an index past the end (mass
        # that never reaches top_p in f32) reads the last entry.
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        thresh = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits >= thresh, logits, -torch.inf)
    return logits


def sample(generator: torch.Generator, logits: torch.Tensor,
           cfg: SamplerConfig) -> torch.Tensor:
    """logits: (B, V) → token ids (B,) int32: the argmax at ``temperature
    <= 0``, else one draw per row from the softmax of the filtered
    logits."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
