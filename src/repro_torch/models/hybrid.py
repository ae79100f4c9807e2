"""Zamba2-style hybrid backbone [arXiv:2411.15242]: Mamba2 blocks with a
*shared* (weight-tied) attention+MLP block interleaved at a fixed cadence.

Port of ``repro/models/hybrid.py`` for feature extraction
(``hidden_states``).  The repeating pattern is ``(mamba × k,
shared_attn)``; the per-repeat block parameters are stacked on a leading
``n_repeats`` axis, and the shared block's parameters live once at the top
level, so every application reuses the same weights.  The forward is a
Python loop over the repeats (the reference's ``scan_blocks``; its
``remat``/``unroll`` switches are for training and dry runs and are not
carried over).  ``mamba2-130m`` (pattern ``("mamba",)``) runs through the
same class.  Logits, loss, prefill and decode wait for ROADMAP queue 1
item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, init as init_params, tree_map

Params = Any


def _shared_variant(cfg: ModelConfig) -> layers.AttnVariant:
    return layers.AttnVariant(window=cfg.shared_attn_window,
                              softcap=cfg.attn_logit_softcap)


def _shared_block_defs(cfg: ModelConfig) -> dict:
    return {
        "norm1": layers.rmsnorm_defs(cfg.d_model),
        "attn": layers.attention_defs(cfg),
        "norm2": layers.rmsnorm_defs(cfg.d_model),
        "mlp": layers.mlp_defs(cfg),
    }


def _shared_block_train(p, cfg, h, positions):
    a = layers.attention(p["attn"], cfg, _shared_variant(cfg),
                         layers.rmsnorm(p["norm1"], h, cfg.norm_eps),
                         positions)
    h = h + a
    f = layers.mlp(p["mlp"], cfg, layers.rmsnorm(p["norm2"], h, cfg.norm_eps))
    return h + f


def _mamba_block_defs(cfg: ModelConfig) -> dict:
    return {"norm": layers.rmsnorm_defs(cfg.d_model),
            "mixer": ssm.mamba_defs(cfg)}


@dataclasses.dataclass
class HybridLM:
    cfg: ModelConfig

    def param_defs(self) -> dict:
        cfg = self.cfg

        def stack(tree):
            # As the reference's stack: the explicit fan_in is not carried,
            # so a stacked leaf's std comes from its non-layer input dims.
            return tree_map(lambda d: ParamDef(
                (cfg.n_repeats, *d.shape), ("layer", *d.axes), dtype=d.dtype,
                init=d.init, scale=d.scale), tree)

        blocks = {f"b{i}": stack(_mamba_block_defs(cfg))
                  for i, kind in enumerate(cfg.pattern) if kind == "mamba"}
        defs = {
            "embed": layers.embed_defs(cfg),
            "blocks": blocks,
            "final_norm": layers.rmsnorm_defs(cfg.d_model),
        }
        if "shared_attn" in cfg.pattern:
            defs["shared"] = _shared_block_defs(cfg)  # single copy — tied
        return defs

    def init(self, generator: torch.Generator, *,
             device: torch.device | str | None = None) -> dict:
        """Parameters drawn from ``generator`` on ``device`` (CUDA unless
        ``device="cpu"``)."""
        return init_params(self.param_defs(), generator, device=device)

    def hidden_states(self, params: Params, batch: dict) -> torch.Tensor:
        """Final-norm hidden states (B, S, d_model): the brain-encoding
        features, one row per token."""
        cfg = self.cfg
        with torch.inference_mode():
            h = layers.embed(params["embed"], cfg, batch["tokens"])
            b, s, _ = h.shape
            positions = torch.arange(s, dtype=torch.int32,
                                     device=h.device)[None].expand(b, s)
            shared = params.get("shared")
            for r in range(cfg.n_repeats):
                for i, kind in enumerate(cfg.pattern):
                    if kind == "mamba":
                        blk = tree_map(lambda a: a[r],
                                       params["blocks"][f"b{i}"])
                        h = h + ssm.mamba_apply(
                            blk["mixer"], cfg,
                            layers.rmsnorm(blk["norm"], h, cfg.norm_eps))
                    else:
                        h = _shared_block_train(shared, cfg, h, positions)
            return layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
