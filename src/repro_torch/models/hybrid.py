"""Zamba2-style hybrid backbone [arXiv:2411.15242]: Mamba2 blocks with a
*shared* (weight-tied) attention+MLP block interleaved at a fixed cadence.

Port of ``repro/models/hybrid.py``.  The repeating pattern is ``(mamba ×
k, shared_attn)``; the per-repeat block parameters are stacked on a
leading ``n_repeats`` axis, and the shared block's parameters live once at
the top level, so every application reuses the same weights while each
keeps its own KV cache slice.  The forward is a Python loop over the
repeats (the reference's ``scan_blocks``); with ``remat`` (the default)
each repeat is recomputed in the backward pass of ``loss``.
``mamba2-130m`` (pattern ``("mamba",)``) runs through the same class.

The prefill is one chunked-SSD pass: the decode cache (SSM final states,
conv tails, shared-attention KV) falls out of it.  ``decode_step`` writes
the new cache entries in place into the stacked cache it is given, as
``DecoderLM.decode_step`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers, spmd, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (init as init_params, stack_layers,
                                       tree_map, zeros)
from repro_torch.models.scanning import remat

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
    """Full-sequence shared block → (h, (k, v)): the keys (RoPE-rotated)
    and values its attention used, which the prefill keeps as the cache."""
    q, k, v = layers._qkv(p["attn"], cfg,
                          layers.rmsnorm(p["norm1"], h, cfg.norm_eps),
                          positions)
    h = h + layers.attend(p["attn"], cfg, _shared_variant(cfg), q, k, v,
                          positions, positions)
    f = layers.mlp(p["mlp"], cfg, layers.rmsnorm(p["norm2"], h, cfg.norm_eps))
    return h + f, (k, v)


def _shared_block_decode(p, cfg, h, pos, cache, seq=()):
    a, _ = layers.attention_decode(
        p["attn"], cfg, _shared_variant(cfg),
        layers.rmsnorm(p["norm1"], h, cfg.norm_eps), pos, cache, seq)
    h = h + a
    return h + layers.mlp(p["mlp"], cfg,
                          layers.rmsnorm(p["norm2"], h, cfg.norm_eps))


def _mamba_block_defs(cfg: ModelConfig) -> dict:
    return {"norm": layers.rmsnorm_defs(cfg.d_model),
            "mixer": ssm.mamba_defs(cfg)}


@dataclasses.dataclass
class HybridLM:
    cfg: ModelConfig
    remat: bool = True        # recompute each repeat in the backward

    def param_defs(self) -> dict:
        cfg = self.cfg
        blocks = {f"b{i}": stack_layers(cfg.n_repeats,
                                        _mamba_block_defs(cfg))
                  for i, kind in enumerate(cfg.pattern) if kind == "mamba"}
        defs = {
            "embed": layers.embed_defs(cfg),
            "blocks": blocks,
            "final_norm": layers.rmsnorm_defs(cfg.d_model),
        }
        if "shared_attn" in cfg.pattern:
            defs["shared"] = _shared_block_defs(cfg)  # single copy — tied
        return defs

    def cache_defs(self, batch: int, seq_len: int) -> dict:
        cfg = self.cfg
        out = {f"b{i}": stack_layers(cfg.n_repeats,
                                     ssm.ssm_cache_defs(cfg, batch))
               for i, kind in enumerate(cfg.pattern) if kind == "mamba"}
        if "shared_attn" in cfg.pattern:
            out["shared"] = stack_layers(
                cfg.n_repeats, layers.attn_cache_defs(
                    cfg, batch, self._shared_len(seq_len)))
        return out

    def _shared_len(self, seq_len: int) -> int:
        return min(seq_len, self.cfg.shared_attn_window or seq_len)

    def init(self, generator: torch.Generator, *,
             device: torch.device | str | None = None) -> dict:
        """Parameters drawn from ``generator`` on ``device`` (CUDA unless
        ``device="cpu"``)."""
        return init_params(self.param_defs(), generator, device=device)

    def init_cache(self, batch: int, seq_len: int, *,
                   device: torch.device | str | None = None) -> dict:
        return zeros(self.cache_defs(batch, seq_len), device=device)

    def _layers(self, params: Params, batch: dict, keep_cache: bool):
        """Embed, every block, final norm → (h, stacked cache or None)."""
        cfg = self.cfg
        h = layers.embed(params["embed"], cfg, batch["tokens"])
        b, s, _ = h.shape
        positions = layers.positions(b, s, h.device)
        shared = params.get("shared")
        # Each leaf allocated at its first write, with the shape computed
        # (this rank's heads in a sharded step).
        cache = {k: {} for k in self.cache_defs(1, s)} if keep_cache \
            else None
        C = self._shared_len(s)

        def body(hh, blks, r):
            """One repeat → h; with ``keep_cache`` its cache entries are
            written into slot r of the stacked cache."""
            for i, kind in enumerate(cfg.pattern):
                if kind == "mamba":
                    blk = blks[f"b{i}"]
                    y = ssm.mamba_apply(
                        blk["mixer"], cfg,
                        layers.rmsnorm(blk["norm"], hh, cfg.norm_eps),
                        return_cache=keep_cache)
                    if keep_cache:
                        y, new = y
                        slot = cache[f"b{i}"]
                    hh = hh + y
                else:
                    hh, (k, v) = _shared_block_train(shared, cfg, hh,
                                                     positions)
                    if keep_cache:
                        new = {"k": layers.ring_cache(k, C),
                               "v": layers.ring_cache(v, C)}
                        slot = cache["shared"]
                if keep_cache:
                    for name, t in new.items():
                        if name not in slot:
                            slot[name] = t.new_empty((cfg.n_repeats,
                                                      *t.shape))
                        slot[name][r] = t
            return hh

        step = remat(body) if self.remat and not keep_cache else body
        for r in range(cfg.n_repeats):
            h = step(h, tree_map(lambda a: a[r], params["blocks"]), r)
        if keep_cache:
            cache = spmd.place_tree(cache, self.cache_defs(
                spmd.global_batch(b), s))
        return layers.rmsnorm(params["final_norm"], h, cfg.norm_eps), cache

    def hidden_states(self, params: Params, batch: dict) -> torch.Tensor:
        """Final-norm hidden states (B, S, d_model): the brain-encoding
        features, one row per token."""
        with torch.inference_mode():
            return self._layers(params, batch, keep_cache=False)[0]

    def forward(self, params: Params, batch: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (f32 logits (B, S, V), aux loss 0)."""
        with torch.inference_mode():
            h = self._layers(params, batch, keep_cache=False)[0]
            return (layers.unembed(params["embed"], self.cfg, h),
                    torch.zeros((), dtype=torch.float32, device=h.device))

    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Next-token cross-entropy over the tokens."""
        from repro_torch.models import losses
        h = self._layers(params, batch, keep_cache=False)[0]
        return losses.next_token_nll(params["embed"], self.cfg, h,
                                     batch["tokens"])

    # -- decode ---------------------------------------------------------------
    def prefill(self, params: Params, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        """Parallel prefill → (last-position logits (B, 1, V), cache)."""
        with torch.inference_mode():
            h, cache = self._layers(params, batch, keep_cache=True)
            return layers.unembed(params["embed"], self.cfg,
                                  h[:, -1:, :]), cache

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    pos) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1); pos: absolute position (int or 0-d tensor).
        → (logits (B, 1, V), the cache, updated in place)."""
        cfg = self.cfg
        shared = params.get("shared")
        with torch.inference_mode():
            h = layers.embed(params["embed"], cfg, tokens)
            for r in range(cfg.n_repeats):
                for i, kind in enumerate(cfg.pattern):
                    if kind == "mamba":
                        blk = tree_map(lambda a: a[r],
                                       params["blocks"][f"b{i}"])
                        c = cache[f"b{i}"]
                        y, nc = ssm.mamba_decode(
                            blk["mixer"], cfg,
                            layers.rmsnorm(blk["norm"], h, cfg.norm_eps),
                            {name: t[r] for name, t in c.items()})
                        for name, t in nc.items():
                            c[name][r] = t
                        h = h + y
                    else:
                        c = cache["shared"]
                        h = _shared_block_decode(
                            shared, cfg, h, pos,
                            {"k": c["k"][r], "v": c["v"][r]},
                            spmd.seq_axes("shared"))
            h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
            return layers.unembed(params["embed"], cfg, h), cache
