"""Decoder-only LM assembly (dense / MoE / VLM families).

Port of ``repro/models/transformer.py``.  Layers are grouped by the
config's repeating ``pattern``; each pattern position's parameters (and
KV cache) are stacked on a leading ``n_repeats`` axis, and the forward is
a Python loop over the repeats (the reference's ``scan_blocks``).  With
``remat`` (the default) each repeat is recomputed in the backward pass of
``loss``, the reference's ``jax.checkpoint`` of its scanned body.

``decode_step`` writes each repeat's new key and value in place into the
stacked cache it is given and returns it: the port's counterpart of the
reference carrying the cache in the scan carry, which keeps one copy of
the cache alive instead of two.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers, moe as moe_lib, spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (ParamDef, init as init_params,
                                       stack_layers, tree_map, zeros)
from repro_torch.models.scanning import remat

Params = Any


def _attn_variant(cfg: ModelConfig, kind: str) -> layers.AttnVariant:
    return layers.AttnVariant(
        window=cfg.window if kind == "local_attn" else None,
        softcap=cfg.attn_logit_softcap, causal=True)


def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    defs = {
        "norm1": layers.rmsnorm_defs(cfg.d_model),
        "attn": layers.attention_defs(cfg),
        "norm2": layers.rmsnorm_defs(cfg.d_model),
    }
    if cfg.use_post_norm:
        defs["post_norm1"] = layers.rmsnorm_defs(cfg.d_model)
        defs["post_norm2"] = layers.rmsnorm_defs(cfg.d_model)
    if cfg.moe is not None:
        defs["ffn"] = moe_lib.moe_defs(cfg)
    else:
        defs["ffn"] = layers.mlp_defs(cfg)
    return defs


def _ffn(p: Params, cfg: ModelConfig, h: torch.Tensor, a: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block after its attention output ``a``: residual, FFN (MoE or
    gated MLP), post-norms → (h, MoE aux loss, None without MoE)."""
    if cfg.use_post_norm:
        a = layers.rmsnorm(p["post_norm1"], a, cfg.norm_eps)
    h = h + a
    f_in = layers.rmsnorm(p["norm2"], h, cfg.norm_eps)
    aux = None
    if cfg.moe is not None:
        f, aux = moe_lib.moe_apply(p["ffn"], cfg, f_in)
    else:
        f = layers.mlp(p["ffn"], cfg, f_in)
    if cfg.use_post_norm:
        f = layers.rmsnorm(p["post_norm2"], f, cfg.norm_eps)
    return h + f, aux


def _block_train(p: Params, cfg: ModelConfig, kind: str, h: torch.Tensor,
                 positions: torch.Tensor):
    """Full-sequence block → (h, aux, (k, v)): the keys (RoPE-rotated) and
    values its attention used, which the prefill keeps as the cache."""
    q, k, v = layers._qkv(p["attn"], cfg,
                          layers.rmsnorm(p["norm1"], h, cfg.norm_eps),
                          positions)
    a = layers.attend(p["attn"], cfg, _attn_variant(cfg, kind), q, k, v,
                      positions, positions)
    h, aux = _ffn(p, cfg, h, a)
    return h, aux, (k, v)


def _block_decode(p: Params, cfg: ModelConfig, kind: str, h: torch.Tensor,
                  pos, cache: dict, seq: tuple = ()) -> torch.Tensor:
    a, _ = layers.attention_decode(
        p["attn"], cfg, _attn_variant(cfg, kind),
        layers.rmsnorm(p["norm1"], h, cfg.norm_eps), pos, cache, seq)
    return _ffn(p, cfg, h, a)[0]


def _cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    if kind == "local_attn":
        return min(cfg.window, seq_len)
    return seq_len


@dataclasses.dataclass
class DecoderLM:
    """The uniform model interface: ``param_defs``/``init``,
    ``hidden_states``/``forward``, ``cache_defs``/``init_cache``,
    ``prefill``/``decode_step``."""

    cfg: ModelConfig
    remat: bool = True        # recompute each repeat in the backward

    # -- parameter / cache definition trees --------------------------------
    def param_defs(self) -> dict:
        cfg = self.cfg
        defs = {
            "embed": layers.embed_defs(cfg),
            "blocks": {f"b{i}": stack_layers(cfg.n_repeats,
                                             _block_defs(cfg, kind))
                       for i, kind in enumerate(cfg.pattern)},
            "final_norm": layers.rmsnorm_defs(cfg.d_model),
        }
        if cfg.frontend == "vision_stub":
            # Projector from the (stub) vision tower to the LM width.
            defs["projector"] = {
                "w": ParamDef((cfg.d_model, cfg.d_model), ("embed", None),
                              dtype=cfg.param_dtype)}
        return defs

    def cache_defs(self, batch: int, seq_len: int) -> dict:
        cfg = self.cfg
        return {f"b{i}": stack_layers(
                    cfg.n_repeats, layers.attn_cache_defs(
                        cfg, batch, _cache_len(cfg, kind, seq_len)))
                for i, kind in enumerate(cfg.pattern)}

    def init(self, generator: torch.Generator, *,
             device: torch.device | str | None = None) -> dict:
        """Parameters drawn from ``generator`` on ``device`` (CUDA unless
        ``device="cpu"``)."""
        return init_params(self.param_defs(), generator, device=device)

    def init_cache(self, batch: int, seq_len: int, *,
                   device: torch.device | str | None = None) -> dict:
        return zeros(self.cache_defs(batch, seq_len), device=device)

    # -- forward ------------------------------------------------------------
    def _inputs_to_h(self, params: Params, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        h = layers.embed(params["embed"], cfg, batch["tokens"])
        if cfg.frontend == "vision_stub" and "prefix_embeds" in batch:
            pe = torch.einsum("bsd,de->bse",
                              batch["prefix_embeds"].to(h.dtype),
                              params["projector"]["w"])
            h = torch.cat([pe, h], dim=1)
        return h

    def _layers(self, params: Params, batch: dict, keep_cache: bool):
        """Embed, every block, final norm → (h, mean MoE aux, stacked
        cache or None)."""
        cfg = self.cfg
        h = self._inputs_to_h(params, batch)
        b, s, _ = h.shape
        positions = layers.positions(b, s, h.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        # Each leaf allocated at its first write, with the shape computed
        # (this rank's KV heads in a sharded step).
        cache = {f"b{i}": {} for i in range(len(cfg.pattern))} \
            if keep_cache else None

        def body(hh, aux, blks):
            """One repeat → (h, aux, each pattern position's (k, v))."""
            kvs = []
            for i, kind in enumerate(cfg.pattern):
                hh, a, kv = _block_train(blks[f"b{i}"], cfg, kind, hh,
                                         positions)
                if a is not None:
                    aux = aux + a
                kvs.append(kv)
            return hh, aux, kvs

        step = body
        if self.remat and not keep_cache:
            step = remat(lambda hh, aux, blks: body(hh, aux, blks)[:2])
        for r in range(cfg.n_repeats):
            out = step(h, aux, tree_map(lambda a: a[r], params["blocks"]))
            h, aux = out[:2]
            if keep_cache:
                for i, kind in enumerate(cfg.pattern):
                    C = _cache_len(cfg, kind, s)
                    k, v = out[2][i]
                    c = cache[f"b{i}"]
                    for name, t in (("k", k), ("v", v)):
                        t = layers.ring_cache(t, C)
                        if name not in c:
                            c[name] = t.new_empty((cfg.n_repeats, *t.shape))
                        c[name][r] = t
        h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        if keep_cache:
            cache = spmd.place_tree(cache, self.cache_defs(
                spmd.global_batch(b), s))
        return h, aux / cfg.n_layers, cache

    def hidden_states(self, params: Params, batch: dict) -> torch.Tensor:
        """Full-sequence forward → final hidden states (B, S, d): the
        brain-encoding features, one row per position (prefix rows
        included)."""
        with torch.inference_mode():
            return self._layers(params, batch, keep_cache=False)[0]

    def forward(self, params: Params, batch: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (f32 logits (B, S, V), mean MoE aux loss)."""
        with torch.inference_mode():
            h, aux, _ = self._layers(params, batch, keep_cache=False)
            return layers.unembed(params["embed"], self.cfg, h), aux

    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Next-token cross-entropy over the token (non-prefix) region,
        plus ``router_aux_weight`` × the mean MoE aux loss."""
        from repro_torch.models import losses
        h, aux, _ = self._layers(params, batch, keep_cache=False)
        tokens = batch["tokens"]
        n_prefix = h.shape[1] - tokens.shape[1]
        ce = losses.next_token_nll(params["embed"], self.cfg,
                                   h[:, n_prefix:, :], tokens)
        w = self.cfg.moe.router_aux_weight if self.cfg.moe else 0.0
        return ce + w * aux

    # -- decode ---------------------------------------------------------------
    def prefill(self, params: Params, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        """Full-sequence forward → (last-position logits (B, 1, V), KV
        cache).  A layer's cache holds the last ``C`` positions' keys and
        values (C the window for a local layer, else the sequence length),
        rolled so position t sits in slot ``t % C``."""
        with torch.inference_mode():
            h, _, cache = self._layers(params, batch, keep_cache=True)
            return layers.unembed(params["embed"], self.cfg,
                                  h[:, -1:, :]), cache

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    pos) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1) current token; pos: absolute position (int or
        0-d tensor).  → (logits (B, 1, V), the cache, updated in place)."""
        cfg = self.cfg
        with torch.inference_mode():
            h = layers.embed(params["embed"], cfg, tokens)
            for r in range(cfg.n_repeats):
                for i, kind in enumerate(cfg.pattern):
                    blk = tree_map(lambda a: a[r], params["blocks"][f"b{i}"])
                    c = cache[f"b{i}"]
                    h = _block_decode(blk, cfg, kind, h, pos,
                                      {"k": c["k"][r], "v": c["v"][r]},
                                      spmd.seq_axes(f"b{i}"))
            h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
            return layers.unembed(params["embed"], cfg, h), cache
