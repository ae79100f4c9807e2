"""Encoder-decoder transformer (the Seamless-M4T-style audio family).

Port of ``repro/models/encdec.py``.  The modality frontend (mel
spectrogram and conv feature extractor) is a stub, as in the reference:
a batch carries frame embeddings ``src_embeds`` (B, S_src, d_model), and
this module is the backbone that consumes them: a bidirectional encoder
and a causal decoder with cross-attention.  Encoder and decoder layers
are stacked on a leading layer axis and run through ``scan_blocks``, each
body recomputed in the backward pass when ``remat`` is set.

``prefill`` encodes the source, projects every decoder layer's cross K/V
from it once, and decodes the first token; ``decode_step`` attends to the
self cache, which it updates in place (as ``DecoderLM.decode_step``
does), and densely to the static cross K/V.  For the decode shapes the
cross-attention source is ``CROSS_LEN`` stub frames.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers, spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (ParamDef, init as init_params,
                                       stack_layers, tree_map, zeros)
from repro_torch.models.scanning import remat, scan_blocks

Params = Any

CROSS_LEN = 4096   # stub source frames for decode shapes


def _enc_block_defs(cfg: ModelConfig) -> dict:
    return {
        "norm1": layers.rmsnorm_defs(cfg.d_model),
        "attn": layers.attention_defs(cfg),
        "norm2": layers.rmsnorm_defs(cfg.d_model),
        "mlp": layers.mlp_defs(cfg),
    }


def _dec_block_defs(cfg: ModelConfig) -> dict:
    return {
        "norm1": layers.rmsnorm_defs(cfg.d_model),
        "self_attn": layers.attention_defs(cfg),
        "norm_x": layers.rmsnorm_defs(cfg.d_model),
        "cross_attn": layers.attention_defs(cfg),
        "norm2": layers.rmsnorm_defs(cfg.d_model),
        "mlp": layers.mlp_defs(cfg),
    }


_ENC_VAR = layers.AttnVariant(causal=False)
_CROSS_VAR = layers.AttnVariant(causal=False, use_rope=False)


def _self_variant(cfg: ModelConfig) -> layers.AttnVariant:
    window = cfg.window if "local_attn" in cfg.pattern else None
    return layers.AttnVariant(window=window, softcap=cfg.attn_logit_softcap)


@dataclasses.dataclass
class EncDecLM:
    cfg: ModelConfig
    remat: bool = True        # recompute each layer body in the backward

    # -- parameter / cache definition trees --------------------------------
    def param_defs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": layers.embed_defs(cfg),
            "encoder": stack_layers(cfg.n_encoder_layers,
                                    _enc_block_defs(cfg)),
            "decoder": stack_layers(cfg.n_layers, _dec_block_defs(cfg)),
            "enc_final_norm": layers.rmsnorm_defs(cfg.d_model),
            "final_norm": layers.rmsnorm_defs(cfg.d_model),
        }

    def cache_defs(self, batch: int, seq_len: int,
                   cross_len: int = CROSS_LEN) -> dict:
        cfg = self.cfg
        self_len = min(seq_len, cfg.window) if "local_attn" in cfg.pattern \
            else seq_len
        kv, hd, dt = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.param_dtype
        cross = ParamDef((cfg.n_layers, batch, cross_len, kv, hd),
                         ("layer", "batch", "cache_seq", "kv", None),
                         dtype=dt, init="zeros")
        return {
            "self": stack_layers(cfg.n_layers, layers.attn_cache_defs(
                cfg, batch, self_len)),
            # Encoder K/V per decoder layer (static during decode).
            "cross_k": cross,
            "cross_v": cross,
        }

    def init(self, generator: torch.Generator, *,
             device: torch.device | str | None = None) -> dict:
        """Parameters drawn from ``generator`` on ``device`` (CUDA unless
        ``device="cpu"``)."""
        return init_params(self.param_defs(), generator, device=device)

    def init_cache(self, batch: int, seq_len: int,
                   cross_len: int = CROSS_LEN, *,
                   device: torch.device | str | None = None) -> dict:
        return zeros(self.cache_defs(batch, seq_len, cross_len),
                     device=device)

    # -- encoder ---------------------------------------------------------------
    def encode(self, params: Params, src_embeds: torch.Tensor
               ) -> torch.Tensor:
        """Source frames (B, S_src, d) → encoder output (B, S_src, d)."""
        cfg = self.cfg
        h = src_embeds.to(cfg.param_dtype)
        b, s, _ = h.shape
        positions = layers.positions(b, s, h.device)

        def body(hh, p):
            a = layers.attention(p["attn"], cfg, _ENC_VAR,
                                 layers.rmsnorm(p["norm1"], hh, cfg.norm_eps),
                                 positions)
            hh = hh + a
            f = layers.mlp(p["mlp"], cfg,
                           layers.rmsnorm(p["norm2"], hh, cfg.norm_eps))
            return hh + f, None

        if self.remat:
            body = remat(body)
        h, _ = scan_blocks(body, h, params["encoder"])
        return layers.rmsnorm(params["enc_final_norm"], h, cfg.norm_eps)

    # -- decoder (teacher forcing) ----------------------------------------------
    def _decode_blocks_train(self, params, h, enc_out, positions):
        cfg = self.cfg

        def body(hh, p):
            a = layers.attention(p["self_attn"], cfg, _self_variant(cfg),
                                 layers.rmsnorm(p["norm1"], hh, cfg.norm_eps),
                                 positions)
            hh = hh + a
            x = layers.attention(p["cross_attn"], cfg, _CROSS_VAR,
                                 layers.rmsnorm(p["norm_x"], hh, cfg.norm_eps),
                                 positions, kv_x=enc_out)
            hh = hh + x
            f = layers.mlp(p["mlp"], cfg,
                           layers.rmsnorm(p["norm2"], hh, cfg.norm_eps))
            return hh + f, None

        if self.remat:
            body = remat(body)
        h, _ = scan_blocks(body, h, params["decoder"])
        return h

    def _hidden(self, params: Params, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        enc_out = self.encode(params, batch["src_embeds"])
        h = layers.embed(params["embed"], cfg, batch["tokens"])
        b, s, _ = h.shape
        h = self._decode_blocks_train(params, h, enc_out,
                                      layers.positions(b, s, h.device))
        return layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)

    def hidden_states(self, params: Params, batch: dict) -> torch.Tensor:
        """Decoder final hidden states (B, S_tgt, d): the encoding-feature
        hook, one row per target token."""
        with torch.inference_mode():
            return self._hidden(params, batch)

    def forward(self, params: Params, batch: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """→ (f32 logits (B, S_tgt, V), aux loss 0)."""
        with torch.inference_mode():
            h = self._hidden(params, batch)
            return (layers.unembed(params["embed"], self.cfg, h),
                    torch.zeros((), dtype=torch.float32, device=h.device))

    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Next-token cross-entropy over the target tokens."""
        from repro_torch.models import losses
        h = self._hidden(params, batch)
        return losses.next_token_nll(params["embed"], self.cfg, h,
                                     batch["tokens"])

    # -- incremental decode -------------------------------------------------------
    def prefill(self, params: Params, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        """Encode the (long) source, cross-attend from the first token →
        (logits (B, 1, V), cache).  The self cache holds
        ``batch["decode_len"]`` positions, else as many as the batch has
        tokens."""
        cfg = self.cfg
        with torch.inference_mode():
            enc_out = self.encode(params, batch["src_embeds"])
            b, cross_len = enc_out.shape[:2]

            # Each decoder layer's cross K/V, projected once.
            def kv_body(_, p):
                k = torch.einsum("bsd,dnk->bsnk", enc_out,
                                 p["cross_attn"]["wk"])
                v = torch.einsum("bsd,dnk->bsnk", enc_out,
                                 p["cross_attn"]["wv"])
                return None, (k.to(cfg.param_dtype), v.to(cfg.param_dtype))

            _, (cross_k, cross_v) = scan_blocks(kv_body, None,
                                                params["decoder"])
            tokens = batch.get("tokens")
            if tokens is None:
                tokens = torch.zeros((b, 1), dtype=torch.int32,
                                     device=enc_out.device)
            seq_len = batch.get("decode_len", tokens.shape[1])
            defs = self.cache_defs(spmd.global_batch(b), seq_len, cross_len)
            # In a sharded step: this rank's block of each cache leaf.
            cross = spmd.place_tree({"cross_k": cross_k, "cross_v": cross_v},
                                    {k: defs[k] for k in ("cross_k",
                                                          "cross_v")})
            spmd.note_cache(defs)
            cache = {"self": tree_map(
                lambda d: spmd.local_zeros(d, enc_out.device), defs["self"]),
                **cross}
            return self.decode_step(params, cache, tokens[:, :1], 0)

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    pos) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1); pos: absolute position (int or 0-d tensor).
        → (logits (B, 1, V), the cache, its self part updated in place)."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        with torch.inference_mode():
            h = layers.embed(params["embed"], cfg, tokens)
            sc = cache["self"]
            for i in range(cfg.n_layers):
                p = tree_map(lambda a: a[i], params["decoder"])
                a, _ = layers.attention_decode(
                    p["self_attn"], cfg, _self_variant(cfg),
                    layers.rmsnorm(p["norm1"], h, cfg.norm_eps), pos,
                    {"k": sc["k"][i], "v": sc["v"][i]},
                    spmd.seq_axes("self"))
                h = h + a
                # Cross-attention: dense softmax over every encoder frame.
                x_in = layers.rmsnorm(p["norm_x"], h, cfg.norm_eps)
                q = torch.einsum("bsd,dhk->bshk", x_in,
                                 p["cross_attn"]["wq"])
                if cfg.qk_norm:
                    q = layers.rmsnorm(p["cross_attn"]["q_norm"], q,
                                       cfg.norm_eps)
                q = q * (hd ** -0.5)
                out = layers.decode_attend(
                    cfg, q, cache["cross_k"][i], cache["cross_v"][i], None,
                    None, spmd.seq_axes("cross_k"))
                h = h + layers._out_proj(p["cross_attn"], cfg, out)
                h = h + layers.mlp(p["mlp"], cfg,
                                   layers.rmsnorm(p["norm2"], h,
                                                  cfg.norm_eps))
            h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
            return layers.unembed(params["embed"], cfg, h), cache
