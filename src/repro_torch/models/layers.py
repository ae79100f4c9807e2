"""Shared transformer building blocks: norms, RoPE, GQA attention (full
sequence and cached decode), gated MLPs, embeddings and the head.

Port of ``repro/models/layers.py``.  Every block is a plain
function over a nested dict of tensors described by the ``*_defs``
``ParamDef`` trees.  Where the reference asks for f32 accumulation
(``preferred_element_type=float32``) the operands are upcast to f32 first:
a bf16 product is exact in f32, so the sum is the f32 sum the reference
takes.

Attention runs one of three paths, on the reference's switches:
``flash_threshold``/``flash_block`` pick the streaming path, and
``flash_kernel`` picks the hand-written kernel (``kernels.ops.mha_flash``)
over the plain block loop (``_blockwise_attention``); otherwise the scores
are materialised.  ``attention_decode`` attends one token against a ring
KV cache that it updates in place.

Inside a sharded step (``models.spmd``) the blocks run on this rank's
shards: the head, KV-head, hidden and vocab counts come from the
parameters' shapes, and ``spmd``'s operators sum the ranks' parts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

Params = Any  # nested dict of tensors

NEG = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_defs(d: int) -> dict:
    return {"scale": ParamDef((d,), (None,), init="ones", dtype=torch.float32)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * p["scale"]).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX interleaving)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcast to (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32,
                                                device=x.device) / half)
    angles = positions[..., None].float() * freqs     # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]             # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions(b: int, s: int, device) -> torch.Tensor:
    """Absolute positions 0 … s−1 of a (b, s) batch, int32."""
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    dt = cfg.param_dtype
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None), dtype=dt,
                       fan_in=d),
        "wk": ParamDef((d, kv, hd), ("embed", "kv", None), dtype=dt, fan_in=d),
        "wv": ParamDef((d, kv, hd), ("embed", "kv", None), dtype=dt, fan_in=d),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed"), dtype=dt),
    }
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_defs(hd)
        defs["k_norm"] = rmsnorm_defs(hd)
    return defs


@dataclasses.dataclass
class AttnVariant:
    window: int | None = None            # None → global causal
    softcap: float | None = None
    causal: bool = True                  # False for encoder self-attn
    use_rope: bool = True                # False for cross-attention


def _split(p: Params, cfg: ModelConfig) -> tuple[bool, bool]:
    """Whether this rank holds a block of the query heads, and of the KV
    heads (K/V stay whole when their count does not divide the axis)."""
    return (spmd.partial(p["wq"].shape[1], cfg.n_heads),
            spmd.partial(p["wk"].shape[1], cfg.n_kv_heads))


def _whole(p: Params, split: bool) -> Params:
    """A replicated parameter subtree read by this rank's heads only."""
    return {k: spmd.to_model(v) for k, v in p.items()} if split else p


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, use_rope: bool = True,
         kv_x: torch.Tensor | None = None,
         kv_positions: torch.Tensor | None = None):
    """→ (q pre-scaled, k, v), on this rank's heads.  ``kv_x`` projects
    K/V from another sequence (cross-attention), at ``kv_positions``."""
    hd = cfg.resolved_head_dim
    heads_split, kv_split = _split(p, cfg)
    xq = spmd.to_model(x) if heads_split else x
    if kv_x is None:
        src = xq if kv_split else x
    else:
        src = spmd.to_model(kv_x) if kv_split else kv_x
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dnk->bsnk", src, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", src, p["wv"])
    if cfg.qk_norm:
        # A whole norm scale applied to this rank's heads only: its
        # gradient sums the ranks'.
        q = rmsnorm(_whole(p["q_norm"], heads_split), q, cfg.norm_eps)
        k = rmsnorm(_whole(p["k_norm"], kv_split), k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_x is None else kv_positions,
                 cfg.rope_theta)
    if heads_split and not kv_split:
        # Whole K/V read by this rank's query heads only.
        k, v = spmd.to_model(k), spmd.to_model(v)
    return q * (hd ** -0.5), k, v


def _out_proj(p: Params, cfg: ModelConfig, out: torch.Tensor
              ) -> torch.Tensor:
    """(B,S,H,K) → (B,S,d) through ``wo``; summed over the ranks' heads."""
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if spmd.partial(p["wo"].shape[0], cfg.n_heads):
        y = spmd.from_model(y)
    return y


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q: (B,S,H,K), k: (B,T,N,K) → (B,N,G,S,T) f32 with H = N·G."""
    b, s, h, hd = q.shape
    g = h // n_kv
    qg = q.reshape(b, s, n_kv, g, hd)
    return torch.einsum("bsngk,btnk->bngst", qg.float(), k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,N,G,S,T), v: (B,T,N,K) → (B,S,H,K)."""
    b, n, g, s, t = probs.shape
    out = torch.einsum("bngst,btnk->bsngk", probs.to(v.dtype), v)
    return out.reshape(b, s, n * g, v.shape[-1])


def _blockwise_attention(cfg: ModelConfig, var: AttnVariant, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor,
                         kv_pos: torch.Tensor) -> torch.Tensor:
    """Streaming (flash-style) attention in plain PyTorch: a loop over q
    blocks and, inside it, over kv blocks with a running-softmax carry, so
    the S×T scores never materialise.

    For sliding-window attention the inner loop is *banded*: only the
    ``window//kb + 2`` KV blocks that can intersect the window are visited
    per Q block.  q: (B,S,H,K) pre-scaled; k/v: (B,T,N,K).  → (B,S,H,K).
    """
    B, S, H, K = q.shape
    T, N = k.shape[1], k.shape[2]
    G = H // N
    bs = cfg.flash_block
    qb, kb = min(bs, S), min(bs, T)
    nq, nk = S // qb, T // kb

    banded = var.window is not None and var.causal
    n_inner = min(nk, var.window // kb + 2) if banded else nk

    out = torch.empty_like(q)
    for i in range(nq):
        qg = q[:, i * qb:(i + 1) * qb].reshape(B, qb, N, G, K).float()
        q_pos = positions[:, i * qb:(i + 1) * qb]
        m = torch.full((B, N, G, qb), NEG, device=q.device)
        l = torch.zeros((B, N, G, qb), device=q.device)
        acc = torch.zeros((B, N, G, qb, K), device=q.device)
        for j in range(n_inner):
            raw = (i - (n_inner - 1) + j) if banded else j
            # Out-of-range banded visits are clipped for safe indexing and
            # masked out (revisiting block 0 must not double-count).
            blk = min(max(raw, 0), nk - 1)
            visit_ok = 0 <= raw <= nk - 1
            k_blk = k[:, blk * kb:(blk + 1) * kb].float()
            v_blk = v[:, blk * kb:(blk + 1) * kb].float()
            k_pos = kv_pos[:, blk * kb:(blk + 1) * kb]
            s = torch.einsum("bqngk,btnk->bngqt", qg, k_blk)
            s = _softcap(s, var.softcap)
            dist = q_pos[:, None, None, :, None] - \
                k_pos[:, None, None, None, :]
            mask = torch.full_like(dist, visit_ok, dtype=torch.bool)
            if var.causal:
                mask &= dist >= 0
            if var.window is not None:
                mask &= dist < var.window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + \
                torch.einsum("bngqt,btnk->bngqk", p, v_blk)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,N,G,qb,K)
        out[:, i * qb:(i + 1) * qb] = o.permute(0, 3, 1, 2, 4).reshape(
            B, qb, H, K).to(q.dtype)
    return out


def attention(p: Params, cfg: ModelConfig, var: AttnVariant, x: torch.Tensor,
              positions: torch.Tensor, kv_x: torch.Tensor | None = None,
              kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill / feature extraction).

    ``kv_x`` enables cross-attention (keys/values from another sequence).
    Switches to the streaming path when the sequence reaches
    ``cfg.flash_threshold`` (None → always dense-materialised scores) and
    both lengths divide by ``cfg.flash_block``.
    """
    if kv_x is None:
        kv_pos = positions
    else:
        kv_pos = kv_positions if kv_positions is not None else \
            torch.arange(kv_x.shape[1], dtype=torch.int32,
                         device=kv_x.device)[None].expand(kv_x.shape[:2])
    q, k, v = _qkv(p, cfg, x, positions, use_rope=var.use_rope, kv_x=kv_x,
                   kv_positions=kv_pos)
    return attend(p, cfg, var, q, k, v, positions, kv_pos)


def attend(p: Params, cfg: ModelConfig, var: AttnVariant, q: torch.Tensor,
           k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
           kv_pos: torch.Tensor) -> torch.Tensor:
    """``attention`` after the projections: q (B,S,H,K) pre-scaled, k/v
    (B,T,N,K) → the output projection (B,S,d).  The prefill calls it on
    the k/v it also keeps as the cache."""
    k, v = spmd.local_kv(k, v, q.shape[2], cfg.n_heads,
                         cfg.n_kv_heads)
    if cfg.flash_threshold is not None and \
            q.shape[1] >= cfg.flash_threshold and \
            q.shape[1] % cfg.flash_block == 0 and \
            k.shape[1] % cfg.flash_block == 0:
        if cfg.flash_kernel:
            # The kernel tiles the sequence itself; flash_block only
            # gates this path, as in the reference.
            out = kernel_ops.mha_flash(
                q, k, v, k.shape[2], causal=var.causal,
                window=var.window, softcap=var.softcap)
        else:
            out = _blockwise_attention(cfg, var, q, k, v, positions, kv_pos)
        return _out_proj(p, cfg, out)

    scores = _gqa_scores(q, k, k.shape[2])           # (B,N,G,S,T)
    scores = _softcap(scores, var.softcap)
    dist = positions[:, None, None, :, None] - kv_pos[:, None, None, None, :]
    mask = torch.ones_like(dist, dtype=torch.bool)
    if var.causal:
        mask &= dist >= 0
    if var.window is not None:
        mask &= dist < var.window
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v)
    return _out_proj(p, cfg, out)


# -- cached decode -----------------------------------------------------------

def attn_cache_defs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.param_dtype
    return {
        "k": ParamDef((batch, cache_len, kv, hd),
                      ("batch", "cache_seq", "kv", None), dtype=dt,
                      init="zeros"),
        "v": ParamDef((batch, cache_len, kv, hd),
                      ("batch", "cache_seq", "kv", None), dtype=dt,
                      init="zeros"),
    }


def ring_cache(x: torch.Tensor, cache_len: int) -> torch.Tensor:
    """The last ``cache_len`` positions of x (B, S, …) as a ring cache:
    rolled so that position t sits in slot ``t % cache_len``, where
    ``attention_decode`` looks for it."""
    s = x.shape[1]
    return torch.roll(x[:, -cache_len:], s % cache_len, dims=1)


def decode_attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, valid: torch.Tensor | None,
                  softcap: float | None, seq: tuple = ()) -> torch.Tensor:
    """One query position against cached K/V: q (B,1,Hq,K) pre-scaled,
    k/v (B,C,N,K), ``valid`` (C,) over the slots (None: every slot) →
    (B,1,Hq,K).

    ``seq`` names the mesh axes that split the cache's slots: each rank
    then scores its slots and the softmax is combined over those axes
    (flash-decode: the max, the sum of exponentials and the weighted
    values, each reduced over the axes)."""
    n_heads = cfg.n_heads
    hq = q.shape[2]
    gathered = bool(seq) and "model" in seq and hq < n_heads
    if gathered:
        # The slots are split on ``model``: every query head meets them.
        q = spmd.gather_model(q, 2)
    k, v = spmd.local_kv(k, v, q.shape[2], n_heads, cfg.n_kv_heads)
    scores = _gqa_scores(q, k, k.shape[2])           # (B,N,G,1,C)
    scores = _softcap(scores, softcap)
    if valid is not None:
        scores = torch.where(valid, scores, NEG)
    if not seq:
        out = _gqa_out(torch.softmax(scores, dim=-1), v)
    else:
        m = spmd.psum(scores.amax(dim=-1, keepdim=True), seq,
                      op=torch.distributed.ReduceOp.MAX)
        e = torch.exp(scores - m)
        den = spmd.psum(e.sum(dim=-1), seq)          # (B,N,G,1)
        b, n, g, s, _ = e.shape
        num = spmd.psum(torch.einsum("bngst,btnk->bsngk", e, v.float()),
                        seq)
        out = (num / den.permute(0, 3, 1, 2)[..., None]).reshape(
            b, s, n * g, v.shape[-1]).to(v.dtype)
    if gathered:
        h0, _ = spmd.model_block(n_heads)
        out = out[:, :, h0:h0 + hq]
    return out


def attention_decode(p: Params, cfg: ModelConfig, var: AttnVariant,
                     x: torch.Tensor, pos: int | torch.Tensor, cache: dict,
                     seq: tuple = ()) -> tuple[torch.Tensor, dict]:
    """One-token decode against a (possibly ring) KV cache.

    x: (B, 1, d); pos: the current absolute position (a Python int or a
    0-d integer tensor, shared by the batch); cache["k"/"v"]: (B, C, N, K).
    The new key and value are written in place into slot ``pos % C`` of
    the cache's tensors (views into a stacked cache write through), which
    are returned.  Keys are stored RoPE-rotated at their absolute write
    position, so ring wraparound keeps relative phases exact.

    ``seq`` names the mesh axes that split the cache's slots in a sharded
    step: this rank holds slots [i·C/n, (i+1)·C/n) and writes the new
    entry only where the slot falls in them.
    """
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, pos.expand(b, 1))
    k, v = cache["k"], cache["v"]
    if k_new.shape[2] < k.shape[2]:
        # The cache keeps every KV head (its slots are split instead).
        k_new, v_new = spmd.gather_model(k_new, 2), spmd.gather_model(
            v_new, 2)
    c_loc = k.shape[1]
    C = c_loc * spmd.size_of(seq)
    first = spmd.index_of(seq) * c_loc
    slot = (pos % C - first).reshape(1)
    if seq:
        # Only the rank that holds the slot changes it.
        mine = (slot >= 0) & (slot < c_loc)
        slot = slot.clamp(0, c_loc - 1)
        k_new = torch.where(mine, k_new.to(k.dtype), k.index_select(1, slot))
        v_new = torch.where(mine, v_new.to(v.dtype), v.index_select(1, slot))
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))
    # Slot j holds absolute position pos - ((pos - j) mod C); valid iff ≥ 0.
    j = first + torch.arange(c_loc, dtype=torch.int64, device=x.device)
    age = (pos - j) % C                      # distance to the current token
    valid = age <= pos
    if var.window is not None:
        valid &= age < var.window
    out = decode_attend(cfg, q, k, v, valid, var.softcap, seq)
    return _out_proj(p, cfg, out), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, dff, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.param_dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "wi": ParamDef((d, 2, dff), ("embed", None, "mlp"), dtype=dt,
                           fan_in=d),
            "wo": ParamDef((dff, d), ("mlp", "embed"), dtype=dt),
        }
    return {
        "wi": ParamDef((d, dff), ("embed", "mlp"), dtype=dt),
        "wo": ParamDef((dff, d), ("mlp", "embed"), dtype=dt),
    }


def mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    split = spmd.partial(p["wo"].shape[0], cfg.d_ff)
    if split:
        x = spmd.to_model(x)
    if cfg.mlp_act in ("swiglu", "geglu"):
        h = torch.einsum("bsd,dcf->bscf", x, p["wi"])
        gate, up = h[..., 0, :], h[..., 1, :]
        act = F.silu(gate) if cfg.mlp_act == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wi"]),
                   approximate="tanh")
    y = torch.einsum("bsf,fd->bsd", h, p["wo"])
    return spmd.from_model(y) if split else y


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> dict:
    # std 0.02: keeps tied-unembedding logits O(1) at init (GPT-2 convention).
    defs = {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            dtype=cfg.param_dtype, scale=0.02)}
    if not cfg.tie_embeddings:
        defs["out"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                               dtype=cfg.param_dtype)
    return defs


def embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = spmd.vocab_lookup(p["tok"], tokens, cfg.vocab)
    if cfg.scale_embedding:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Hidden states (B, S, d) → f32 logits (B, S, V), softcapped; in a
    sharded step, this rank's block of the vocab when the table's vocab
    rows are split."""
    w = p["tok"].float().T if cfg.tie_embeddings else p["out"].float()
    if spmd.partial(w.shape[1], cfg.vocab):
        x = spmd.to_model(x)
    return _softcap(x.float() @ w, cfg.final_logit_softcap)
