"""Memory-efficient next-token cross-entropy.

Port of ``repro/models/losses.py``.  The label logit is computed directly
from the hidden states and the label tokens' embedding rows (one
(B,S,d)·(B,S,d) contraction), so no (B, S, V) gather exists; the f32
logits feed only the logsumexp.  With ``ce_vocab_chunks > 1`` the
logsumexp runs over vocab chunks, each recomputed in the backward pass
(``scanning.remat``), so only one chunk's f32 logits are live.

In a sharded step whose embedding splits the vocab over ``model``, each
rank takes the logsumexp of its vocab block and the blocks are combined
(the max over the ranks, then the sum of the rescaled exponentials), and
the label logit sums the ranks' rows (``spmd.vocab_lookup``).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.scanning import remat


def _chunk_step(m: torch.Tensor, s: torch.Tensor, h_pred: torch.Tensor,
                e_chunk: torch.Tensor, softcap: float | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One vocab chunk of the running (max, sum of exponentials)."""
    logits = torch.einsum("bsd,vd->bsv", h_pred.float(), e_chunk.float())
    logits = layers._softcap(logits, softcap)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + \
        torch.exp(logits - m_new[..., None]).sum(dim=-1)
    return m_new, s


def _chunked_lse(embed_params, cfg: ModelConfig,
                 h_pred: torch.Tensor) -> torch.Tensor:
    """logsumexp over the vocab in ``ce_vocab_chunks`` recomputed passes."""
    E = embed_params["tok"] if cfg.tie_embeddings else \
        embed_params["out"].T
    C = cfg.ce_vocab_chunks
    V = E.shape[0]
    if V % C:
        raise ValueError(f"vocab {V} does not split into {C} chunks")
    step = remat(_chunk_step)
    b, t, _ = h_pred.shape
    m = torch.full((b, t), -torch.inf, dtype=torch.float32,
                   device=h_pred.device)
    s = torch.zeros((b, t), dtype=torch.float32, device=h_pred.device)
    for e_chunk in E.reshape(C, V // C, E.shape[1]):
        m, s = step(m, s, h_pred, e_chunk, cfg.final_logit_softcap)
    return _combine(m, s, V, cfg.vocab)


def _combine(m: torch.Tensor, s: torch.Tensor, v_local: int,
             vocab: int) -> torch.Tensor:
    """logsumexp from this rank's (max, Σ exp(· − max)) over its vocab
    block, combined over the ranks when the vocab is split."""
    if not spmd.partial(v_local, vocab):
        return m + torch.log(s)
    top = spmd.max_model(m)
    return top + torch.log(spmd.from_model(s * torch.exp(m - top)))


def next_token_nll(embed_params, cfg: ModelConfig, h: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL.  h: (B, S, d) final hidden states aligned with
    ``tokens`` (B, S) → f32 scalar."""
    h_pred = h[:, :-1, :]
    tgt = tokens[:, 1:].long()
    E = embed_params["tok"] if cfg.tie_embeddings else \
        embed_params["out"].T
    if cfg.ce_vocab_chunks > 1:
        h_in = spmd.to_model(h_pred) if spmd.partial(E.shape[0],
                                                     cfg.vocab) else h_pred
        lse = _chunked_lse(embed_params, cfg, h_in)
    else:
        # Full f32 logits feed only the logsumexp reduction.
        logits = layers.unembed(embed_params, cfg, h_pred)
        if spmd.partial(logits.shape[-1], cfg.vocab):
            m = logits.amax(dim=-1).detach()
            lse = _combine(m, torch.exp(logits - m[..., None]).sum(-1),
                           logits.shape[-1], cfg.vocab)
        else:
            lse = torch.logsumexp(logits, dim=-1)
    # Label logit from the embedding rows: no (B, S, V) gather.
    e = spmd.vocab_lookup(E, tgt, cfg.vocab)             # (B, S-1, d)
    lbl = torch.einsum("bsd,bsd->bs", h_pred.float(), e.float())
    lbl = layers._softcap(lbl, cfg.final_logit_softcap)
    return torch.mean(lse - lbl)
