"""Mixture-of-Experts FFN: top-k router + capacity-bounded one-hot dispatch.

Port of ``repro/models/moe.py`` (GShard/Switch-style dispatch).  Tokens
are processed in groups of ``group_size``; each group routes its tokens to
at most ``C = max(1, int(G·K·capacity_factor/E))`` slots per expert, slot
0 of every token ahead of slot 1, and a token routed past an expert's
capacity is dropped from that expert.  The reference maps one group's
dispatch over the groups with ``vmap``; here every product carries the
group axis ``n`` instead.  The router, the dispatch and the combine run in
f32, as the reference's do.

Used by phi3.5-moe (16e top-2) and grok-1 (8e top-2).

In a sharded step every rank routes every token (the router is whole)
and computes its own experts (or, when the expert count does not divide
the ``model`` axis, its block of every expert's hidden units); the
ranks' outputs are summed (``models.spmd``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    d, dff, e, dt = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.param_dtype
    return {
        "router": ParamDef((d, e), ("embed", None), dtype=torch.float32),
        "wi": ParamDef((e, d, 2, dff), ("expert", "embed", None, "mlp"),
                       dtype=dt, fan_in=d),
        "wo": ParamDef((e, dff, d), ("expert", "mlp", "embed"), dtype=dt,
                       fan_in=dff),
    }


def _dispatch_groups(p, cfg: ModelConfig, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n, G, d) → (out (n, G, d), aux loss per group (n,))."""
    m = cfg.moe
    n, G, d = x.shape
    E, K = m.n_experts, m.top_k
    C = max(1, int(G * K * m.capacity_factor / E))

    logits = x.float() @ p["router"]                             # (n, G, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, K, dim=-1)                # (n, G, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # One-hot expert selection per (token, k) slot, flattened in priority
    # order: slot 0 of every token outranks slot 1 (standard top-k priority).
    sel = F.one_hot(idx, E).float()                              # (n,G,K,E)
    sel_flat = sel.transpose(1, 2).reshape(n, K * G, E)          # (n,K·G,E)
    pos = torch.cumsum(sel_flat, dim=1) - 1.0                    # in expert
    keep = (pos < C).float() * sel_flat
    # one_hot(pos, C): a position outside [0, C) selects no slot.
    slots = torch.arange(C, dtype=pos.dtype, device=x.device)
    disp_flat = keep[..., None] * (pos[..., None] == slots).float()
    dispatch = disp_flat.reshape(n, K, G, E, C).transpose(1, 2)  # (n,G,K,E,C)

    combine = torch.einsum("ngk,ngkec->ngec", gate_vals, dispatch)
    disp = dispatch.sum(dim=2)                                   # (n, G, E, C)

    e_loc, f_loc = p["wi"].shape[0], p["wi"].shape[-1]
    split = spmd.partial(e_loc, E) or spmd.partial(f_loc, cfg.d_ff)
    xe = x
    if split:
        # Whole routing, read by this rank's experts (or hidden units).
        xe, combine = spmd.to_model(x), spmd.to_model(combine)
        if e_loc < E:
            e0, e1 = spmd.model_block(E)
            disp, combine = disp[:, :, e0:e1], combine[:, :, e0:e1]
    xin = torch.einsum("ngec,ngd->necd", disp, xe.float()).to(x.dtype)
    h = torch.einsum("necd,edgf->necgf", xin, p["wi"])           # (n,E,C,2,f)
    h = F.silu(h[..., 0, :]) * h[..., 1, :]
    eout = torch.einsum("necf,efd->necd", h, p["wo"])            # (n, E, C, d)
    out = torch.einsum("ngec,necd->ngd", combine, eout.float())
    if split:
        out = spmd.from_model(out)

    # Switch-style load-balance auxiliary loss.
    frac_tokens = sel.sum(dim=2).mean(dim=1)                     # (n, E)
    frac_probs = probs.mean(dim=1)                               # (n, E)
    aux = E * (frac_tokens * frac_probs).sum(dim=-1)
    return out.to(x.dtype), aux


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out, aux loss).  Tokens regrouped to ``group_size``
    (every token in one group when there are fewer).

    The groups are those of the whole batch.  In a sharded step whose
    data ranks' tokens do not split into whole groups, the batch is
    gathered over the data axes for the layer and each rank keeps its
    rows of the output."""
    b, s, d = x.shape
    tokens = spmd.global_batch(b) * s
    g = min(cfg.moe.group_size, tokens)
    if tokens % g:
        raise ValueError(f"{tokens} tokens do not split into MoE groups of "
                         f"{g}")
    spans = (b * s) % g != 0               # a group spans data ranks
    xs = spmd.data_gather(x) if spans else x
    out, aux = _dispatch_groups(p, cfg, xs.reshape(-1, g, d))
    out = out.reshape(xs.shape)
    return (spmd.data_block(out) if spans else out), aux.mean()
