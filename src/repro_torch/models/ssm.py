"""Mamba2 — state-space duality (SSD) blocks [arXiv:2405.21060].

Port of ``repro/models/ssm.py``.  The full-sequence forward (training,
prefill, features) is the chunked SSD algorithm: within a chunk the term
is an attention-like masked product (the hand-written ``ssd_intra`` kernel
when ``ssm.use_kernel`` and ``n_groups == 1``, else the reference's einsum
chain); across chunks a short loop over ``S/chunk`` steps carries the
(H, N, P) state, whose last value is the prefill's decode state
(``return_cache=True``, no token replay).  Decode (``mamba_decode``) is
the single-step recurrence on that state: ``h ← exp(ΔA)·h + (ΔB)⊗x``,
``y = C·h + D·x``.

Every three-operand product of the reference is contracted here in an
order that never builds a (…, Q, H, N, P) tensor: at zamba2-2.7b's full
width (B=8, S=4096, H=80, N=P=64) that tensor would take 43 GB.

In a sharded step a rank holds a block of the heads (``wx``, ``wz``,
``wdt``, the per-head vectors, ``norm``, ``wo``) and the whole B/C
projections and conv weights: it convolves its heads' x channels and the
whole B/C channels, runs the SSD on its heads, and the ranks' output
projections are summed.  The decode cache's conv channels stay whole, so
its x channels are gathered over ``model`` (``models.spmd``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.params import ParamDef


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    return d_inner, heads, s.head_dim, s.n_groups, s.d_state


def mamba_defs(cfg: ModelConfig) -> dict:
    s: SSMConfig = cfg.ssm
    d, dt = cfg.d_model, cfg.param_dtype
    d_inner, H, Pd, G, N = _dims(cfg)
    conv_ch = d_inner + 2 * G * N          # conv over [x, B, C] channels
    f32 = torch.float32
    return {
        "wz": ParamDef((d, H, Pd), ("embed", "heads", None), dtype=dt,
                       fan_in=d),
        "wx": ParamDef((d, H, Pd), ("embed", "heads", None), dtype=dt,
                       fan_in=d),
        "wB": ParamDef((d, G, N), ("embed", None, "state"), dtype=dt,
                       fan_in=d),
        "wC": ParamDef((d, G, N), ("embed", None, "state"), dtype=dt,
                       fan_in=d),
        "wdt": ParamDef((d, H), ("embed", "heads"), dtype=dt),
        "dt_bias": ParamDef((H,), ("heads",), dtype=f32, init="zeros"),
        "A_log": ParamDef((H,), ("heads",), dtype=f32, init="zeros"),
        "D": ParamDef((H,), ("heads",), dtype=f32, init="ones"),
        "conv_w": ParamDef((s.conv_kernel, conv_ch), (None, None), dtype=dt,
                           scale=0.5),
        "conv_b": ParamDef((conv_ch,), (None,), dtype=dt, init="zeros"),
        "norm": ParamDef((H, Pd), ("heads", None), dtype=f32, init="ones"),
        "wo": ParamDef((H, Pd, d), ("heads", None, "embed"), dtype=dt),
    }


def ssm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    s = cfg.ssm
    d_inner, H, Pd, G, N = _dims(cfg)
    conv_ch = d_inner + 2 * G * N
    return {
        "state": ParamDef((batch, H, N, Pd), ("batch", "heads", None, None),
                          dtype=torch.float32, init="zeros"),
        "conv": ParamDef((batch, s.conv_kernel - 1, conv_ch),
                         ("batch", None, None), dtype=cfg.param_dtype,
                         init="zeros"),
    }


def _proj_xbc(p, cfg: ModelConfig, u: torch.Tensor):
    """Project input to this rank's heads' x channels and the whole B/C
    channels (pre-conv, (B, S, H·P) and (B, S, 2·G·N)) and to z/dt."""
    d_inner, H, Pd, G, N = _dims(cfg)
    b, s = u.shape[:2]
    h_loc = p["wx"].shape[1]
    uh = spmd.to_model(u) if spmd.partial(h_loc, H) else u
    x = torch.einsum("bsd,dhp->bshp", uh, p["wx"]).reshape(b, s, h_loc * Pd)
    Bm = torch.einsum("bsd,dgn->bsgn", u, p["wB"]).reshape(b, s, G * N)
    Cm = torch.einsum("bsd,dgn->bsgn", u, p["wC"]).reshape(b, s, G * N)
    bc = torch.cat([Bm, Cm], dim=-1)                  # (B, S, 2·G·N)
    z = torch.einsum("bsd,dhp->bshp", uh, p["wz"])    # (B, S, H, P)
    dt = torch.einsum("bsd,dh->bsh", uh, p["wdt"])    # (B, S, H)
    return x, bc, z, dt


def _conv_weights(p, cfg: ModelConfig, h_loc: int):
    """(w, b) of this rank's x channels and of the B/C channels.  The
    conv weights are whole on every rank; the x block's gradient is
    summed over ``model`` (each rank uses its own channels of it)."""
    d_inner, H, Pd = _dims(cfg)[:3]
    w, b = p["conv_w"], p["conv_b"]
    wx, bx = w[:, :d_inner], b[:d_inner]
    if spmd.partial(h_loc, H):
        h0, h1 = spmd.model_block(H)
        wx = spmd.to_model(wx)[:, h0 * Pd:h1 * Pd]
        bx = spmd.to_model(bx)[h0 * Pd:h1 * Pd]
    return (wx, bx), (w[:, d_inner:], b[d_inner:])


def _causal_conv(wb, xbc: torch.Tensor, kernel: int) -> torch.Tensor:
    """Depthwise causal conv over time.  xbc: (B, S, C); wb: the (k, C)
    weights and (C,) bias of its channels."""
    w, bias = wb
    pad = F.pad(xbc, (0, 0, kernel - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(kernel))
    return F.silu(out + bias[None, None, :])


def _heads_groups(cfg: ModelConfig, h_loc: int, Bm, Cm):
    """B/C (…, G, N) cut to the groups of this rank's heads → (Bm, Cm,
    heads per group here)."""
    d_inner, H, Pd, G, N = _dims(cfg)
    hpg = H // G
    if h_loc == H:
        return Bm, Cm, hpg
    if h_loc % hpg and hpg % h_loc:
        raise ValueError(f"{h_loc} heads a rank do not align with SSM "
                         f"groups of {hpg} heads")
    h0, _ = spmd.model_block(H)
    g0, g1 = h0 // hpg, (h0 + h_loc - 1) // hpg + 1
    return Bm[..., g0:g1, :], Cm[..., g0:g1, :], min(hpg, h_loc)


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mamba2 gated RMSNorm: norm(y · silu(z)) with per-(head, dim) scale."""
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * p["norm"]).to(y.dtype)


def _y_intra_plain(Cc, Bc, La, xc):
    """The reference's einsum chain for the within-chunk term:
    ``y[q,h,p] = Σ_{k≤q} exp(La_q − La_k)·(C_q·B_k)·x[k,h,p]``.
    Cc/Bc (B,nc,Q,G,N), La (B,nc,Q,H), xc (B,nc,Q,H,P) → (B,nc,Q,H,P)."""
    B_, nc, Q, G, _ = Cc.shape
    H = La.shape[-1]
    diff = La[:, :, :, None, :] - La[:, :, None, :, :]        # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=La.device))
    # Mask in log space before exp: diff > 0 above the diagonal would
    # overflow.
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  -torch.inf))
    scores = torch.einsum("bcqgn,bckgn->bcqkg", Cc, Bc)      # (B,nc,Q,Q,G)
    # Heads of group g are g·H/G … (g+1)·H/G − 1, as jnp.repeat orders them.
    scores = (scores[..., None] * decay.reshape(B_, nc, Q, Q, G, H // G)
              ).reshape(B_, nc, Q, Q, H)
    return torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)


def mamba_apply(p, cfg: ModelConfig, u: torch.Tensor,
                return_cache: bool = False):
    """Full-sequence SSD.  u: (B, S, d) → (B, S, d).

    With ``return_cache`` also returns the decode cache {state, conv}: the
    state after the last chunk and the last ``conv_kernel − 1`` positions'
    pre-conv channels."""
    s_cfg = cfg.ssm
    d_inner, H, Pd, G, N = _dims(cfg)
    B_, S, _ = u.shape
    Q = min(s_cfg.chunk, S)
    if S % Q != 0:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {Q}")
    nc = S // Q
    h_all, H = H, p["wx"].shape[1]           # this rank's heads

    x_raw, bc_raw, z, dt = _proj_xbc(p, cfg, u)
    wb_x, wb_bc = _conv_weights(p, cfg, H)
    x = _causal_conv(wb_x, x_raw, s_cfg.conv_kernel).reshape(B_, S, H, Pd)
    bc = _causal_conv(wb_bc, bc_raw, s_cfg.conv_kernel)
    if H < h_all:
        bc = spmd.to_model(bc)               # read by this rank's heads
    Bm = bc[..., :G * N].reshape(B_, S, G, N)
    Cm = bc[..., G * N:].reshape(B_, S, G, N)
    Bm, Cm, hpg = _heads_groups(cfg, H, Bm, Cm)
    G = Bm.shape[2]
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,) < 0

    # Chunked views.
    xc = (x.float() * dt[..., None]).reshape(B_, nc, Q, H, Pd)
    Bc = Bm.float().reshape(B_, nc, Q, G, N)
    Cc = Cm.float().reshape(B_, nc, Q, G, N)
    la = (dt * A[None, None, :]).reshape(B_, nc, Q, H)           # log decay
    La = torch.cumsum(la, dim=2)                                 # within-chunk

    # Within-chunk (attention-like) term with decay mask
    #   L[i,j] = exp(La_i − La_j) · 1[j ≤ i].
    if s_cfg.use_kernel and G == 1:
        cb = torch.einsum("bcqgn,bckgn->bcqk", Cc, Bc)
        y_intra = kernel_ops.ssd_intra(
            cb.reshape(B_ * nc, Q, Q), La.reshape(B_ * nc, Q, H),
            xc.reshape(B_ * nc, Q, H, Pd)).reshape(B_, nc, Q, H, Pd)
    else:
        y_intra = _y_intra_plain(Cc, Bc, La, xc)

    # Chunk-boundary states: S_local[h,n,p] = Σ_q seg[q,h]·B[q,n]·x[q,h,p],
    # contracted as (seg·x) then a product over q per (b, c, g).
    seg = torch.exp(La[:, :, -1:, :] - La)                       # decay to end
    xs = (xc * seg[..., None]).reshape(B_, nc, Q, G, hpg, Pd)
    S_local = torch.einsum("bcqgn,bcqgjp->bcgjnp", Bc, xs).reshape(
        B_, nc, H, N, Pd)
    chunk_decay = torch.exp(La[:, :, -1, :])                     # (B,nc,H)

    # The sequential inter-chunk scan; S_prev[c] is the state *before*
    # chunk c.
    S_prev = torch.empty_like(S_local)
    state = torch.zeros((B_, H, N, Pd), dtype=torch.float32, device=u.device)
    for c in range(nc):
        S_prev[:, c] = state
        state = state * chunk_decay[:, c, :, None, None] + S_local[:, c]

    # y_inter[q,h,p] = exp(La[q,h]) · Σ_n C[q,n]·S_prev[h,n,p].
    y_inter = torch.einsum("bcqgn,bcgjnp->bcqgjp", Cc,
                           S_prev.reshape(B_, nc, G, hpg, N, Pd)).reshape(
        B_, nc, Q, H, Pd) * torch.exp(La)[..., None]

    y = (y_intra + y_inter).reshape(B_, S, H, Pd)
    y = y + p["D"][None, None, :, None] * x.float()
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = torch.einsum("bshp,hpd->bsd", y.to(u.dtype), p["wo"])
    if H < h_all:
        out = spmd.from_model(out)
    if not return_cache:
        return out
    k = s_cfg.conv_kernel
    x_tail = x_raw[:, S - (k - 1):, :]
    if H < h_all:
        x_tail = spmd.gather_model(x_tail, 2)
    tail = torch.cat([x_tail, bc_raw[:, S - (k - 1):, :]], dim=-1)
    return out, {"state": state, "conv": tail.to(cfg.param_dtype)}


def mamba_decode(p, cfg: ModelConfig, u: torch.Tensor, cache: dict
                 ) -> tuple[torch.Tensor, dict]:
    """Single-token recurrent step.  u: (B, 1, d); cache {state (B,H,N,P)
    f32, conv (B, k−1, C)} → (out (B, 1, d), the new cache)."""
    d_inner, H, Pd, G, N = _dims(cfg)
    h_loc = p["wx"].shape[1]
    x_raw, bc_raw, z, dt = _proj_xbc(p, cfg, u)        # (B,1,·)
    if h_loc < H:
        x_raw = spmd.gather_model(x_raw, 2)
    xbc = torch.cat([x_raw, bc_raw], dim=-1)
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                     dim=1)                            # (B, K, C), whole
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    new_conv = hist[:, 1:, :]

    h0, h1 = spmd.model_block(H) if h_loc < H else (0, H)
    x = conv_out[:, h0 * Pd:h1 * Pd].reshape(-1, 1, h_loc, Pd)
    Bm = conv_out[:, d_inner:d_inner + G * N].reshape(-1, 1, G, N)
    Cm = conv_out[:, d_inner + G * N:].reshape(-1, 1, G, N)
    Bm, Cm, hpg = _heads_groups(cfg, h_loc, Bm, Cm)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]                 # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])                                   # (B,H)
    Bh = Bm[:, 0].repeat_interleave(hpg, dim=-2)       # (B,H,N)
    Ch = Cm[:, 0].repeat_interleave(hpg, dim=-2)
    xd = x[:, 0].float() * dt[..., None]               # (B,H,P)
    state = cache["state"] * a[..., None, None] + \
        torch.einsum("bhn,bhp->bhnp", Bh.float(), xd)
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), state)
    y = y + p["D"][None, :, None] * x[:, 0].float()
    y = _gated_norm(p, y[:, None], z, cfg.norm_eps)
    out = torch.einsum("bshp,hpd->bsd", y.to(u.dtype), p["wo"])
    if h_loc < H:
        out = spmd.from_model(out)
    return out, {"state": state, "conv": new_conv}
