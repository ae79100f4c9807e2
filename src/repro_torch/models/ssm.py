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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
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
    """Project input to x/B/C channels (pre-conv) and z/dt."""
    d_inner, H, Pd, G, N = _dims(cfg)
    b, s = u.shape[:2]
    x = torch.einsum("bsd,dhp->bshp", u, p["wx"]).reshape(b, s, H * Pd)
    Bm = torch.einsum("bsd,dgn->bsgn", u, p["wB"]).reshape(b, s, G * N)
    Cm = torch.einsum("bsd,dgn->bsgn", u, p["wC"]).reshape(b, s, G * N)
    xbc = torch.cat([x, Bm, Cm], dim=-1)              # (B, S, conv_ch)
    z = torch.einsum("bsd,dhp->bshp", u, p["wz"])     # (B, S, H, P)
    dt = torch.einsum("bsd,dh->bsh", u, p["wdt"])     # (B, S, H)
    return xbc, z, dt


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d_inner, H, Pd, G, N = _dims(cfg)
    b, s, _ = xbc.shape
    x = xbc[..., :d_inner].reshape(b, s, H, Pd)
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(b, s, G, N)
    Cm = xbc[..., d_inner + G * N:].reshape(b, s, G, N)
    return x, Bm, Cm


def _causal_conv(p, xbc: torch.Tensor, kernel: int) -> torch.Tensor:
    """Depthwise causal conv over time.  xbc: (B, S, C)."""
    pad = F.pad(xbc, (0, 0, kernel - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * p["conv_w"][i][None, None, :]
              for i in range(kernel))
    return F.silu(out + p["conv_b"][None, None, :])


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
    hpg = H // G

    xbc_raw, z, dt = _proj_xbc(p, cfg, u)
    xbc = _causal_conv(p, xbc_raw, s_cfg.conv_kernel)
    x, Bm, Cm = _split_xbc(cfg, xbc)
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
    if not return_cache:
        return out
    k = s_cfg.conv_kernel
    return out, {"state": state,
                 "conv": xbc_raw[:, S - (k - 1):, :].to(cfg.param_dtype)}


def mamba_decode(p, cfg: ModelConfig, u: torch.Tensor, cache: dict
                 ) -> tuple[torch.Tensor, dict]:
    """Single-token recurrent step.  u: (B, 1, d); cache {state (B,H,N,P)
    f32, conv (B, k−1, C)} → (out (B, 1, d), the new cache)."""
    d_inner, H, Pd, G, N = _dims(cfg)
    xbc, z, dt = _proj_xbc(p, cfg, u)                  # (B,1,·)
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)],
                     dim=1)                            # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]
    new_conv = hist[:, 1:, :]

    x, Bm, Cm = _split_xbc(cfg, conv_out)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]                 # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])                                   # (B,H)
    hpg = H // G
    Bh = Bm[:, 0].repeat_interleave(hpg, dim=-2)       # (B,H,N)
    Ch = Cm[:, 0].repeat_interleave(hpg, dim=-2)
    xd = x[:, 0].float() * dt[..., None]               # (B,H,P)
    state = cache["state"] * a[..., None, None] + \
        torch.einsum("bhn,bhp->bhnp", Bh.float(), xd)
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), state)
    y = y + p["D"][None, :, None] * x[:, 0].float()
    y = _gated_norm(p, y[:, None], z, cfg.norm_eps)
    out = torch.einsum("bshp,hpd->bsd", y.to(u.dtype), p["wo"])
    return out, {"state": state, "conv": new_conv}
