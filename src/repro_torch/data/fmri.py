"""CNeuroMod-shaped synthetic fMRI data generator (paper §2.1).

Port of ``repro/data/fmri.py``: the same statistical model — a planted
linear map from stimulus features X to a responsive fraction of the
targets, target noise, slow drift, per-target normalisation — drawn from a
``torch.Generator`` on the generator's device.  The draws differ from the
reference's ``jax.random`` draws for the same seed.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SubjectSpec:
    """Mirror of paper Table 1 rows (defaults: truncated whole-brain)."""
    subject: str = "sub-01"
    n: int = 2_000      # time samples
    p: int = 256        # stimulus features
    t: int = 1_024      # brain targets
    frac_responsive: float = 0.25   # fraction of 'visual cortex' targets
    snr_responsive: float = 2.0
    drift_amp: float = 0.3
    tr_seconds: float = 1.49        # paper's fMRI TR


def generate(spec: SubjectSpec, generator: torch.Generator,
             device: torch.device | str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (X (n,p) features, Y (n,t) BOLD targets, responsive mask (t,)).

    ``generator`` must live on ``device`` (CUDA unless ``device="cpu"``).
    """
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot draw on "
                         f"{device}; make it with torch.Generator({device.type!r})")
    f32 = dict(dtype=torch.float32, device=device, generator=generator)
    X = torch.randn(spec.n, spec.p, **f32)

    n_resp = int(spec.t * spec.frac_responsive)
    mask = torch.arange(spec.t, device=device) < n_resp
    W = torch.randn(spec.p, spec.t, **f32) / math.sqrt(spec.p)
    W = W * mask.float()[None, :]

    signal = (X @ W) * spec.snr_responsive
    del W
    Y = torch.randn(spec.n, spec.t, **f32)
    Y += signal
    del signal
    # Slow drift (< 0.01 Hz), the confound the paper regresses out.
    tt = torch.arange(spec.n, device=device)[:, None] * spec.tr_seconds
    phase = torch.rand(1, spec.t, **f32) * 2 * math.pi
    Y += spec.drift_amp * torch.sin(2 * math.pi * 0.003 * tt + phase)
    # Per-target normalisation to zero mean / unit variance over time.
    Y = (Y - Y.mean(0, keepdim=True)) / (Y.std(0, correction=0, keepdim=True)
                                         + 1e-6)
    return X, Y, mask


def detrend(Y: torch.Tensor, tr_seconds: float = 1.49,
            cutoff_hz: float = 0.01, n_basis: int | None = None
            ) -> torch.Tensor:
    """Regress out a discrete-cosine basis of slow drifts (paper §2.1.4)."""
    n = Y.shape[0]
    if n_basis is None:
        n_basis = max(1, int(2 * n * tr_seconds * cutoff_hz))
    t = torch.arange(n, dtype=torch.float32, device=Y.device)
    k = torch.arange(1, n_basis + 1, dtype=torch.float32, device=Y.device)
    basis = torch.cos(math.pi * (t[:, None] + 0.5) * k[None, :] / n)  # (n, k)
    basis = basis / torch.linalg.norm(basis, dim=0, keepdim=True)
    coef = basis.T @ Y
    return Y - basis @ coef
