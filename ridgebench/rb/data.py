"""Inputs of a cell, drawn from ``--seed`` on the device.

Features are built the way the paper builds them (arXiv:2403.19421
§2.1.3): a feature series of ``width`` columns per TR (VGG16-FC2: 4,096)
and ``lags`` TR lags of it side by side, so ``p = lags · width``.  The
series has a decaying spectrum: independent columns scaled so their
variances fall as ``(j + 1) ** -spectrum_exponent``, mixed by a random
rotation, and smoothed in time by a causal exponential filter
(``smoothing`` per TR, ``taps`` TRs long), so the lags are correlated as
consecutive frames of a film are.  The features are z-scored per column.
The law of this series is assumed (the configuration lists it under
``assumed``); the spectrum matters because the time of a
divide-and-conquer ``eigh`` depends on it.

The targets follow the program's synthetic subject (``data/fmri.py``,
copied here so that a change to the program does not change the inputs):
a planted linear map into the first ``frac_responsive`` of the targets,
unit Gaussian noise, a slow drift, and per-target z-scoring.

The stimulus is the same film for every subject (CNeuroMod's subjects
watched the same episodes), so the features are drawn from the
configuration's own ``stimulus_seed`` and ``--seed`` draws the subject:
the targets' planted map, noise and drift.  That also keeps a fit's work
the same from seed to seed: the time of ``eigh`` depends on the Gram's
spectrum, and the Grams depend on the features alone.  Each is drawn by
a ``torch.Generator`` on ``device`` in a few large calls, in float32.
The same seed gives the same arrays.
"""
from __future__ import annotations

import math

import torch


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def features(cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    f = cfg["features"]
    n, width, lags, taps = cfg["n"], f["width"], f["lags"], f["taps"]
    if lags * width != cfg["p"]:
        raise ValueError(f"lags × width = {lags * width} != p = {cfg['p']}")
    f32 = dict(dtype=torch.float32, device=device)
    rows = n + lags - 1
    z = torch.randn(rows + taps - 1, width, generator=g, **f32)
    scale = torch.arange(1, width + 1, **f32) ** (-f["spectrum_exponent"] / 2)
    rot, _ = torch.linalg.qr(torch.randn(width, width, generator=g, **f32))
    z = (z * scale) @ rot
    # Causal exponential filter: s_i = Σ_k ρ^k z_{i+taps-1-k}.
    rho = f["smoothing"]
    s = torch.zeros(rows, width, **f32)
    for k in range(taps):
        s += rho ** k * z[taps - 1 - k:taps - 1 - k + rows]
    del z
    # Lag l of row i is the series at TR i + lags - 1 - l.
    X = torch.cat([s[lags - 1 - l:lags - 1 - l + n] for l in range(lags)],
                  dim=1)
    del s
    X -= X.mean(0)
    X /= X.std(0, correction=0) + 1e-6
    return X


def targets(cfg: dict, X: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    tg = cfg["targets"]
    n, p = X.shape
    t = cfg["t"]
    f32 = dict(dtype=torch.float32, device=X.device)
    n_resp = int(t * tg["frac_responsive"])
    W = torch.randn(p, n_resp, generator=g, **f32) / math.sqrt(p)
    Y = torch.randn(n, t, generator=g, **f32)
    Y[:, :n_resp] += (X @ W) * tg["snr_responsive"]
    del W
    tt = torch.arange(n, **f32)[:, None] * tg["tr_seconds"]
    phase = torch.rand(1, t, generator=g, **f32) * 2 * math.pi
    Y += tg["drift_amp"] * torch.sin(2 * math.pi * 0.003 * tt + phase)
    Y -= Y.mean(0)
    Y /= Y.std(0, correction=0) + 1e-6
    return Y


def make(cfg: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(X (n, p), Y (n, t))`` float32 on ``device``: the configuration's
    stimulus and the subject ``seed``."""
    device = torch.device(device)
    g = torch.Generator(device.type)
    X = features(cfg, g.manual_seed(cfg["features"]["stimulus_seed"]),
                 device)
    Y = targets(cfg, X, g.manual_seed(_seed(seed)))
    return X, Y
