"""Brain-encoding performance metrics (paper §2.2.4, §4.1-4.2).

Port of ``repro/core/scoring.py``.  Random draws come from an explicit
``torch.Generator``; permutations are drawn on the CPU and moved to the
data's device, so a seed gives the same permutations on any device.
"""
from __future__ import annotations

import torch


def pearson_r(Y_true: torch.Tensor, Y_pred: torch.Tensor) -> torch.Tensor:
    """Per-target Pearson r between time series.  (n, t) → (t,)."""
    yt = Y_true - Y_true.mean(0, keepdim=True)
    yp = Y_pred - Y_pred.mean(0, keepdim=True)
    num = (yt * yp).sum(0)
    den = torch.sqrt((yt ** 2).sum(0) * (yp ** 2).sum(0))
    return num / torch.clamp(den, min=1e-12)


def r2_score(Y_true: torch.Tensor, Y_pred: torch.Tensor) -> torch.Tensor:
    """Per-target coefficient of determination.  (n, t) → (t,)."""
    ss_res = ((Y_true - Y_pred) ** 2).sum(0)
    mu = Y_true.mean(0, keepdim=True)
    ss_tot = ((Y_true - mu) ** 2).sum(0)
    return 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)


def null_permutation_scores(generator: torch.Generator, X: torch.Tensor,
                            Y: torch.Tensor, W: torch.Tensor,
                            n_perms: int = 10) -> torch.Tensor:
    """Null distribution of encoding scores with shuffled feature rows.

    The paper's §4.2 control: a random permutation of the feature rows
    destroys the stimulus–response correspondence.  Returns (n_perms, t)
    Pearson r under the null.
    """
    out = []
    for _ in range(n_perms):
        perm = torch.randperm(X.shape[0], generator=generator).to(X.device)
        out.append(pearson_r(Y, torch.matmul(X[perm].float(), W)))
    return torch.stack(out)


def train_test_split_indices(generator: torch.Generator, n: int,
                             test_frac: float = 0.1
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper's 90/10 random split (§2.2.4), as CPU index tensors."""
    perm = torch.randperm(n, generator=generator)
    n_test = max(1, int(round(n * test_frac)))
    return perm[n_test:], perm[:n_test]
