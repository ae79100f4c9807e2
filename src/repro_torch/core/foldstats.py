"""Single-pass fold-aware Gram statistics (CV by downdating, not recompute).

Port of ``repro/core/foldstats.py`` for the in-memory path.  Every per-fold
partial

    G_f = X_fᵀX_f        C_f = X_fᵀY_f        (plus first/second moments)

comes from one pass over the rows, and every training split derives by the
exact downdate ``G_train(f) = Σ_g G_g − G_f``; the full-data refit
statistics are the sums themselves.  With the kernel tier on, ``[G | C]``
for all folds is one launch of the CUDA ``xty_folds`` kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops, ref


def fold_bounds(n: int, n_folds: int) -> list[tuple[int, int]]:
    """Contiguous k-fold boundaries.

    The first ``n % n_folds`` folds get the extra row, matching
    scikit-learn's ``KFold``.
    """
    if not 1 <= n_folds <= n:
        raise ValueError(f"need 1 <= n_folds <= n, got n_folds={n_folds}, "
                         f"n={n}")
    sizes = [n // n_folds + (1 if i < n % n_folds else 0)
             for i in range(n_folds)]
    bounds, start = [], 0
    for s in sizes:
        bounds.append((start, start + s))
        start += s
    return bounds


@dataclasses.dataclass
class FoldStats:
    """Per-fold sufficient statistics of a supervised row stream, all f32."""

    G: torch.Tensor        # (k, p, p)  per-fold XᵀX
    C: torch.Tensor        # (k, p, t)  per-fold XᵀY
    xsum: torch.Tensor     # (k, p)     per-fold Σ x
    ysum: torch.Tensor     # (k, t)     per-fold Σ y
    # Per-fold CENTRED second moment Σ (y − ȳ_f)², not the raw Σ y², which
    # cancels catastrophically in f32 for targets with large means.
    ysq: torch.Tensor      # (k, t)     per-fold Σ (y − ȳ_f)²
    count: torch.Tensor    # (k,)       per-fold row count

    @property
    def n_folds(self) -> int:
        return self.G.shape[0]

    @property
    def G_total(self) -> torch.Tensor:
        """Full-data Gram — the sums over folds ARE the refit statistics."""
        return self.G.sum(0)

    @property
    def C_total(self) -> torch.Tensor:
        return self.C.sum(0)

    def train(self, f: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Downdated training statistics ``(G_tr, C_tr)`` for split ``f``:
        ``G_total − G_f`` equals ``X_trᵀX_tr`` in exact arithmetic."""
        return self.G_total - self.G[f], self.C_total - self.C[f]


def compute(X: torch.Tensor, Y: torch.Tensor, n_folds: int, *,
            use_pallas: bool = False) -> FoldStats:
    """All per-fold statistics in one pass over the rows.

    With ``use_pallas`` (the kernel tier) the fold tiles come from one
    ``kernels.ops.xty_folds`` call on ``Xᵀ[X | Y]``: a single sweep of the
    rows for ``G`` and ``C`` together; without it the same products come
    from the plain ``kernels.ref.xty_folds``.
    """
    n, p = X.shape
    bounds = fold_bounds(n, n_folds)
    if use_pallas:
        dt = torch.promote_types(X.dtype, Y.dtype)
        Xd = X.to(dt).contiguous()
        Z = torch.cat([Xd, Y.to(dt)], dim=1)
        GC = ops.xty_folds(Xd, Z, bounds)
        del Z
        G, C = GC[:, :, :p], GC[:, :, p:]
    else:
        G = ref.xty_folds(X, X, bounds)
        C = ref.xty_folds(X, Y, bounds)
    Xf = X.float()
    Yf = Y.float()
    xsum = torch.stack([Xf[lo:hi].sum(0) for lo, hi in bounds])
    ysum = torch.stack([Yf[lo:hi].sum(0) for lo, hi in bounds])
    ysq = torch.stack([
        ((Yf[lo:hi] - Yf[lo:hi].mean(0)) ** 2).sum(0) for lo, hi in bounds])
    count = torch.tensor([hi - lo for lo, hi in bounds], dtype=torch.float32,
                         device=X.device)
    return FoldStats(G=G, C=C, xsum=xsum, ysum=ysum, ysq=ysq, count=count)
