"""eigh-mutualised multi-target RidgeCV (paper §2.3.1, §3).

Port of ``repro/core/ridge.py``: the primal path (``n >= p``) factorises the
downdated Gram of every split and the full-data Gram with
``torch.linalg.eigh``; the dual path (``n < p``) factorises blocks of one
``K = XXᵀ``.  The λ sweep stays a diagonal rescale in the eigenbasis, and
the r² CV score uses the trace identity so no per-λ prediction is
materialised.  ``ridge_cv_from_stats`` runs the primal CV on streamed fold
statistics alone, scoring each split from its sufficient statistics.
``ridge_cv_reference`` is the seed per-fold path (the paper's Algorithm 1
as written: every split re-accumulates its Gram and refactorises), kept as
the yardstick of the downdate.  With ``use_pallas`` the cross-Gram products
and the seed path's λ sweep go through the CUDA kernels (``kernels.ops``),
without it through their plain versions (``kernels.ref``); the remaining
large products are plain ``torch.matmul`` in f32, as the reference leaves
them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import torch

from repro_torch import obs
from repro_torch.core import foldstats
from repro_torch.device import sync_if_traced
from repro_torch.kernels import ops, ref

# The paper's λ grid (§2.2.4).
PAPER_LAMBDA_GRID: tuple[float, ...] = (
    0.1, 1.0, 100.0, 200.0, 300.0, 400.0, 600.0, 800.0, 900.0, 1000.0, 1200.0
)


@dataclasses.dataclass(frozen=True)
class RidgeCVConfig:
    """Configuration of the multi-target cross-validated ridge solve."""

    lambdas: tuple[float, ...] = PAPER_LAMBDA_GRID
    n_folds: int = 5
    method: Literal["auto", "eigh", "dual"] = "auto"
    # Diagonal jitter added before eigh for f32 stability.
    jitter: float = 1e-6
    # λ selection score: "r" (Pearson, the paper's metric) or "r2".
    scoring: Literal["r", "r2"] = "r2"
    # Route the cross-Gram products (fold statistics, dual kernel, Xᵀα)
    # through the CUDA kernels; needs the data on a CUDA device.
    use_pallas: bool = False

    def resolve_method(self, n: int, p: int) -> str:
        if self.method != "auto":
            return self.method
        return "eigh" if n >= p else "dual"


@dataclasses.dataclass
class RidgeFactors:
    """Reusable factorisation: ``basis`` is ``Q`` (p×p, primal) or ``P``
    (n×n, dual); ``evals`` are the eigenvalues of the Gram/kernel matrix."""

    basis: torch.Tensor     # (p,p) primal | (n,n) dual
    evals: torch.Tensor     # (p,) | (n,)
    primal: bool


@dataclasses.dataclass
class RidgeCVResult:
    weights: torch.Tensor       # (p, t)
    best_lambda: torch.Tensor   # scalar
    best_index: torch.Tensor    # scalar int
    cv_scores: torch.Tensor     # (r,) mean validation score per λ


def gram(X: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` with f32 accumulation (plain)."""
    return ref.gram(X)


def gram_xty(X: torch.Tensor, Y: torch.Tensor, *,
             use_pallas: bool = False) -> torch.Tensor:
    """``XᵀY`` with f32 accumulation (kernel-routable)."""
    if use_pallas:
        dt = torch.promote_types(X.dtype, Y.dtype)
        return ops.xty(X.to(dt), Y.to(dt))
    return ref.xty(X, Y)


def xxt(X: torch.Tensor, *, use_pallas: bool = False) -> torch.Tensor:
    """``XXᵀ`` (the dual kernel matrix) with f32 accumulation.

    The kernel route runs the cross-Gram kernel on the transposed view
    ``Xᵀ``, read through its strides (no copy): ``(Xᵀ)ᵀ(Xᵀ) = XXᵀ``.
    """
    Xt = X.T
    if use_pallas:
        return ops.xty(Xt, Xt)
    return ref.xty(Xt, Xt)


def factorize(X: torch.Tensor, cfg: RidgeCVConfig) -> RidgeFactors:
    """Factorise ``X`` once; reused for every λ and every target (Eq. 4-5).

    Primal: ``eigh(XᵀX + jitter·I)``, the Gram through the kernel with
    ``use_pallas``.  Dual: ``eigh(XXᵀ + jitter·I)``.  The jitter is added to
    the fresh Gram's diagonal in place (the same sums as adding
    ``jitter·I``, without a p×p identity and a second p×p matrix).
    """
    n, p = X.shape
    if cfg.resolve_method(n, p) == "eigh":
        G = ops.gram(X) if cfg.use_pallas else gram(X)
        primal = True
    else:
        G = xxt(X, use_pallas=cfg.use_pallas)
        primal = False
    G.diagonal().add_(cfg.jitter)
    evals, B = torch.linalg.eigh(G)
    return RidgeFactors(basis=B, evals=evals, primal=primal)


def solve(factors: RidgeFactors, XtY_or_Y: torch.Tensor, lam: torch.Tensor,
          X: torch.Tensor | None = None,
          use_pallas: bool = False) -> torch.Tensor:
    """Apply ``M(λ)`` through the shared factorisation.

    Primal: ``XᵀY`` (p×t) → ``W = Q (Λ+λ)⁻¹ Qᵀ XᵀY``.  Dual: ``Y`` (n×t) and
    ``X`` → ``W = Xᵀ α`` with ``α = P (Γ+λ)⁻¹ Pᵀ Y`` (``Xᵀα`` is
    kernel-routable).
    """
    B = factors.basis
    z = torch.matmul(B.T, XtY_or_Y.float())
    z = z / (factors.evals + lam)[:, None]
    out = torch.matmul(B, z)
    if factors.primal:
        return out
    if X is None:
        raise ValueError("dual solve needs X to map dual coeffs to weights")
    return gram_xty(X, out, use_pallas=use_pallas)


def solve_lambda_grid(factors: RidgeFactors, XtY_or_Y: torch.Tensor,
                      lambdas: Sequence[float] | torch.Tensor,
                      X: torch.Tensor | None = None,
                      use_pallas: bool = False) -> torch.Tensor:
    """All-λ solve, stacked on a leading axis: (r, p, t).

    The rotation into the eigenbasis (``BᵀXᵀY`` or ``BᵀY``) is shared across
    the grid — the mutualisation of paper Eq. 5, where only the diagonal
    ``(S²+λI)⁻¹`` depends on λ.  Primal with ``use_pallas``: ``A = QᵀXᵀY``
    as a plain product, then the fused rescale-and-product kernel
    (``ops.solve_lambda_grid``).  Dual with ``use_pallas``: one ``Xᵀα_r``
    kernel product per λ.
    """
    B = factors.basis
    lams = torch.as_tensor(lambdas, dtype=torch.float32, device=B.device)
    z = torch.matmul(B.T, XtY_or_Y.float())
    if use_pallas and factors.primal:
        return ops.solve_lambda_grid(B, factors.evals, z, lams)
    zs = z[None, :, :] / (factors.evals[None, :, None] + lams[:, None, None])
    out = torch.einsum("ij,rjt->rit", B, zs)
    if factors.primal:
        return out
    if X is None:
        raise ValueError("dual solve needs X to map dual coeffs to weights")
    if use_pallas:
        return torch.stack([gram_xty(X, out[r], use_pallas=True)
                            for r in range(out.shape[0])])
    return torch.einsum("ni,rnt->rit", X.float(), out)


def _score(Y_true: torch.Tensor, Y_pred: torch.Tensor, kind: str
           ) -> torch.Tensor:
    """Mean score across targets (higher is better); batched over any
    leading axes of ``Y_pred`` (..., v, t)."""
    if kind == "r2":
        ss_res = ((Y_true - Y_pred) ** 2).sum(-2)
        ss_tot = ((Y_true - Y_true.mean(0)) ** 2).sum(0) + 1e-12
        return (1.0 - ss_res / ss_tot).mean(-1)
    yt = Y_true - Y_true.mean(0)
    yp = Y_pred - Y_pred.mean(-2, keepdim=True)
    num = (yt * yp).sum(-2)
    den = torch.sqrt((yt ** 2).sum(0) * (yp ** 2).sum(-2)) + 1e-12
    return (num / den).mean(-1)


def _lambda_grid(cfg: RidgeCVConfig, device: torch.device) -> torch.Tensor:
    # f32 regardless of X.dtype: bf16 inputs sweep — and select — the same
    # grid as f32 ones.
    return torch.tensor(cfg.lambdas, dtype=torch.float32, device=device)


def _r2_scores_trace(Bv: torch.Tensor, A: torch.Tensor, Y_val: torch.Tensor,
                     evals: torch.Tensor, lams: torch.Tensor) -> torch.Tensor:
    """Mean-over-targets R² per λ without materialising predictions.

    With ``P(λ) = Bv · diag(1/(Λ+λ)) · A`` the CV score expands into
    λ-independent contractions plus a per-λ quadratic form in the diagonal
    ``D = 1/(Λ+λ)``:

        Σ_j ss_res_j/ss_tot_j = t₀ − 2·Dᵀε + Dᵀ(G_c ∘ S)D + v·Σ_j(P̄_j−ȳ_j)²/ss_tot_j

    over centred quantities only (see the reference's docstring for the
    derivation and the f32 stability argument).
    """
    v, t = Y_val.shape
    Y32 = Y_val.float()
    mu = Y32.mean(0)
    Yc = Y32 - mu
    inv = 1.0 / ((Yc ** 2).sum(0) + 1e-12)                          # 1/ss_tot
    t0 = ((Yc ** 2).sum(0) * inv).sum()
    ub = Bv.mean(0)                                                 # (p,)
    Bc = Bv - ub                                                    # centred
    Mc = torch.matmul(Bc.T, Yc) * inv[None]
    eps = (A * Mc).sum(1)                                           # (p,)
    S = torch.matmul(A * inv[None], A.T)
    Gc = torch.matmul(Bc.T, Bc)
    F = Gc * S
    D = 1.0 / (evals[None, :] + lams[:, None])                      # (r, p)
    cross = D @ eps
    quad = ((D @ F) * D).sum(1)
    # Fold-mean predictions per λ: P̄(λ) = ubᵀ·diag(D)·A (r, t).
    pbar = torch.matmul(D * ub[None], A)
    mean_term = v * (((pbar - mu[None]) ** 2) * inv[None]).sum(1)
    return 1.0 - (t0 - 2.0 * cross + quad + mean_term) / t


def _fold_scores(Bv: torch.Tensor, A: torch.Tensor, Y_val: torch.Tensor,
                 evals: torch.Tensor, lams: torch.Tensor,
                 scoring: str) -> torch.Tensor:
    """Per-λ validation scores of one split, from eigenbasis factors:
    ``"r2"`` by the trace identity, ``"r"`` on the materialised (r, v, t)
    predictions."""
    if scoring == "r2":
        return _r2_scores_trace(Bv, A, Y_val, evals, lams)
    Bs = Bv[None] / (evals[None, None, :] + lams[:, None, None])    # (r, v, p)
    preds = torch.matmul(Bs, A[None])
    return _score(Y_val.float(), preds, scoring)


def _ridge_cv_primal(X: torch.Tensor, Y: torch.Tensor,
                     cfg: RidgeCVConfig) -> RidgeCVResult:
    """Primal CV on downdated fold statistics — one Gram pass total, one
    ``eigh`` per split and one for the refit on ``G_total``/``C_total``.

    Its leaf spans (``fit.primal.stats``, ``.eigh``, ``.score``,
    ``.solve``) force their work while a tracer is installed
    (``sync_if_traced``), so each records compute, not the enqueue."""
    n, p = X.shape
    device = X.device
    bounds = foldstats.fold_bounds(n, cfg.n_folds)
    with obs.span("fit.primal.stats", n=n, p=p):
        stats = foldstats.compute(X, Y, cfg.n_folds,
                                  use_pallas=cfg.use_pallas)
        sync_if_traced(device)
    eye = cfg.jitter * torch.eye(p, dtype=torch.float32, device=device)
    lams = _lambda_grid(cfg, device)
    per_lambda_scores = []
    for f, (lo, hi) in enumerate(bounds):
        with obs.span("fit.primal.eigh", fold=f, p=p):
            G_tr, C_tr = stats.train(f)               # Gram downdate (exact)
            evals, Q = torch.linalg.eigh(G_tr + eye)  # per-split eigh
            del G_tr
            sync_if_traced(device)
        with obs.span("fit.primal.score", fold=f, p=p):
            A = torch.matmul(Q.T, C_tr)
            Bv = torch.matmul(X[lo:hi].float(), Q)
            del Q
            per_lambda_scores.append(
                _fold_scores(Bv, A, Y[lo:hi], evals, lams, cfg.scoring))
            sync_if_traced(device)
    cv_scores = torch.stack(per_lambda_scores).mean(0)              # (r,)
    best = torch.argmax(cv_scores)
    # Refit on the full data: the summed fold statistics ARE the full-data
    # Gram/cross-covariance — no second pass over the rows.
    with obs.span("fit.primal.eigh", fold="refit", p=p):
        evals, Q = torch.linalg.eigh(stats.G_total + eye)
        sync_if_traced(device)
    with obs.span("fit.primal.solve", p=p):
        factors = RidgeFactors(basis=Q, evals=evals, primal=True)
        W = solve(factors, stats.C_total, lams[best])
        sync_if_traced(device)
    return RidgeCVResult(weights=W, best_lambda=lams[best], best_index=best,
                         cv_scores=cv_scores)


def _ridge_cv_dual(X: torch.Tensor, Y: torch.Tensor,
                   cfg: RidgeCVConfig) -> RidgeCVResult:
    """Dual CV on per-fold blocks ``K[tr, tr]`` of one ``K = XXᵀ``."""
    n, p = X.shape
    bounds = foldstats.fold_bounds(n, cfg.n_folds)
    K = xxt(X, use_pallas=cfg.use_pallas)             # one n×n accumulation
    lams = _lambda_grid(cfg, X.device)
    Yf = Y.float()
    per_lambda_scores = []
    for lo, hi in bounds:
        tr = torch.cat([torch.arange(lo), torch.arange(hi, n)]).to(X.device)
        K_tr = K[tr][:, tr]
        evals, P_ = torch.linalg.eigh(
            K_tr + cfg.jitter * torch.eye(tr.numel(), dtype=torch.float32,
                                          device=X.device))
        z = torch.matmul(P_.T, Yf[tr])
        Bv = torch.matmul(K[lo:hi][:, tr], P_)
        per_lambda_scores.append(
            _fold_scores(Bv, z, Y[lo:hi], evals, lams, cfg.scoring))
    cv_scores = torch.stack(per_lambda_scores).mean(0)              # (r,)
    best = torch.argmax(cv_scores)
    evals, P_ = torch.linalg.eigh(
        K + cfg.jitter * torch.eye(n, dtype=torch.float32, device=X.device))
    factors = RidgeFactors(basis=P_, evals=evals, primal=False)
    W = solve(factors, Y, lams[best], X=X, use_pallas=cfg.use_pallas)
    return RidgeCVResult(weights=W, best_lambda=lams[best], best_index=best,
                         cv_scores=cv_scores)


def _check_kernel_tier(X: torch.Tensor, cfg: RidgeCVConfig) -> None:
    if cfg.use_pallas and X.device.type != "cuda":
        raise ValueError(f"use_pallas=True needs CUDA tensors, got "
                         f"{X.device}")


def ridge_cv(X: torch.Tensor, Y: torch.Tensor,
             cfg: RidgeCVConfig = RidgeCVConfig()) -> RidgeCVResult:
    """Cross-validated multi-target ridge — scikit-learn ``RidgeCV`` analog.

    Every CV split gets its own factorisation of the training statistics,
    the λ grid is swept diagonally, scores are averaged over splits, one λ
    is selected for all targets (§2.2.4) and the weights are refit on the
    full data.
    """
    n, p = X.shape
    _check_kernel_tier(X, cfg)
    if cfg.resolve_method(n, p) == "eigh":
        return _ridge_cv_primal(X, Y, cfg)
    return _ridge_cv_dual(X, Y, cfg)


def ridge_cv_from_stats(stats: foldstats.FoldStats,
                        cfg: RidgeCVConfig = RidgeCVConfig()
                        ) -> RidgeCVResult:
    """Fit the CV'd ridge from pre-accumulated fold statistics alone.

    The out-of-core entry point: ``stats`` may come from
    ``foldstats.compute_chunked`` over row batches that never coexist in
    device memory.  Validation scores come from sufficient statistics
    (``foldstats.validation_scores_from_stats``), so no validation rows are
    needed — primal/eigh only, since the dual kernel is an n×n object that
    defeats the point of streaming rows.  λ selection and refit are
    ``_ridge_cv_primal``'s.
    """
    if cfg.method == "dual":
        raise ValueError("ridge_cv_from_stats is primal-only: the dual "
                         "kernel XXᵀ cannot be built from streamed row "
                         "statistics")
    p = stats.G.shape[1]
    device = stats.G.device
    per_lambda_scores = []
    # The eigh/solve spans force their outputs only while a tracer is
    # installed (``sync_if_traced``), so the recorded durations are
    # compute, not the enqueue; untraced, nothing is synchronised here.
    with obs.span("fit.eigh", folds=stats.n_folds, p=p):
        eye = cfg.jitter * torch.eye(p, dtype=torch.float32, device=device)
        lams = _lambda_grid(cfg, device)
        for f in range(stats.n_folds):
            G_tr, C_tr = stats.train(f)
            evals, Q = torch.linalg.eigh(G_tr + eye)
            del G_tr
            per_lambda_scores.append(foldstats.validation_scores_from_stats(
                stats, f, Q, evals, C_tr, lams, cfg.scoring))
            del Q
        cv_scores = torch.stack(per_lambda_scores).mean(0)          # (r,)
        best = torch.argmax(cv_scores)
        sync_if_traced(device)
    with obs.span("fit.solve", p=p):
        evals, Q = torch.linalg.eigh(stats.G_total + eye)
        factors = RidgeFactors(basis=Q, evals=evals, primal=True)
        W = solve(factors, stats.C_total, lams[best])
        sync_if_traced(device)
    return RidgeCVResult(weights=W, best_lambda=lams[best], best_index=best,
                         cv_scores=cv_scores)


def ridge_cv_reference(X: torch.Tensor, Y: torch.Tensor,
                       cfg: RidgeCVConfig = RidgeCVConfig()) -> RidgeCVResult:
    """Seed implementation: per-fold re-accumulation (baseline, kept on
    purpose).

    For every split this concatenates the training rows and recomputes their
    Gram/kernel from scratch — ``(k−1)·np²`` of redundant work that
    ``ridge_cv`` derives by downdating — then sweeps the λ grid with
    ``solve_lambda_grid`` and scores the materialised (r, v, t) predictions.
    With ``use_pallas`` three things go through kernels, as in the
    reference: the Gram inside ``factorize`` (or the dual ``XXᵀ``), and the
    λ sweep (or the dual ``Xᵀα`` per λ); the training cross-product
    ``XᵀY`` and the refit's solve stay plain.
    """
    _check_kernel_tier(X, cfg)
    bounds = foldstats.fold_bounds(X.shape[0], cfg.n_folds)
    per_lambda_scores = []
    for lo, hi in bounds:
        X_val, Y_val = X[lo:hi], Y[lo:hi]
        X_tr = torch.cat([X[:lo], X[hi:]])
        Y_tr = torch.cat([Y[:lo], Y[hi:]])
        factors = factorize(X_tr, cfg)
        rhs = gram_xty(X_tr, Y_tr) if factors.primal else Y_tr
        Ws = solve_lambda_grid(factors, rhs, cfg.lambdas,
                               X=None if factors.primal else X_tr,
                               use_pallas=cfg.use_pallas)
        del factors, X_tr, Y_tr
        preds = torch.einsum("np,rpt->rnt", X_val.float(), Ws)
        del Ws
        per_lambda_scores.append(_score(Y_val, preds, cfg.scoring))
        del preds
    cv_scores = torch.stack(per_lambda_scores).mean(0)              # (r,)
    best = torch.argmax(cv_scores)
    lams = _lambda_grid(cfg, X.device)
    # Refit on the full data with the selected λ.
    factors = factorize(X, cfg)
    rhs = gram_xty(X, Y) if factors.primal else Y
    W = solve(factors, rhs, lams[best], X=None if factors.primal else X)
    return RidgeCVResult(weights=W, best_lambda=lams[best], best_index=best,
                         cv_scores=cv_scores)


def predict(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return torch.matmul(X.float(), W.float())
