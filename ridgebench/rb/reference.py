"""The plain reference of a cross-validated multi-target ridge fit.

Plain PyTorch on the rows themselves, in float32 with TF32 off: nothing
of the program is imported, and nothing the program derived (fold
statistics, downdates, eigenbases, scores) is reused.  For each of the
``k`` contiguous folds (the first ``n % k`` one row longer, as
scikit-learn's ``KFold``) it forms the training Gram and cross-product
from the training rows, factorises ``G + jitter·I`` with ``eigh``,
predicts the held-out rows at every λ of the grid and scores them (R²
against the held-out mean, or Pearson r) per target; the CV curve is the
mean over targets and folds.  λ is the curve's argmax, and the weights
are refit on all rows at that λ.

``tf32=True`` is the control: the same arithmetic with the matrix
products in TF32, the precision below the float32 that the
configurations state.  On a card that is torch's TF32 switch; on the CPU,
where there is none, each product's operands are rounded to TF32's
10-bit mantissa first.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class Fit:
    cv: torch.Tensor        # (r,) float64 on the host: mean score per λ
    best: int               # index of λ
    weights: torch.Tensor   # (p, t) float32 at lambdas[best]
    # (r,) the largest condition number of G + (jitter + λ)·I over the
    # folds' training Grams and the full one.
    kappa: torch.Tensor


def fold_bounds(n: int, k: int) -> list[tuple[int, int]]:
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    out, lo = [], 0
    for s in sizes:
        out.append((lo, lo + s))
        lo += s
    return out


def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 explicit mantissa bits (to nearest)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Products:
    def __init__(self, tf32: bool, device: torch.device):
        self.emulate = tf32 and device.type != "cuda"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.emulate:
            a, b = _round_tf32(a), _round_tf32(b)
        return a @ b


@contextlib.contextmanager
def _precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _scores(Y_val: torch.Tensor, pred: torch.Tensor, scoring: str
            ) -> torch.Tensor:
    """Per-target score of one λ's held-out predictions, float64."""
    y = Y_val.double()
    yh = pred.double()
    yc = y - y.mean(0)
    if scoring == "r2":
        ss_res = ((y - yh) ** 2).sum(0)
        return 1.0 - ss_res / ((yc ** 2).sum(0) + 1e-12)
    hc = yh - yh.mean(0)
    return (yc * hc).sum(0) / (((yc ** 2).sum(0) * (hc ** 2).sum(0)).sqrt()
                               + 1e-12)


def ridge_cv(X: torch.Tensor, Y: torch.Tensor, lambdas, *, n_folds: int,
             jitter: float, scoring: str, tf32: bool = False,
             target_block: int = 16_384) -> Fit:
    """The reference fit of ``Y`` on ``X`` (float32, on their device).

    Targets are scored ``target_block`` at a time, so the held-out
    predictions of one block and one λ are the largest temporary besides
    the ``p × p`` factors.
    """
    n, p = X.shape
    t = Y.shape[1]
    dev = X.device
    P = _Products(tf32, dev)
    lams = torch.tensor(lambdas, dtype=torch.float32, device=dev)
    eye = jitter * torch.eye(p, dtype=torch.float32, device=dev)
    total = torch.zeros(len(lambdas), dtype=torch.float64, device=dev)
    kappa = torch.zeros(len(lambdas), dtype=torch.float64)

    def condition(evals: torch.Tensor) -> None:
        lo = max(float(evals[0]), 0.0)
        hi = float(evals[-1])
        for r, lam in enumerate(lambdas):
            kappa[r] = max(float(kappa[r]), (hi + lam) / (lo + lam))
    with _precision(tf32):
        for lo, hi in fold_bounds(n, n_folds):
            Xa, Xb = X[:lo], X[hi:]
            G = P.mm(Xa.T, Xa) + P.mm(Xb.T, Xb) + eye
            evals, Q = torch.linalg.eigh(G)
            del G
            condition(evals)
            B = P.mm(X[lo:hi], Q)                       # held-out rows in Q
            for c0 in range(0, t, target_block):
                c1 = min(c0 + target_block, t)
                C = (P.mm(Xa.T, Y[:lo, c0:c1])
                     + P.mm(Xb.T, Y[hi:, c0:c1]))
                A = P.mm(Q.T, C)
                del C
                for r in range(len(lambdas)):
                    pred = P.mm(B / (evals + lams[r]), A)
                    total[r] += _scores(Y[lo:hi, c0:c1], pred, scoring).sum()
                del A
            del Q, B
        cv = (total / (n_folds * t)).cpu()
        best = int(torch.argmax(cv))
        evals, Q = torch.linalg.eigh(P.mm(X.T, X) + eye)
        condition(evals)
        W = torch.empty(p, t, dtype=torch.float32, device=dev)
        for c0 in range(0, t, target_block):
            c1 = min(c0 + target_block, t)
            A = P.mm(Q.T, P.mm(X.T, Y[:, c0:c1]))
            W[:, c0:c1] = P.mm(Q, A / (evals + lams[best])[:, None])
    return Fit(cv=cv, best=best, weights=W, kappa=kappa)
