"""Operations of one in-memory primal cross-validated ridge fit.

The paper's estimator (arXiv:2403.19421 §2.2.4, §2.3.1) with the
downdated fold statistics and the r² trace identity, for ``n`` rows,
``p`` features, ``t`` targets, ``k`` folds and ``r`` values of λ:

* fold statistics, one pass over the rows (``counts/xty_folds.py``);
* ``k + 1`` eigendecompositions of ``p × p`` (``counts/eigh.py``);
* per fold, with ``v`` held-out rows: ``A = QᵀC_tr`` (``2·p²·t``),
  the held-out rows in the eigenbasis ``B = X_v·Q`` (``2·v·p²``),
  ``B_cᵀY_c`` (``2·v·p·t``), the symmetric ``A·Aᵀ`` and ``B_cᵀB_c``
  (``p²·t`` and ``v·p²``: upper triangles), and the per-λ quadratic
  forms (``2·r·p²``);
* the refit: ``QᵀC`` and ``Q·z`` (``4·p²·t``).

Products only: elementwise work, the downdate and the score sums are
left out, so the count is below what any implementation performs.
"""
from rb.spec import count as _count


def flops(n: int, p: int, t: int, k: int, r: int) -> float:
    stats = _count("xty_folds").flops(n, p, t, k)
    eighs = (k + 1) * _count("eigh").flops(p)
    score = 0.0
    for f in range(k):
        v = n // k + (1 if f < n % k else 0)
        score += (2.0 * p * p * t + 2.0 * v * p * p + 2.0 * v * p * t
                  + float(p) * p * t + float(v) * p * p + 2.0 * r * p * p)
    refit = 4.0 * p * p * t
    return stats + eighs + score + refit
