"""Operations of one column-blocked whole-brain fit from a run store.

The program's whole-brain tier (``wholebrain.fit_wholebrain``): the fold
statistics of all rows and targets in one pass (``counts/xty_folds.py``;
the X-only Gram is shared by every block), ``k + 1`` eigendecompositions
hoisted out of the blocks (``counts/eigh.py``), and then, with only the
statistics at hand (the rows are not resident):

* per fold, the X-only terms ``u = xsumᵀQ`` and ``Ĝ_c = Qᵀ(G_f·Q)``
  (``2·p²`` and ``2·p³ + p³``: the second product is symmetric);
* per fold and target, ``QᵀC_tr`` and ``QᵀC_f`` (``4·p²·t``) and the
  per-λ quadratic forms ``diag(Z_rᵀĜ_cZ_r)`` (``2·r·p²·t``);
* the refit projection ``Q_RᵀC`` and the solve ``Q_R·z`` (``4·p²·t``).

Products only, so the count is below what any implementation performs
of this algorithm.
"""
from rb.spec import count as _count


def flops(n: int, p: int, t: int, k: int, r: int) -> float:
    stats = _count("xty_folds").flops(n, p, t, k)
    eighs = (k + 1) * _count("eigh").flops(p)
    x_terms = k * (2.0 * p * p + 3.0 * float(p) ** 3)
    score = k * (4.0 * p * p * t + 2.0 * r * p * p * t)
    refit = 4.0 * p * p * t
    return stats + eighs + x_terms + score + refit
