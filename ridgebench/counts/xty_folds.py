"""Operations and bytes of the fold statistics ``X_fᵀ[X_f | Y_f]``.

The algorithm's work, whatever computes it: every row belongs to one
fold, so the ``k`` folds' Grams and cross-products together are one pass
over the ``n`` rows.  A Gram ``X_fᵀX_f`` is symmetric, so its upper
triangle is the work: ``n·p·(p+1)`` operations (a multiply and an add
for each of ``p·(p+1)/2`` entries per row); ``X_fᵀY_f`` is ``2·n·p·t``.
Bytes: ``X`` and ``Y`` read once and the ``k·p·(p+t)`` float32 outputs
written once.  The in-memory ``xty_folds`` and the streamed, masked
``xty_folds_masked`` have the same count: the rows each fold really
owns.
"""


def flops(n: int, p: int, t: int, k: int, itemsize: int = 4) -> float:
    return float(n) * p * (p + 1 + 2 * t)


def bytes(n: int, p: int, t: int, k: int, itemsize: int = 4) -> float:
    return float(itemsize) * (n * p + n * t + k * p * (p + t))
