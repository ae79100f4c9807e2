"""Operations of one symmetric eigendecomposition with eigenvectors.

Householder tridiagonalisation, ``4/3·p³``, and the back-transformation
of the eigenvectors, ``2·p³``: the leading terms that any dense
``eigh`` performs.  The tridiagonal eigenproblem between them
(divide and conquer) is not counted: its work depends on deflation.
"""


def flops(p: int) -> float:
    return (4.0 / 3.0 + 2.0) * float(p) ** 3
