"""Host side of the split-bf16 tensor-core engine (``csrc/split_engine.cu``).

The engine computes ``out = A'ᵀ·B'`` in f32 accuracy on the bf16 tensor
cores: every f32 operand value is cut into bf16 terms
(``ref.bf16_split3``), a split pass writes the term planes into scratch,
and a bf16 GEMM sums the kept products of term pairs.  The wrappers of
``xty``, ``xty_folds`` and ``xty_folds_masked`` (``kernels/gram.py``) and
``solve_lambda_grid`` (``kernels/ridge_solve.py``) size and allocate that
scratch here; the plain model of the arithmetic is
``ref.split_product``.
"""
from __future__ import annotations

import math

import torch

# The engine's tiles (csrc/split_engine.cuh: kBM, kBN, kBNNarrow, kBK):
# output rows and columns per block (the narrow column tile where a
# product has at most 32 columns), contraction indices per stage.  Each
# operand's scratch holds its planes with rows padded to the tiles that
# read them and K to the stage.
TILE_M = 128
TILE_N = 192
TILE_N_NARROW = 32
STAGE_K = 32


def tile_n(n: int) -> int:
    """The B side's tile of an ``n``-column product (``tile_n`` in
    split_engine.cuh)."""
    return TILE_N_NARROW if n <= TILE_N_NARROW else TILE_N


def shared_tile(n: int) -> int:
    """The row padding of planes that both sides of an (n, n) product read
    (``xty`` where y is x; ``shared_pad`` in split_engine.cuh)."""
    return math.lcm(TILE_M, tile_n(n))

# The pairs (term of A', term of B') whose products the engine sums: all
# with i + j ≤ 2.  The three dropped, a₁b₂ + a₂b₁ + a₂b₂, are below
# 2⁻²¹·|a||b|.
KEPT_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def pairs(na: int, nb: int) -> list[tuple[int, int]]:
    """The kept pairs for ``na`` terms of A' and ``nb`` of B'."""
    return [(i, j) for i, j in KEPT_PAIRS if i < na and j < nb]


def masked_planes(dtype: torch.dtype) -> tuple[int, int]:
    """Terms of (x·w, z) in ``xty_folds_masked``: three each for f32; for
    bf16 the f32 product x·w of two bf16 values fits two, z is one."""
    return (2, 1) if dtype == torch.bfloat16 else (3, 3)


def folds_planes(dtype: torch.dtype) -> tuple[int, int]:
    """Terms of (x, y) in ``xty_folds``: three each for f32; a bf16 value
    is one exact term, and one product of two bf16 terms is exact."""
    return (1, 1) if dtype == torch.bfloat16 else (3, 3)


def solve_planes(dtype: torch.dtype) -> tuple[int, int]:
    """Terms of (Q, A·diag(1/(Λ+λ))) in ``solve_lambda_grid``: a bf16 Q is
    one term; the scaled A is f32 and takes three."""
    return (1, 3) if dtype == torch.bfloat16 else (3, 3)


def scratch_numel(rows: int, k: int, planes: int, tile: int) -> int:
    """bf16 elements of one operand's term planes: ``planes`` × rows padded
    to ``tile`` (the row padding of the split) × K padded to
    ``STAGE_K``."""
    return planes * -(-rows // tile) * tile * -(-k // STAGE_K) * STAGE_K


def scratch(rows: int, k: int, planes: int, tile: int,
            device: torch.device) -> torch.Tensor:
    """Uninitialised scratch for one operand (the split pass writes all of
    it, padding included)."""
    return torch.empty(scratch_numel(rows, k, planes, tile),
                       dtype=torch.bfloat16, device=device)
