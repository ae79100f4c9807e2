"""Analytic time-complexity model of ridge variants (paper §3).

A copy of ``repro/core/complexity.py``: floating-point multiplication
counts of the ridge variants the paper compares (the single-shard paths,
MOR's Eq. 6 and B-MOR's Eq. 7) and the paper's Table 1 workloads, which the
port's dispatch and ``chip_smoke.py`` use.

Notation (paper Table 3): n time samples, p features, t targets, r candidate
λ values, c concurrent workers (mesh shards).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RidgeWorkload:
    n: int          # time samples
    p: int          # features
    t: int          # brain targets
    r: int = 11     # λ grid size (paper §2.2.4)
    n_folds: int = 5


def t_m_naive(w: RidgeWorkload) -> float:
    """T_M without the SVD trick: invert (XᵀX+λI) per λ — O(p³r + p²nr)."""
    return float(w.p) ** 3 * w.r + float(w.p) ** 2 * w.n * w.r


def t_m(w: RidgeWorkload) -> float:
    """T_M with the factorisation mutualised across λ: O(p²nr + pr)."""
    return float(w.p) ** 2 * w.n * w.r + float(w.p) * w.r


def t_w(w: RidgeWorkload) -> float:
    """T_W: applying M(λ) to the targets across the grid — O(pntr)."""
    return float(w.p) * w.n * w.t * w.r


def t_w_per_fold(w: RidgeWorkload) -> float:
    """Gram cost of per-fold re-accumulation: ``k·np²``."""
    return float(w.n_folds) * w.n * float(w.p) ** 2


def t_w_folded(w: RidgeWorkload) -> float:
    """Gram cost with single-pass fold statistics: ``np²``."""
    return float(w.n) * float(w.p) ** 2


def t_w_folded_dual(w: RidgeWorkload) -> float:
    """Dual mirror of ``t_w_folded``: one n×n kernel accumulation, ``n²p``."""
    return float(w.n) ** 2 * w.p


def fold_redundancy_factor(w: RidgeWorkload) -> float:
    """How much Gram work per-fold CV repeats vs the single-pass path (= k)."""
    return t_w_per_fold(w) / t_w_folded(w)


def t_m_dual(w: RidgeWorkload) -> float:
    """T_M in the dual/kernel form: factorise K = XXᵀ — O(n²pr + nr)."""
    return float(w.n) ** 2 * w.p * w.r + float(w.n) * w.r


def t_bmor_sharded(w: RidgeWorkload, c_data: int, c_target: int) -> float:
    """B-MOR with rows also sharded over ``c_data`` shards: the target axis
    divides T_W, the row axis divides T_M and the single-pass fold
    statistics (Eq. 7 extended)."""
    return t_w(w) / c_target + (t_m(w) + t_w_folded(w)) / c_data


def t_ridge_single(w: RidgeWorkload) -> float:
    """Single-worker mutualised RidgeCV: T_M + T_W (paper §3.1)."""
    return t_m(w) + t_w(w)


def t_mor(w: RidgeWorkload, c: int) -> float:
    """MOR: factorisation recomputed per *target* — Eq. 6: c⁻¹(T_W + t·T_M)."""
    return (t_w(w) + w.t * t_m(w)) / c


def t_bmor(w: RidgeWorkload, c: int) -> float:
    """B-MOR: one factorisation per *batch* — Eq. 7: c⁻¹·T_W + T_M."""
    return t_w(w) / c + t_m(w)


def predicted_speedup_bmor(w: RidgeWorkload, c: int) -> float:
    """DSU prediction: single-worker mutualised ridge over B-MOR on c workers."""
    return t_ridge_single(w) / t_bmor(w, c)


def mor_overhead_factor(w: RidgeWorkload, c: int) -> float:
    """How much slower MOR is than B-MOR at equal parallelism."""
    return t_mor(w, c) / t_bmor(w, c)


# Paper workloads (Table 1).
PAPER_P = 16384  # 4 TRs × 4096 VGG16 FC2 features (§2.2.2)

PAPER_WORKLOADS = {
    "parcels":          RidgeWorkload(n=69_202, p=PAPER_P, t=444),
    "roi":              RidgeWorkload(n=69_202, p=PAPER_P, t=6_728),
    "whole_brain":      RidgeWorkload(n=69_202, p=PAPER_P, t=264_805),
    "whole_brain_mor":  RidgeWorkload(n=1_000,  p=PAPER_P, t=2_000),
    "whole_brain_bmor": RidgeWorkload(n=10_000, p=PAPER_P, t=264_805),
}
