"""One configuration object for the whole encoding stack.

Port of ``repro/encoding/config.py``.  ``EncoderConfig`` keeps every field,
name and default of the reference, so a serialised config reads the same in
either package.  ``use_pallas`` names the kernel tier: here the hand-written
CUDA kernels, on by default iff the encoder runs on a CUDA device.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.banded import BandedConfig
from repro_torch.core.ridge import PAPER_LAMBDA_GRID, RidgeCVConfig
from repro_torch.kernels import ops

# Solver identifiers, in the paper's vocabulary (bmor and bmor_dual, and
# mor with target_shards > 1, run over the ranks of torch.distributed):
#   ridge     — single-shard SVD/eigh-mutualised RidgeCV (§2.3.1)
#   mor       — MultiOutput ridge baseline, per-target recompute (§2.3.4)
#   bmor      — Batch Multi-Output ridge, targets batched over shards (Alg. 1)
#   bmor_dual — B-MOR on the kernel (n < p regime; rows replicated)
#   banded    — per-feature-space λ (la Tour et al. 2022, paper ref [13])
Solver = Literal["auto", "ridge", "mor", "bmor", "bmor_dual", "banded"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Everything a ``BrainEncoder`` needs, in one place."""

    # --- ridge CV (paper §2.2.4) ------------------------------------------
    lambdas: tuple[float, ...] = PAPER_LAMBDA_GRID
    n_folds: int = 5
    jitter: float = 1e-6
    scoring: Literal["r", "r2"] = "r2"
    # Kernel tier (CUDA cross-Gram kernels).  Tri-state: None (default) =
    # on iff the device is CUDA; True pins it on (a CPU device raises);
    # False pins it off (the plain kernels.ref products).
    use_pallas: bool | None = None

    # --- solver selection --------------------------------------------------
    solver: Solver = "auto"
    # Factorisation side for the ridge path ("auto" → primal iff n >= p).
    method: Literal["auto", "eigh", "dual"] = "auto"
    # MOR only: one isolated fit per target (paper Fig. 8 semantics); in
    # eager PyTorch mor_fit pays the same per-target cost.
    mor_taskwise: bool = False

    # --- banded ridge (set ``bands`` to enable) ----------------------------
    bands: tuple[int, ...] | None = None
    n_band_candidates: int = 16
    band_log_lambda_range: tuple[float, float] = (-2.0, 4.0)

    # --- sharding ----------------------------------------------------------
    data_shards: int | None = None
    target_shards: int | None = None
    data_axis: str = "data"
    target_axis: str = "model"

    # --- out-of-core streaming (paper Table 1 whole-brain regime) ----------
    device_memory_budget: int | None = None
    chunk_rows: int = 8192
    prefetch: bool = True
    prefetch_depth: int = 2
    target_block: int | None = None

    # --- determinism -------------------------------------------------------
    seed: int = 0

    def resolve_use_pallas(self, device: torch.device | str) -> bool:
        """The kernel-tier decision as a concrete bool for ``device``."""
        device = torch.device(device)
        if self.use_pallas is None:
            return ops.kernel_tier_auto(device)
        if self.use_pallas and device.type != "cuda":
            raise ValueError(f"use_pallas=True needs a CUDA device; the "
                             f"kernels do not run on {device}")
        return self.use_pallas

    def ridge_cv_config(self, method: str | None = None, *,
                        device: torch.device | str) -> RidgeCVConfig:
        """Project onto the low-level ``RidgeCVConfig``."""
        return RidgeCVConfig(
            lambdas=self.lambdas, n_folds=self.n_folds,
            method=method or self.method, jitter=self.jitter,
            scoring=self.scoring,
            use_pallas=self.resolve_use_pallas(device))

    def banded_config(self) -> BandedConfig:
        """Project onto the low-level ``BandedConfig`` (requires ``bands``)."""
        if self.bands is None:
            raise ValueError("EncoderConfig.bands must be set for the banded "
                             "solver (one feature count per band)")
        return BandedConfig(
            bands=self.bands, n_candidates=self.n_band_candidates,
            log_lambda_range=self.band_log_lambda_range,
            n_folds=self.n_folds, jitter=self.jitter)
