"""The comparison that decides ``correct``.

Two numbers, each against the limit its cell file gives
(``cells/<workload>.json`` → ``limits``):

* ``cv_gap`` — the largest distance, over every fit of the window and
  every λ of the grid that float32 resolves, between the program's CV
  curve and the reference's (the mean score over folds and targets;
  unitless).  A λ is left out where the factorised system's condition
  number ``κ = (e_max + λ)/(e_min + λ)`` (the largest over the folds'
  training Grams and the full Gram, ``reference.Fit.kappa``) is so
  large that float32's rounding ``ε·κ`` exceeds ``RESOLVED``: there
  the held-out predictions are rounding amplified by ``1/λ`` in the
  Gram's null space (fewer training rows than features), in the
  program and in the reference alike, and the score has no digit to
  compare;
* ``w_gap`` — the largest distance between the program's weights of the
  window's last fit and the reference's weights at the reference's own
  λ, over the largest reference weight.  A λ chosen other than the
  reference's gives weights of another λ, so this number judges the
  selected λ too.
"""
from __future__ import annotations

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)
RESOLVED = 0.1


def resolved(ref) -> np.ndarray:
    """The λ (a boolean mask over the grid) whose scores float32
    resolves."""
    return EPS32 * np.asarray(ref.kappa, np.float64) <= RESOLVED


def gaps(cvs: list[np.ndarray], W: torch.Tensor, ref) -> dict[str, float]:
    keep = resolved(ref)
    cv_gap = float("nan")         # fails the limit: nothing to compare
    if keep.any():
        cv_ref = np.asarray(ref.cv, np.float64)[keep]
        cv_gap = max(float(np.max(np.abs(np.asarray(cv, np.float64)[keep]
                                         - cv_ref))) for cv in cvs)
    Wr = ref.weights
    scale = float(Wr.abs().max())
    w_gap = float((W.to(Wr.device, torch.float32) - Wr).abs().max()) / scale
    return {"cv_gap": cv_gap, "w_gap": w_gap}


def judge(numbers: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict]:
    """``(all within their limits, {name: {"value", "limit"}})``; a
    number that is not finite fails."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
