"""Hand-written CUDA kernels of the port, with their plain versions.

  csrc/gram.cu — per-fold cross-Gram ``X_fᵀY_f`` (``xty_folds``, ``xty``)
                 and per-slot masked ``(X·w_s)ᵀZ`` (``xty_folds_masked``)
  csrc/flash_attention.cu — streaming-softmax attention (``flash_attention``,
                 ``mha_flash``)
  csrc/ssd.cu  — the Mamba2 SSD within-chunk term (``ssd_intra``)
  csrc/ridge_solve.cu — multi-λ eigenbasis solve ``Q·diag(1/(Λ+λ_r))·A``
                 (``solve_lambda_grid``)
  csrc/pearsonr.cu — per-target Pearson r from five running sums
                 (``pearson_r``)
  gram.py, attention.py, ssd.py, ridge_solve.py, pearsonr.py — checked
                 launchers with launch counters (CUDA tensors only);
                 pearsonr.py also holds the plain sums and finalise
  _build.py    — nvcc build into ``build/kernels/`` and ctypes loading
  ref.py       — plain PyTorch versions (CPU path, tests, on-card checks)
  ops.py       — routes by tensor device: CPU → ref, CUDA → kernel
"""
from repro_torch.kernels import ops, ref  # noqa: F401
