"""Hand-written CUDA kernels of the port, with their plain versions.

  csrc/gram.cu — per-fold cross-Gram ``X_fᵀY_f`` (``xty_folds``) and
                 per-slot masked ``(X·w_s)ᵀZ`` (``xty_folds_masked``), both
                 on the split engine, and ``XᵀY`` (``xty``) on a CUDA-core
                 row loop
  csrc/split_engine.cu — the split-bf16 tensor-core engine: f32 operands
                 cut exactly into bf16 terms, the kept term products
                 summed on ``wgmma``; it carries ``xty_folds``,
                 ``xty_folds_masked`` and ``solve_lambda_grid``, each
                 bound by its tensor-core operations
  csrc/flash_attention.cu — streaming-softmax attention (``flash_attention``,
                 ``mha_flash``; bf16 on the tensor cores)
  csrc/ssd.cu  — the Mamba2 SSD within-chunk term (``ssd_intra``) on the
                 tensor cores, L and x cut into exact bf16 terms;
                 bytes-bound (~1.4 GB at the zamba2-2.7b forward's shape)
  csrc/ridge_solve.cu — multi-λ eigenbasis solve ``Q·diag(1/(Λ+λ_r))·A``
                 (``solve_lambda_grid``, on the split engine)
  csrc/hopper.cuh — shared Hopper helpers (mbarriers, bulk copies, wgmma)
  csrc/pearsonr.cu — per-target Pearson r from five running sums
                 (``pearson_r``)
  gram.py, attention.py, ssd.py, ridge_solve.py, pearsonr.py — checked
                 launchers with launch counters (CUDA tensors only);
                 pearsonr.py also holds the plain sums and finalise
  split_engine.py — the engine's tiles, kept term pairs and scratch sizes
  _build.py    — nvcc build into ``build/kernels/`` and ctypes loading
  ref.py       — plain PyTorch versions (CPU path, tests, on-card checks)
  ops.py       — routes by tensor device: CPU → ref, CUDA → kernel
"""
from repro_torch.kernels import ops, ref  # noqa: F401
