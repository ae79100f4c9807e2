"""Hand-written CUDA kernels of the port, with their plain versions.

  csrc/gram.cu — per-fold cross-Gram ``X_fᵀY_f`` (``xty_folds``, ``xty``)
                 and per-slot masked ``(X·w_s)ᵀZ`` (``xty_folds_masked``)
  gram.py      — checked launchers with launch counters (CUDA tensors only)
  _build.py    — nvcc build into ``build/kernels/`` and ctypes loading
  ref.py       — plain PyTorch versions (CPU path, tests, on-card checks)
  ops.py       — routes by tensor device: CPU → ref, CUDA → kernel
"""
from repro_torch.kernels import ops, ref  # noqa: F401
