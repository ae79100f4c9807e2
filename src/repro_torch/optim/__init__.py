"""Optimizer and learning-rate schedule of the training step (port of
``repro/optim``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, global_norm,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
