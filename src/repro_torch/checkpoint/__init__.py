"""Checkpoint leaves on disk (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointError, latest_step, load, load_leaf, restore, save,
)
