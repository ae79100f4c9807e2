"""Data sources of the port (``fmri``: the synthetic subject generator)."""
from repro_torch.data import fmri  # noqa: F401
