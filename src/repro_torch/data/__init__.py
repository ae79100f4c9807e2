"""Data sources of the port: ``fmri`` (the synthetic subject generator) and
``store`` (the out-of-core ``RunStore``, byte-compatible with the
reference's)."""
from repro_torch.data import fmri, store  # noqa: F401
from repro_torch.data.store import RunStore, StoreError  # noqa: F401
