"""Data sources of the port: ``fmri`` (the synthetic subject generator),
``store`` (the out-of-core ``RunStore``, byte-compatible with the
reference's) and ``synthetic`` (token batches for the feature backbones)."""
from repro_torch.data import fmri, store, synthetic  # noqa: F401
from repro_torch.data.store import RunStore, StoreError  # noqa: F401
