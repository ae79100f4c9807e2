"""Fitted-encoder artifacts (port of ``repro/serving_encoders``).

``bundle`` — ``EncoderBundle``: atomic on-disk persistence of a fitted
``BrainEncoder`` (sharded W with bf16-as-u16 storage, μ/σ, selected λ,
config + dispatch provenance) with eager ``open()`` validation, in the
reference's format.  ``BrainEncoder.save(dir)`` / ``BrainEncoder.load(dir)``
round-trip through it bitwise.  The registry, service, traffic and fleet
modules are ROADMAP queue 1 item 8's rest.
"""
from repro_torch.serving_encoders.bundle import (  # noqa: F401
    BundleError, EncoderBundle, save_bundle,
)

__all__ = ["BundleError", "EncoderBundle", "save_bundle"]
