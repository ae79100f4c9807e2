"""Model zoo of the port: family dispatch.

Port of ``repro/models/__init__.py``.  The ``ssm`` and ``hybrid`` families
run through ``HybridLM`` (feature extraction: ``hidden_states``); the
other families are not ported yet.
"""
from __future__ import annotations

from repro_torch.models.config import (  # noqa: F401
    INPUT_SHAPES, InputShape, ModelConfig, MoEConfig, SSMConfig,
)


def build_model(cfg: ModelConfig):
    """The family's model object (``param_defs``, ``init``,
    ``hidden_states``)."""
    from repro_torch.models.hybrid import HybridLM

    if cfg.family in ("ssm", "hybrid"):
        return HybridLM(cfg)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: DecoderLM "
            f"and EncDecLM are ROADMAP queue 1 item 12")
    raise ValueError(f"unknown family: {cfg.family}")
