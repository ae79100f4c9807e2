"""Model zoo of the port: family dispatch.

Port of ``repro/models/__init__.py``.  The ``dense``, ``moe`` and ``vlm``
families run through ``DecoderLM``, ``ssm`` and ``hybrid`` through
``HybridLM``; the ``audio`` family's ``EncDecLM`` is not ported yet
(ROADMAP queue 1 item 12).
"""
from __future__ import annotations

from repro_torch.models.config import (  # noqa: F401
    INPUT_SHAPES, InputShape, ModelConfig, MoEConfig, SSMConfig,
)


def build_model(cfg: ModelConfig):
    """The family's model object (``param_defs``, ``init``,
    ``hidden_states``, ``forward``, ``prefill``, ``decode_step``)."""
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.transformer import DecoderLM

    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return HybridLM(cfg)
    if cfg.family == "audio":
        raise NotImplementedError(
            f"family 'audio' ({cfg.name}) is not ported yet: EncDecLM is "
            f"ROADMAP queue 1 item 12")
    raise ValueError(f"unknown family: {cfg.family}")
