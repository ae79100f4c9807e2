"""Model zoo of the port: family dispatch.

Port of ``repro/models/__init__.py``.  The ``dense``, ``moe`` and ``vlm``
families run through ``DecoderLM``, ``ssm`` and ``hybrid`` through
``HybridLM``, and ``audio`` through ``EncDecLM``.
"""
from __future__ import annotations

from repro_torch.models.config import (  # noqa: F401
    INPUT_SHAPES, InputShape, ModelConfig, MoEConfig, SSMConfig,
)


def build_model(cfg: ModelConfig):
    """The family's model object (``param_defs``, ``init``,
    ``hidden_states``, ``forward``, ``loss``, ``prefill``,
    ``decode_step``)."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.transformer import DecoderLM

    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return HybridLM(cfg)
    if cfg.family == "audio":
        return EncDecLM(cfg)
    raise ValueError(f"unknown family: {cfg.family}")
