"""Architecture configs (``get_config(arch)``) and the smoke reduction.

Port of ``repro/configs/__init__.py``.  ``ARCH_IDS`` lists every
architecture of the reference, and the port carries each one's config
(``dense``/``moe``/``vlm`` run through ``DecoderLM``, ``ssm``/``hybrid``
through ``HybridLM``, ``audio`` through ``EncDecLM``).
``smoke(cfg)`` derives the reduced same-family variant of the CPU tests
(≤2 pattern slots, d_model 256).  ``for_device(cfg, device)`` turns the
hand-written kernel tier on iff the device is CUDA, the rule
``EncoderConfig.use_pallas=None`` applies to the fit.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "mamba2-130m",
    "qwen3-1.7b",
    "phi3.5-moe-42b-a6.6b",
    "llava-next-34b",
    "zamba2-2.7b",
    "gemma-7b",
    "grok-1-314b",
    "gemma3-12b",
    "seamless-m4t-medium",
    "gemma2-2b",
)

_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "qwen3-1.7b": "qwen3_1_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llava-next-34b": "llava_next_34b",
    "zamba2-2.7b": "zamba2_2_7b",
    "gemma-7b": "gemma_7b",
    "grok-1-314b": "grok1_314b",
    "gemma3-12b": "gemma3_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "gemma2-2b": "gemma2_2b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def for_device(cfg: ModelConfig, device: torch.device | str) -> ModelConfig:
    """``cfg`` with the hand-written kernels (the SSD within-chunk term, the
    flash attention path) on iff ``device`` is CUDA, as the fit's kernel
    tier follows ``EncoderConfig.use_pallas=None``.  The SSD kernel takes
    ``n_groups == 1`` only; other SSM configs keep the einsum chain."""
    on = torch.device(device).type == "cuda"
    ssm = cfg.ssm
    if ssm is not None and ssm.n_groups == 1:
        ssm = dataclasses.replace(ssm, use_kernel=on)
    return dataclasses.replace(cfg, ssm=ssm, flash_kernel=on)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for single-CPU smoke tests."""
    # Keep pattern diversity with ≤2 entries: first and last kinds.
    pattern = cfg.pattern if len(cfg.pattern) <= 2 else \
        (cfg.pattern[0], cfg.pattern[-1])
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else n_heads
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4,
                                  top_k=min(cfg.moe.top_k, 2), group_size=64)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=8)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(pattern) * 1,           # one repeat of a ≤2-entry pattern
        pattern=pattern,
        d_model=256,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 32),
        shared_attn_window=(min(cfg.shared_attn_window, 32)
                            if cfg.shared_attn_window else None),
        moe=moe,
        ssm=ssm,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        param_dtype=cfg.param_dtype,
    )
