"""Model-zoo configuration.

Port of ``repro/models/config.py``: ``ModelConfig``, ``SSMConfig``,
``MoEConfig`` and ``InputShape`` with every field name and default of the
reference.  ``param_dtype`` is a ``torch.dtype``.  Layer heterogeneity
(zamba2's mamba:shared-attention interleave) is a repeating ``pattern``;
the port's forward loops over the pattern's repeats.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

LayerKind = Literal["global_attn", "local_attn", "mamba", "shared_attn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 4096        # dispatch group (bounds one-hot matmul cost)
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1
    # Run the SSD within-chunk term through the hand-written kernel
    # (kernels/ssd.py, CUDA on a card, its plain version on the CPU) instead
    # of the einsum chain (requires n_groups == 1).
    use_kernel: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    # Repeating layer pattern; cycled n_layers/len(pattern) times.
    pattern: tuple[LayerKind, ...] = ("global_attn",)
    window: int = 4096                   # local_attn window size
    mlp_act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    qk_norm: bool = False
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scale_embedding: bool = False        # gemma: embed × sqrt(d_model)
    use_post_norm: bool = False          # gemma2/3 pre+post norm sandwich
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    shared_attn_every: int = 0           # zamba2: shared block cadence
    shared_attn_window: int | None = None  # window for the shared block
    # Encoder-decoder (audio family): encoder depth; decoder uses n_layers.
    n_encoder_layers: int = 0
    # Modality frontend stub: number of prefix embedding tokens consumed.
    frontend: Literal["none", "vision_stub", "audio_stub"] = "none"
    # Blockwise (flash-style) attention: full-sequence attention switches to
    # the streaming block loop when S ≥ flash_threshold.  None → always
    # dense-materialised scores.
    flash_threshold: int | None = None
    flash_block: int = 512
    # Run the flash path through the hand-written attention kernel
    # (kernels/attention.py) instead of the plain block loop.
    flash_kernel: bool = False
    # Chunked-vocab logsumexp in the CE loss: only one chunk's f32 logits
    # are live (each chunk recomputed in the backward).  1 → single pass.
    ce_vocab_chunks: int = 1
    param_dtype: torch.dtype = torch.bfloat16
    # Citation of the source model card / paper for the exact numbers.
    source: str = ""

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} is not a "
                             f"multiple of the pattern {self.pattern}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads={self.n_heads} is not a "
                             f"multiple of n_kv_heads={self.n_kv_heads}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    def with_sliding_windows(self, window: int = 4096) -> "ModelConfig":
        """long_500k override: every attention layer becomes sliding-window
        so the KV cache is bounded."""
        new_pattern = tuple(
            "local_attn" if k == "global_attn" else k for k in self.pattern)
        return dataclasses.replace(self, pattern=new_pattern,
                                   window=min(self.window, window),
                                   shared_attn_window=window)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One benchmark input shape from the assignment table."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   InputShape("long_500k", 524_288, 1, "decode"),
}
