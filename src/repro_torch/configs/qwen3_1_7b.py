"""qwen3-1.7b — dense GQA decoder with qk-norm [hf:Qwen/Qwen3-8B family].

Port of ``repro/configs/qwen3_1_7b.py`` (numbers and ``source`` as the
reference's).  28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936,
qk_norm.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151_936,
    pattern=("global_attn",),
    mlp_act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-8B] (1.7B sibling card: 28L/2048/16H/kv8/6144)",
)
