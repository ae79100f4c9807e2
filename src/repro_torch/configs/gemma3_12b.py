"""gemma3-12b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family card].

Port of ``repro/configs/gemma3_12b.py`` (numbers and ``source`` as the
reference's).  48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144;
5 sliding-window (1024) layers per global layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab=262_144,
    pattern=("local_attn",) * 5 + ("global_attn",),
    window=1024,
    mlp_act="geglu",
    qk_norm=True,
    scale_embedding=True,
    use_post_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt] gemma3 family: 5:1 local:global, "
           "window 1024; 12B dims 48L/3840/16H/kv8/15360",
)
