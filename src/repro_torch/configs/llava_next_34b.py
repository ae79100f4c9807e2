"""llava-next-34b — VLM with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; 34B uses the NousHermes-Yi-34B LM].

Port of ``repro/configs/llava_next_34b.py`` (numbers and ``source`` as the
reference's).  60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The vision tower is a stub: ``prefix_embeds`` are precomputed anyres patch
embeddings (B, n_patches, d_model) fed through a learned projector; this
config is the language decoder that consumes them.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab=64_000,
    pattern=("global_attn",),
    mlp_act="swiglu",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    frontend="vision_stub",
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf] anyres VLM; 34B LM dims "
           "(Yi-34B: 60L/7168/56H/kv8/20480)",
)
