"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct].

Port of ``repro/configs/phi35_moe.py`` (numbers and ``source`` as the
reference's).  32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16e top-2.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32_064,
    pattern=("global_attn",),
    mlp_act="swiglu",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=16, top_k=2, capacity_factor=1.25,
                  group_size=4096),
    source="[hf:microsoft/Phi-3.5-MoE-instruct] 32L/4096/32H/kv8/6400/16e@2",
)
