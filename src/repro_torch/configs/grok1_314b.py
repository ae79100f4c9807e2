"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1].

Port of ``repro/configs/grok1_314b.py`` (numbers and ``source`` as the
reference's).  64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8e top-2.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab=131_072,
    pattern=("global_attn",),
    mlp_act="swiglu",
    tie_embeddings=False,
    attn_logit_softcap=30.0,     # grok uses attn logit capping (30)
    final_logit_softcap=30.0,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                  group_size=4096),
    source="[hf:xai-org/grok-1] 64L/6144/48H/kv8/32768/8e@2, logit softcap 30",
)
