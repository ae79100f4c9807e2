"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention [arXiv:2411.15242].

Port of ``repro/configs/zamba2_2_7b.py``.  54L d_model=2560 32H (MHA,
kv=32, head_dim 80) d_ff=10240 vocab=32000, ssm_state=64: 54 Mamba2 blocks
with the weight-*shared* attention+MLP block applied every 6 blocks →
pattern (mamba×6, shared_attn) × 9 repeats.  ``n_layers`` counts pattern
slots (54 mamba + 9 shared applications = 63); the shared block has ONE
copy of its weights.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=63,                      # 54 mamba slots + 9 shared-attn slots
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,                    # MHA in the shared block
    head_dim=80,
    d_ff=10_240,
    vocab=32_000,
    pattern=("mamba",) * 6 + ("shared_attn",),
    mlp_act="geglu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                  conv_kernel=4, chunk=256),
    source="[arXiv:2411.15242] Zamba2: 54 mamba2 blocks, shared attn block, "
           "d=2560, state=64",
)
