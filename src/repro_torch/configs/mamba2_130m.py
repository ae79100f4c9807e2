"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

Port of ``repro/configs/mamba2_130m.py``: 24L d_model=768 (attention-free)
d_ff=0 vocab=50280, ssm_state=128.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,          # d_inner / head_dim = (2·768)/64
    n_kv_heads=24,
    d_ff=0,              # attention-free, no FFN (Mamba2 pure backbone)
    vocab=50_280,
    pattern=("mamba",),
    mlp_act="gelu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                  conv_kernel=4, chunk=256),
    source="[arXiv:2405.21060] Mamba2: Transformers are SSMs (SSD); "
           "130m model card dims",
)
