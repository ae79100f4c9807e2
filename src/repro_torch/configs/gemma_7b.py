"""gemma-7b — dense GeGLU decoder, head_dim=256 [arXiv:2403.08295].

Port of ``repro/configs/gemma_7b.py`` (numbers and ``source`` as the
reference's).  28L d_model=3072 16H (kv=16: MHA; MQA is used on the 2b
sibling) d_ff=24576 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab=256_000,
    pattern=("global_attn",),
    mlp_act="geglu",
    scale_embedding=True,
    tie_embeddings=True,
    source="[arXiv:2403.08295] Gemma: 7B = 28L/3072/16H/hd256/24576/256k vocab",
)
