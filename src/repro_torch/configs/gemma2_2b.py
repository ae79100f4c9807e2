"""gemma2-2b — alternating local/global attention + logit softcaps
[arXiv:2408.00118].

Port of ``repro/configs/gemma2_2b.py`` (numbers and ``source`` as the
reference's).  26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    pattern=("local_attn", "global_attn"),
    window=4096,
    mlp_act="geglu",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norm=True,
    scale_embedding=True,
    tie_embeddings=True,
    source="[arXiv:2408.00118] Gemma2: 2B = 26L/2304/8H/kv4/9216; "
           "local:global alternation w=4096; softcaps 50/30",
)
