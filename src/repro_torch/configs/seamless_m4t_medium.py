"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596].

Port of ``repro/configs/seamless_m4t_medium.py`` (numbers and ``source``
as the reference's).  12L encoder + 12L decoder, d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206.  The audio frontend is a stub, as in the
reference: ``src_embeds`` arrive as frame embeddings (B, frames, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,               # decoder depth
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256_206,
    pattern=("global_attn",),
    mlp_act="gelu",
    tie_embeddings=True,
    frontend="audio_stub",
    source="[arXiv:2308.11596] SeamlessM4T medium: 12L enc/dec, d=1024, "
           "16H, ffn 4096, vocab 256206",
)
