"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768, d_state=128, expand=2 (d_inner=1536), headdim=64 -> 24 ssm
heads, conv width 4.  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    use_rope=False,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    sub_quadratic=True,
    remat="dots",
)
