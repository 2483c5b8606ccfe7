"""zamba2-1.2b [hybrid] — Mamba2 backbone + one SHARED attention block.

38 mamba2 layers d_model=2048 (d_state 64), a shared full-attention+MLP block
(32 heads, d_ff=8192) invoked every 6 ssm layers with tied weights.
[arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    attn_every=6,
    tie_embeddings=True,
    sub_quadratic=True,
    remat="dots",
)
