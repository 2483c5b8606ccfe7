"""qwen2-72b [dense] — GQA kv=8, QKV bias.

80L d_model=8192, 64 heads, d_ff=29568, vocab 152064.  [arXiv:2407.10671]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    remat="full",
)
