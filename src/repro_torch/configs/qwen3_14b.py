"""qwen3-14b [dense] — GQA kv=8, qk_norm.

40L d_model=5120, 40 heads (head_dim 128), d_ff=17408, vocab 151936.
[hf:Qwen/Qwen3-14B family]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    remat="dots",
)
