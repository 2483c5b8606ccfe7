"""granite-20b [dense] — llama-arch code model, MQA (kv=1).

52L d_model=6144, 48 heads, d_ff=24576, vocab 49152.  [arXiv:2405.04324]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    remat="dots",
)
