"""stablelm-1.6b [dense] — full MHA (kv=32).

24L d_model=2048, 32 heads (head_dim 64), d_ff=5632, vocab 100352.
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    remat="none",
)
