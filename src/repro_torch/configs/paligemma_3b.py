"""paligemma-3b [vlm] — SigLIP frontend (STUB) + gemma-2b backbone.

18L d_model=2048, 8 heads (head_dim 256), MQA kv=1, d_ff=16384, vocab 257216.
The SigLIP vision tower is a stub per assignment: ``input_specs()`` provides
256 precomputed patch embeddings which form a bidirectional prefix.
[arXiv:2407.07726]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    act_fn="gelu",
    num_patches=256,
    tie_embeddings=True,
    remat="dots",
)
