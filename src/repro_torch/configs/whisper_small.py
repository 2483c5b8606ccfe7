"""whisper-small [audio] — enc-dec backbone, conv frontend STUB.

12+12L d_model=768, 12 heads, d_ff=3072, vocab 51865, learned positions,
GELU MLP.  The conv1d/log-mel frontend is a stub per assignment:
``input_specs()`` provides 1500 precomputed frame embeddings.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    use_rope=False,
    act_fn="gelu",
    gated_mlp=False,
    is_encoder_decoder=True,
    encoder_layers=12,
    num_frames=1500,
    remat="none",
)
