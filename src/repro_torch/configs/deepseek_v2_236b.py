"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.

60L d_model=5120, 128 heads, first 1 layer dense (d_ff=12288), MoE d_ff=1536,
vocab 102400, softmax routing.  [arXiv:2405.04434]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,
    vocab_size=102400,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1536,
    first_k_dense=1,
    router_fn="softmax",
    optimizer="adafactor",
    remat="full",
)
