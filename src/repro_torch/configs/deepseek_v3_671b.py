"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 + MTP.

61L d_model=7168, 128 heads, MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), first 3 layers dense (d_ff=18432), MoE d_ff=2048, vocab 129280,
sigmoid aux-loss-free routing.  [arXiv:2412.19437]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: effectively full heads from latent
    d_ff=18432,                # dense layers' FFN width
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,              # nope + rope
    num_experts=256,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_k_dense=3,
    router_fn="sigmoid",
    mtp_depth=1,
    rope_theta=10000.0,
    optimizer="adafactor",     # factored 2nd moment: 671B state fits 16GB/chip
    remat="full",
)
