"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape a
``ShapeConfig``.  A (arch, shape, mesh, chip, freq) tuple is one *design point*
— the unit the paper's DSE sweeps over.

Plain dataclasses, field for field the reference package's (``configs/``
there), so a config compares equal across the two packages and artifacts
keyed by it stay comparable.  Field values are kept verbatim, including the
reference's implementation names (``attn_impl`` / ``ssm_impl``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in LM_SHAPES}

# Reduced shapes for smoke tests (same kinds, tiny extents).
SMOKE_TRAIN = ShapeConfig("smoke_train", 64, 2, "train")
SMOKE_PREFILL = ShapeConfig("smoke_prefill", 64, 2, "prefill")
SMOKE_DECODE = ShapeConfig("smoke_decode", 64, 2, "decode")


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Unified model description covering all assigned families."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio | cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention variant ---------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True           # False -> learned positional embeddings

    # --- MLA (DeepSeek) -------------------------------------------------------
    q_lora_rank: int = 0            # 0 -> full-rank Q projection
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0          # leading dense layers (DeepSeek)
    router_fn: str = "softmax"      # softmax | sigmoid (v3 aux-free bias routing)
    capacity_factor: float = 1.25
    moe_fsdp: str = "gather"        # gather weights | "partial" contraction
                                    # (psum activations) | "auto" by bytes
    moe_combine_dtype: str = "float32"   # psum dtype for the combine ("bfloat16"
                                         # halves the dominant MoE collective)
    mtp_depth: int = 0              # multi-token-prediction extra heads (v3)

    # --- SSM (Mamba2 / SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # --- hybrid (Zamba2) -------------------------------------------------------
    attn_every: int = 0             # shared attention block every N ssm blocks

    # --- enc-dec / multimodal ---------------------------------------------------
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    num_frames: int = 0             # audio stub: precomputed frame embeddings
    num_patches: int = 0            # vlm stub: precomputed patch embeddings

    # --- cnn (paper's own domain) ------------------------------------------------
    cnn_stages: Tuple[int, ...] = ()
    cnn_width: int = 64
    image_size: int = 224

    # --- numerics / training ----------------------------------------------------
    norm_eps: float = 1e-6
    act_fn: str = "silu"            # silu (swiglu) | gelu (whisper / gemma)
    gated_mlp: bool = True          # False -> plain 2-matrix MLP (whisper)
    attn_impl: str = "xla"          # xla | pallas (fused flash-attention
                                    # kernel, K3: scores stay on chip)
    ssm_impl: str = "xla"           # xla | pallas (fused SSD chunk kernel, K4)
    cache_layout: str = "seq_major"  # seq_major [L,B,S,KV,hd] | head_major
                                     # [L,B,KV,S,hd] (decode-dot-friendly: no
                                     # per-layer cache transpose; §Perf)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"             # none | dots | full (activation ckpt policy)
    optimizer: str = "adamw"        # adamw | adamw8bit
    sub_quadratic: bool = False     # supports long_500k decode

    # ---------------------------------------------------------------------------

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # --- derived quantities used by features.py / roofline -----------------------

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and i >= self.first_k_dense

    def attn_params_per_layer(self) -> int:
        d = self.d_model
        if self.attn_type == "mla":
            nope, rope_d, vd = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
            h = self.num_heads
            p = 0
            if self.q_lora_rank:
                p += d * self.q_lora_rank + self.q_lora_rank * h * (nope + rope_d)
            else:
                p += d * h * (nope + rope_d)
            p += d * (self.kv_lora_rank + rope_d)                   # down-proj + k_rope
            p += self.kv_lora_rank * h * (nope + vd)                # up-proj
            p += h * vd * d                                         # o-proj
            return p
        if self.attn_type == "none":
            return 0
        hd = self.head_dim
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d

    def ssm_params_per_layer(self) -> int:
        if not self.ssm_state:
            return 0
        d, di = self.d_model, self.d_inner
        ng, ds, nh = self.ssm_ngroups, self.ssm_state, self.ssm_nheads
        in_proj = d * (2 * di + 2 * ng * ds + nh)       # z, x, B, C, dt
        conv = self.ssm_conv_width * (di + 2 * ng * ds)
        out = di * d
        return in_proj + conv + out + 2 * nh            # A_log, D

    def ffn_params(self, i: int) -> int:
        d = self.d_model
        if self.is_moe_layer(i):
            e = self.num_experts * 3 * d * self.moe_d_ff
            e += self.num_shared_experts * 3 * d * self.moe_d_ff
            e += d * self.num_experts                   # router
            return e
        return 3 * d * self.d_ff if self.act_fn == "silu" else 2 * d * self.d_ff

    def ffn_active_params(self, i: int) -> int:
        d = self.d_model
        if self.is_moe_layer(i):
            return (self.experts_per_token + self.num_shared_experts) * 3 * d * self.moe_d_ff
        return self.ffn_params(i)

    def _body_params(self, active: bool) -> int:
        total = 0
        n_dec = self.num_layers
        for i in range(n_dec):
            if self.family in ("ssm",):
                total += self.ssm_params_per_layer() + self.ffn_params(i) * 0
                # mamba2 has no separate FFN; block = ssm only
            elif self.family == "hybrid":
                total += self.ssm_params_per_layer()
            else:
                total += self.attn_params_per_layer()
                total += self.ffn_active_params(i) if active else self.ffn_params(i)
        if self.family == "hybrid" and self.attn_every:
            # one SHARED attention+mlp block (weights shared across call sites)
            hd = self.head_dim
            shared = self.d_model * self.num_heads * hd * 2 + 2 * self.d_model * self.num_kv_heads * hd
            shared += 3 * self.d_model * self.d_ff
            total += shared
        if self.is_encoder_decoder:
            for _ in range(self.encoder_layers):
                total += self.attn_params_per_layer()
                total += 2 * self.d_model * self.d_ff
            # decoder cross-attention
            total += self.num_layers * self.attn_params_per_layer()
        return total

    def param_count(self, active: bool = False) -> int:
        """Total (or active, for MoE) parameter count, embeddings included."""
        emb = self.vocab_size * self.d_model
        out = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return emb + out + self._body_params(active)

    def model_flops(self, shape: ShapeConfig) -> float:
        """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); 2*N*D for fwd-only."""
        n = self.param_count(active=True)
        if shape.kind == "train":
            per_tok = 6.0 * n
            toks = shape.tokens
        elif shape.kind == "prefill":
            per_tok = 2.0 * n
            toks = shape.tokens
        else:  # decode: one new token per sequence
            per_tok = 2.0 * n
            toks = shape.global_batch
        return per_tok * toks

    def applicable_shapes(self) -> Tuple[ShapeConfig, ...]:
        out = []
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.sub_quadratic:
                continue  # needs sub-quadratic attention; skip for full-attn archs
            out.append(s)
        return tuple(out)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) or 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
        )
        if self.attn_type == "mla":
            kw.update(q_lora_rank=32 if self.q_lora_rank else 0, kv_lora_rank=32,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        if self.num_experts:
            kw.update(num_experts=8, experts_per_token=2, moe_d_ff=32,
                      first_k_dense=min(self.first_k_dense, 1),
                      num_shared_experts=min(self.num_shared_experts, 1))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.is_encoder_decoder:
            kw.update(encoder_layers=2, num_frames=8)
        if self.num_patches:
            kw.update(num_patches=8)
        if self.mtp_depth:
            kw.update(mtp_depth=1)
        if self.cnn_stages:
            kw.update(cnn_stages=(1, 1), cnn_width=8, image_size=32)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------

ARCH_NAMES = (
    "mamba2_130m",
    "deepseek_v3_671b",
    "deepseek_v2_236b",
    "qwen3_14b",
    "qwen2_72b",
    "granite_20b",
    "stablelm_1_6b",
    "paligemma_3b",
    "whisper_small",
    "zamba2_1_2b",
    "resnet50",  # the paper's own CNN domain
)

def get_config(name: str) -> ArchConfig:
    key = name.lower().replace("-", "_").replace(".", "_")
    if key not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_configs() -> dict:
    return {n: get_config(n) for n in ARCH_NAMES}
