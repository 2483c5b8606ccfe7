"""Early-design-time static features — the paper's predictor inputs.

The paper uses (a) hardware specs ("size and factor of the GPGPU, the number
of cores, the frequency, the available memory") and (b) NN descriptors
("varying layers and neurons"), plus (c) HyPA-derived executed-instruction
counts.  TPU adaptation, same three groups:

  (a) chip spec: peak FLOP/s, HBM BW/capacity, ICI BW, frequency, #chips,
      mesh shape;
  (b) arch descriptors: layers, d_model, heads, kv-heads, d_ff, vocab,
      experts/top-k, ssm dims, param counts, shape (seq, batch, kind);
  (c) ANALYTIC op counts (flops/bytes/collective estimates computed from the
      config alone with pencil-and-paper formulas — NO compilation, the whole
      point of the fast path).  These mirror what HyPA recovers from PTX, but
      from the model description instead of the artifact.

Everything here must stay cheap: called per design point inside DSE sweeps.

Counterpart of ``repro.core.features``, kept verbatim: pure numpy over this
package's ``configs`` and ``hw.CHIP_TABLE``, so a feature matrix built here
is bitwise the reference's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.hw import CHIP_TABLE, ChipSpec, ChipTable

FEATURE_NAMES: List[str] = [
    # hardware (a)
    "peak_tflops", "hbm_gbps", "hbm_gb", "ici_gbps", "freq_ghz", "n_chips",
    "mesh_data", "mesh_model", "tdp_w", "idle_w",
    # arch (b)
    "layers", "d_model", "heads", "kv_heads", "d_ff", "vocab_k", "params_b",
    "active_params_b", "experts", "topk", "ssm_state", "is_train", "is_decode",
    "seq_k", "batch", "tokens_m",
    # analytic counts (c) — the HyPA-analogue, from formulas not compilation
    "an_flops_pd_t", "an_hbm_gb_pd", "an_coll_gb_pd", "an_intensity",
    # analytic roofline-term estimates (still pencil-and-paper: counts / specs)
    "an_t_comp_ms", "an_t_mem_ms", "an_t_coll_ms", "an_t_max_ms",
]


def analytic_counts_batch(cfg: ArchConfig, shape: ShapeConfig, n_chips,
                          mesh_model) -> Dict[str, np.ndarray]:
    """Pencil-and-paper per-device flops/bytes/collective estimates,
    vectorized over candidate arrays ``n_chips`` / ``mesh_model`` (scalars
    broadcast)."""
    n_chips = np.asarray(n_chips)
    mesh_model = np.asarray(mesh_model)
    n_active = cfg.param_count(active=True)
    n_total = cfg.param_count(active=False)
    if shape.kind == "train":
        flops_global = 6.0 * n_active * shape.tokens
        # attention quadratic term (causal): 12 * L * H * hd * S^2 * B / 2 fwd+bwd
        if cfg.num_heads and cfg.attn_type != "none":
            hd = cfg.head_dim
            flops_global += 6.0 * cfg.num_layers * cfg.num_heads * hd * \
                shape.seq_len * shape.seq_len * shape.global_batch
        tokens = shape.tokens
    elif shape.kind == "prefill":
        flops_global = 2.0 * n_active * shape.tokens
        if cfg.num_heads and cfg.attn_type != "none":
            hd = cfg.head_dim
            flops_global += 2.0 * cfg.num_layers * cfg.num_heads * hd * \
                shape.seq_len * shape.seq_len * shape.global_batch
        tokens = shape.tokens
    else:  # decode: weights-bound
        flops_global = 2.0 * n_active * shape.global_batch
        if cfg.num_heads and cfg.attn_type != "none":
            hd = cfg.head_dim
            flops_global += 4.0 * cfg.num_layers * cfg.num_heads * hd * \
                shape.seq_len * shape.global_batch
        tokens = shape.global_batch
    flops_pd = flops_global / n_chips

    # HBM traffic: weights (decode: all of them, every step; train: ~3x for
    # fwd/bwd/update) + activations (~12 bytes/token/layer/d_model)
    bpp = 2.0
    if shape.kind == "train":
        w_bytes = 3.0 * n_total * (bpp + 4.0) / n_chips
        act_bytes = 14.0 * cfg.num_layers * cfg.d_model * tokens * bpp / n_chips
    elif shape.kind == "prefill":
        w_bytes = n_total * bpp / np.maximum(
            n_chips.astype(np.int64) // 8, 1) / 8
        act_bytes = 8.0 * cfg.num_layers * cfg.d_model * tokens * bpp / n_chips
    else:
        w_bytes = n_total * bpp / n_chips * mesh_model  # weights re-read per token
        kv = _kv_bytes_per_token(cfg)
        act_bytes = kv * shape.seq_len * shape.global_batch / n_chips
    hbm = w_bytes + act_bytes

    # collectives: TP all-reduces (2/layer of the activation block) + FSDP
    # weight gathers (params/device per step) + MoE dispatch
    act_block = tokens / n_chips * cfg.d_model * bpp
    coll = 4.0 * cfg.num_layers * act_block * (mesh_model - 1) / np.maximum(mesh_model, 1)
    coll = coll + n_total * bpp / n_chips * (2.0 if shape.kind == "train" else 1.0)
    if cfg.num_experts:
        coll = coll + 2.0 * cfg.experts_per_token * act_block
    intensity = flops_pd / np.maximum(hbm, 1.0)
    return {"an_flops_pd_t": flops_pd / 1e12, "an_hbm_gb_pd": hbm / 1e9,
            "an_coll_gb_pd": coll / 1e9, "an_intensity": intensity}


def analytic_counts(cfg: ArchConfig, shape: ShapeConfig, n_chips: int,
                    mesh_model: int) -> Dict[str, float]:
    """Scalar view of ``analytic_counts_batch`` (kept for per-point callers)."""
    an = analytic_counts_batch(cfg, shape, n_chips, mesh_model)
    return {k: float(v) for k, v in an.items()}


def _kv_bytes_per_token(cfg: ArchConfig) -> float:
    if cfg.attn_type == "mla":
        return 2.0 * cfg.num_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    if cfg.attn_type == "none":
        return 0.0
    return 2.0 * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim


def _feature_columns(cfg: ArchConfig, shape: ShapeConfig, *, peak, hbm_bw,
                     hbm_bytes, ici_bw, freq_mhz, tdp, idle, n_chips,
                     mesh_data, mesh_model) -> Dict[str, np.ndarray]:
    """FEATURE_NAMES -> column, vectorized over candidates (scalars broadcast).

    Hardware args are the already-derated (frequency-clamped/scaled) chip
    numbers except ``freq_mhz``, which is the caller's raw DVFS point.
    """
    an = analytic_counts_batch(cfg, shape, n_chips, mesh_model)
    t_comp = an["an_flops_pd_t"] * 1e12 / peak * 1e3
    t_mem = an["an_hbm_gb_pd"] * 1e9 / hbm_bw * 1e3
    has_ici = np.asarray(ici_bw) > 0
    t_coll = np.where(has_ici,
                      an["an_coll_gb_pd"] * 1e9 / np.where(has_ici, ici_bw, 1.0) * 1e3,
                      0.0)
    an = {**an, "an_t_comp_ms": t_comp, "an_t_mem_ms": t_mem,
          "an_t_coll_ms": t_coll,
          "an_t_max_ms": np.maximum(np.maximum(t_comp, t_mem), t_coll)}
    return {
        "peak_tflops": np.asarray(peak) / 1e12,
        "hbm_gbps": np.asarray(hbm_bw) / 1e9,
        "hbm_gb": np.asarray(hbm_bytes) / 1e9,
        "ici_gbps": np.asarray(ici_bw) / 1e9,
        "freq_ghz": np.asarray(freq_mhz) / 1e3,
        "n_chips": np.asarray(n_chips, np.float64),
        "mesh_data": np.asarray(mesh_data, np.float64),
        "mesh_model": np.asarray(mesh_model, np.float64),
        "tdp_w": np.asarray(tdp, np.float64),
        "idle_w": np.asarray(idle, np.float64),
        "layers": float(cfg.num_layers + cfg.encoder_layers),
        "d_model": float(cfg.d_model),
        "heads": float(cfg.num_heads),
        "kv_heads": float(cfg.num_kv_heads),
        "d_ff": float(max(cfg.d_ff, cfg.moe_d_ff)),
        "vocab_k": cfg.vocab_size / 1e3,
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.param_count(active=True) / 1e9,
        "experts": float(cfg.num_experts),
        "topk": float(cfg.experts_per_token),
        "ssm_state": float(cfg.ssm_state),
        "is_train": 1.0 if shape.kind == "train" else 0.0,
        "is_decode": 1.0 if shape.kind == "decode" else 0.0,
        "seq_k": shape.seq_len / 1e3,
        "batch": float(shape.global_batch),
        "tokens_m": shape.tokens / 1e6,
        **an,
    }


def extract(cfg: ArchConfig, shape: ShapeConfig, chip: ChipSpec, n_chips: int,
            mesh_shape=(16, 16), freq_mhz: float | None = None) -> List[float]:
    """One design point -> fixed-order feature vector (floats)."""
    freq = freq_mhz if freq_mhz is not None else chip.nominal_freq_mhz
    chip_f = chip.at_frequency(freq)
    mesh_data = mesh_shape[-2] if len(mesh_shape) >= 2 else 1
    mesh_model = mesh_shape[-1]
    vals = _feature_columns(
        cfg, shape, peak=chip_f.peak_flops_bf16, hbm_bw=chip_f.hbm_bw,
        hbm_bytes=chip_f.hbm_bytes, ici_bw=chip_f.ici_bw, freq_mhz=freq,
        tdp=chip_f.tdp_watts, idle=chip_f.idle_watts, n_chips=n_chips,
        mesh_data=mesh_data, mesh_model=mesh_model)
    return [float(vals[k]) for k in FEATURE_NAMES]


def extract_batch(cfg: ArchConfig, shape: ShapeConfig, chip_idx, n_chips,
                  mesh_data, mesh_model, freq_mhz,
                  table: ChipTable = CHIP_TABLE) -> np.ndarray:
    """Whole candidate arrays -> [N, n_features] float32 matrix in one pass.

    Chip properties are gathered from ``table`` by ``chip_idx``; no Python
    per-candidate loop, so building the fast-path design matrix scales to
    arbitrarily large spaces.  Row i equals ``extract`` for candidate i.
    """
    chip_idx = np.asarray(chip_idx)
    freq_raw = (table.nominal_freq_mhz[chip_idx] if freq_mhz is None
                else np.asarray(freq_mhz, np.float64))
    freq = np.clip(freq_raw, table.min_freq_mhz[chip_idx],
                   table.max_freq_mhz[chip_idx])
    peak = table.peak_flops_bf16[chip_idx] * (freq / table.nominal_freq_mhz[chip_idx])
    vals = _feature_columns(
        cfg, shape, peak=peak, hbm_bw=table.hbm_bw[chip_idx],
        hbm_bytes=table.hbm_bytes[chip_idx], ici_bw=table.ici_bw[chip_idx],
        freq_mhz=freq_raw, tdp=table.tdp_watts[chip_idx],
        idle=table.idle_watts[chip_idx], n_chips=n_chips,
        mesh_data=mesh_data, mesh_model=mesh_model)
    n = np.shape(chip_idx)[0]
    cols = [np.broadcast_to(np.asarray(vals[k], np.float64), (n,))
            for k in FEATURE_NAMES]
    return np.stack(cols, axis=1).astype(np.float32)
