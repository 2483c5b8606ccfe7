"""Mamba2 SSD blocks (counterpart of the reference's ``models/ssd.py``).

Prefill and training run the chunked SSD scan of every layer on the
hand-written kernel K4 (``kernels.ops.ssd_scan``), which also returns the
final recurrent state for the cache; in training its gradient runs on K4's
hand-written backward (``kernels.ssd_scan.SSDScan``).  The reference's
models run the XLA form ``ssd_chunked`` (and train through its
``jax.vjp``) and never reach their Pallas kernel; the port's always reach
its kernels.
Decode is the reference's O(1) recurrent update, ``state <- state *
exp(dt A) + dt B (x) x``, as tensor code.  Projections are split (z / x / B
/ C / dt) as in the reference; ``ngroups == 1`` (mamba2, zamba2), the one
case K4 takes.

Numerics kept from the reference: products in the activation dtype; ``dt =
softplus(float32(dt_raw) + dt_bias)`` with softplus as ``logaddexp(x, 0)``
(``F.softplus`` returns x itself above its threshold 20, ``jax.nn.softplus``
has no threshold); the prefill conv a sum of ``cw`` shifted products in the
activation dtype, in order (``F.conv1d`` would accumulate otherwise); the
decode conv a float32-accumulated product over the window rounded once, as
the reference's einsum; the scan and the D skip in float32, cast to the activation dtype before
the gated norm.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init_mamba_block(generator, cfg, device=None) -> Dict:
    """The reference's block parameters: projections by ``dense_init``
    (conv weights at scale 0.2, the out projection at ``0.02 /
    sqrt(L)``), conv biases and ``dt_bias`` / ``A_log`` at zero, ``D`` at
    one, the gate norm at one."""
    d, di = cfg.d_model, cfg.d_inner
    ng, ds, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    cw = cfg.ssm_conv_width
    dt = L.dtype_of(cfg)
    p = {"in_z": L.dense_init(generator, (d, di), dt),
         "in_x": L.dense_init(generator, (d, di), dt),
         "in_b": L.dense_init(generator, (d, ng * ds), dt),
         "in_c": L.dense_init(generator, (d, ng * ds), dt),
         "in_dt": L.dense_init(generator, (d, nh), dt),
         "conv_w": L.dense_init(generator, (cw, di), dt, scale=0.2),
         "conv_b": torch.zeros((di,), dtype=dt),
         "conv_bc_w": L.dense_init(generator, (cw, 2 * ng * ds), dt,
                                   scale=0.2),
         "conv_bc_b": torch.zeros((2 * ng * ds,), dtype=dt),
         "dt_bias": torch.zeros((nh,), dtype=torch.float32),
         "A_log": torch.zeros((nh,), dtype=torch.float32),
         "D": torch.ones((nh,), dtype=torch.float32),
         "out_proj": L.dense_init(
             generator, (di, d), dt,
             scale=0.02 / max(cfg.num_layers, 1) ** 0.5)}
    p = {key: t.to(device) for key, t in p.items()}
    p["gate_norm"] = L.init_rmsnorm(di, device)
    return p


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _project_in(p, x: torch.Tensor):
    z = x @ p["in_z"]
    xs = x @ p["in_x"]
    bc = torch.cat([x @ p["in_b"], x @ p["in_c"]], dim=-1)
    dt = _softplus((x @ p["in_dt"]).float() + p["dt_bias"])
    return z, xs, bc, dt


def _causal_conv(xin: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  xin: [B, S, C]; w: [cw, C]; each shifted
    product and each partial sum rounded to the activation dtype, in the
    reference's order.  The silu rounds once (XLA's CPU lowering of
    ``jax.nn.silu`` rounds each of its four steps to bf16: up to two bf16
    ulps apart)."""
    cw, s = w.shape[0], xin.shape[1]
    pad = F.pad(xin, (0, 0, cw - 1, 0))
    out = sum(pad[:, i: i + s] * w[i] for i in range(cw))
    return F.silu(out + b)


def mamba_block(p, cfg, x: torch.Tensor, return_cache: bool = False):
    """Full-sequence Mamba2 block.  x: [B, S, D].  With ``return_cache``
    also ``(conv_tail, final_state)``: the last ``cw - 1`` rows of the
    pre-conv ``[xs, bc]`` and K4's final state."""
    di, ng, ds, nh, hp = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                          cfg.ssm_nheads, cfg.ssm_headdim)
    b_, s, _ = x.shape
    z, xs_raw, bc_raw, dt = _project_in(p, x)
    xs = _causal_conv(xs_raw, p["conv_w"], p["conv_b"])
    bc = _causal_conv(bc_raw, p["conv_bc_w"], p["conv_bc_b"])
    # column slices of one tensor: K4 reads them in place (row stride 2 ds)
    Bm = bc[..., : ng * ds].reshape(b_, s, ng, ds)
    Cm = bc[..., ng * ds:].reshape(b_, s, ng, ds)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b_, s, nh, hp)
    y, final_state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                                  out_dtype=torch.float32)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(b_, s, di).to(x.dtype)
    y = L.rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_cache:
        cw = cfg.ssm_conv_width
        conv_tail = torch.cat([xs_raw, bc_raw], dim=-1)[:, s - (cw - 1):]
        return out, (conv_tail, final_state)
    return out


def init_ssm_cache(cfg, batch: int, num_layers: int,
                   device=None) -> Dict[str, torch.Tensor]:
    ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {"conv": torch.zeros((num_layers, batch, cfg.ssm_conv_width - 1,
                                 ch), dtype=L.dtype_of(cfg), device=device),
            "state": torch.zeros((num_layers, batch, cfg.ssm_nheads,
                                  cfg.ssm_headdim, cfg.ssm_state),
                                 dtype=torch.float32, device=device)}


def decode_conv_weights(p) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode conv's weight [cw, C] (float32) and bias [C] over the
    joined ``[xs, bc]`` channels, which the reference concatenates in every
    step; built once per layer."""
    return (torch.cat([p["conv_w"], p["conv_bc_w"]], dim=1).float(),
            torch.cat([p["conv_b"], p["conv_bc_b"]]))


class DecodeConvJoins:
    """Each layer's ``decode_conv_weights``, joined on first use and joined
    again whenever a source parameter changed since: written in place (its
    ``_version``), replaced or moved (its ``data_ptr`` or device) --
    ``load_state_dict``, ``Module.to()`` and in-place updates included.
    The reference concatenates them on every step; the SSM and hybrid
    models keep one of these beside their layers."""

    def __init__(self, num_layers: int):
        # per layer: (what the join was built from, the joined weights)
        self._joined: List[Optional[Tuple[tuple, Tuple[
            torch.Tensor, torch.Tensor]]]] = [None] * num_layers

    def get(self, i: int, mix) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s joined decode conv weight and bias, ``mix`` its
        block parameters."""
        key = tuple((t._version, t.data_ptr(), t.device)
                    for t in (mix["conv_w"], mix["conv_bc_w"], mix["conv_b"],
                              mix["conv_bc_b"]))
        joined = self._joined[i]
        if joined is None or joined[0] != key:
            joined = self._joined[i] = (key, decode_conv_weights(mix))
        return joined[1]


def mamba_decode(p, cfg, x: torch.Tensor, cache: Mapping,
                 conv_wb: Tuple[torch.Tensor, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step.  x: [B, 1, D]; ``cache`` one layer's
    ``{"conv", "state"}``; ``conv_wb`` the layer's
    ``decode_conv_weights``; returns the block output and the new layer
    cache (new tensors, as the reference's)."""
    di, ng, ds, nh, hp = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                          cfg.ssm_nheads, cfg.ssm_headdim)
    b_ = x.shape[0]
    z, xs, bc, dt = _project_in(p, x)
    xbc = torch.cat([xs, bc], dim=-1)                    # [B, 1, di+2ngds]
    hist = torch.cat([cache["conv"], xbc], dim=1)        # [B, cw, C]
    w_all, b_all = conv_wb
    # einsum("bwc,wc->bc") of bf16 operands: exact products summed in
    # float32, rounded to the activation dtype once
    conv = torch.einsum("bwc,wc->bc", hist.float(), w_all).to(x.dtype)
    conv = F.silu(conv + b_all)
    xv = conv[:, :di].reshape(b_, nh, hp).float()
    Bv = conv[:, di: di + ng * ds].reshape(b_, ng, ds).float()
    Cv = conv[:, di + ng * ds:].reshape(b_, ng, ds).float()
    A = -torch.exp(p["A_log"])
    dtv = dt[:, 0]                                       # [B, nh]
    rep = nh // ng
    Bh = Bv.repeat_interleave(rep, dim=1)                # jnp.repeat, axis 1
    Ch = Cv.repeat_interleave(rep, dim=1)
    decay = torch.exp(dtv * A)
    state = (cache["state"] * decay[..., None, None]
             + (Bh * dtv[..., None])[:, :, None, :] * xv[..., None])
    y = torch.einsum("bhs,bhps->bhp", Ch, state)
    y = y + p["D"][:, None] * xv
    y = y.reshape(b_, 1, di).to(x.dtype)
    y = L.rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], {"conv": hist[:, 1:], "state": state}
