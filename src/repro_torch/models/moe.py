"""Mixture of experts, the one-device path (the counterpart of the
reference's ``models/moe.py`` ``init_moe``, ``_route`` and ``moe_dense``).

Routing is the reference's, in float32: softmax top-k (deepseek v2), or
sigmoid scores with ``router_bias`` added for the SELECTION only and the
selected scores renormalised (v3, aux-loss free); the load-balance metric
``aux`` = E * sum_e f_e p_e either way.  The combine is exact, with no
capacity and no dropped token, and the shared experts run as the dense FFN
of width ``num_shared_experts * moe_d_ff``.

Unlike the reference's ``moe_dense`` -- every expert on every token, an
[E, T, D] output: 15 GB at v3's width and B=1 S=4096, and E / k times the
routed products -- each (token, expert) assignment is computed once:
``RoutedExperts`` sorts the T * k assignments by expert (a stable sort),
gathers their rows, runs each expert that got tokens as three
``torch.matmul`` over its rows, puts the outputs back in (token, slot)
order and sums each token's k weighted outputs in slot order, in float32.
No float atomics, so two runs are bitwise equal.  The reference computes
its experts with ``einsum`` outside any Pallas kernel, so no hand-written
kernel replaces one here; a grouped-GEMM kernel over the sorted rows is
later work (ROADMAP.md).

For the workload census ``RoutedExperts`` books itself through
``census.kernel_call`` as ``MOE_FWD`` / ``MOE_BWD`` with work from shapes
alone -- T * k assignments, three products of 2 D F each, the weights of
min(E, T * k) experts and the activations -- and hides the ops inside: the
routed dispatch depends on values, which the meta device does not have, so
the card's census equals the meta device's.  On meta it runs its products
on all T * k rows as one expert (what an op counter such as
``FlopCounterMode`` sees is then the card's sum over the experts) and
returns empty outputs of the right shapes.  ``CALLS`` counts its forward
and backward calls (meta excluded), beside the kernels' launch counts.

A mesh (expert parallelism, ``moe_ep_local``) raises: ROADMAP.md Queue 1
item 12e step 5.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import census
from repro_torch.models import layers as L

MOE_FWD = "moe_routed_experts"
MOE_BWD = "moe_routed_experts_bwd"
# calls since the last ``reset_calls`` (meta calls are not counted)
CALLS: Dict[str, int] = {MOE_FWD: 0, MOE_BWD: 0}

_MESH = ("expert parallelism (a mesh) is not ported yet: see ROADMAP.md "
         "Queue 1 item 12e step 5 (models/dist.py, models/sharding.py)")


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def init_moe(generator, cfg, device=None) -> Dict:
    """The reference's ``init_moe`` tree: ``router`` [d, E] float32
    (scale 0.006), ``router_bias`` [E] float32 zeros, ``w_in`` and
    ``w_gate`` [E, d, F], ``w_out`` [E, F, d] (scaled by 1/sqrt(L)), and
    ``shared`` (the dense FFN of width ``num_shared_experts * moe_d_ff``)
    where the config has shared experts."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = L.dtype_of(cfg)
    p = {"router": L.dense_init(generator, (d, e), torch.float32,
                                scale=0.006).to(device),
         "router_bias": torch.zeros((e,), dtype=torch.float32,
                                    device=device),
         "w_in": L.dense_init(generator, (e, d, f), dt).to(device),
         "w_gate": L.dense_init(generator, (e, d, f), dt).to(device),
         "w_out": L.dense_init(generator, (e, f, d), dt,
                               scale=0.02 / max(cfg.num_layers, 1) ** 0.5
                               ).to(device)}
    if cfg.num_shared_experts:
        p["shared"] = L.init_ffn(generator, shared_cfg(cfg), device=device)
    return p


def shared_cfg(cfg):
    """``cfg`` with the shared experts' width as its FFN width."""
    return dataclasses.replace(cfg,
                               d_ff=cfg.num_shared_experts * cfg.moe_d_ff)


def route(p, cfg, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf [T, D] -> (top-k expert indices [T, k] int64, combine weights
    [T, k] float32, aux): the reference's ``_route`` in float32.  The
    indices come from ``torch.topk`` (descending; ``jax.lax.top_k`` may
    order ties otherwise: compare index sets), and the weights are taken
    by index."""
    logits = xf.float() @ p["router"]
    k = cfg.experts_per_token
    if cfg.router_fn == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"].detach()   # biases the SELECTION
        idx = torch.topk(sel, k, dim=-1).indices
        w = torch.gather(scores, -1, idx)
        probs = torch.softmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    e = cfg.num_experts
    counts = torch.zeros((e,), dtype=torch.float32, device=xf.device)
    counts = counts.scatter_add(0, idx.reshape(-1),
                                torch.ones(idx.numel(), dtype=torch.float32,
                                           device=xf.device))
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    aux = e * torch.sum(frac * probs.mean(0))
    return idx, w, aux


def fwd_work(t: int, k: int, e: int, d: int, f: int,
             dtype: torch.dtype) -> Tuple[int, int]:
    """(flops, bytes) of one routed-experts forward as the census books
    it: T k assignments, three products of 2 D F each; the weights of
    min(E, T k) experts, x and the output read or written once, the
    indices (int64) and weights (float32) read once."""
    el = dtype.itemsize
    used = min(e, t * k)
    nbytes = el * (3 * used * d * f + 2 * t * d) + 12 * t * k
    return 6 * t * k * d * f, nbytes


def bwd_work(t: int, k: int, e: int, d: int, f: int,
             dtype: torch.dtype) -> Tuple[int, int]:
    """(flops, bytes) of one routed-experts backward: the forward's three
    products recomputed and six more (each product's two gradients), 18 T
    k D F; the used experts' weights read, all E experts' weight gradients
    written, x and the output's gradient read, x's gradient and the
    weights' written, the indices and weights read."""
    el = dtype.itemsize
    used = min(e, t * k)
    nbytes = el * (3 * used * d * f + 3 * e * d * f + 3 * t * d) \
        + 12 * t * k + 4 * t * k
    return 18 * t * k * d * f, nbytes


def _expert_ffn(x: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
                w_out: torch.Tensor) -> torch.Tensor:
    """One expert's SwiGLU over its rows (the reference's ``_expert_ffn``)."""
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


def _segments(idx: torch.Tensor, e: int
              ) -> Tuple[torch.Tensor, List[Tuple[int, int, int]]]:
    """The assignments sorted by expert (stable: each expert's in token
    order): (their positions in the flat [T k] order, [(expert, start,
    end)] of each expert that got any)."""
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=e).tolist()
    segs, start = [], 0
    for ex, n in enumerate(counts):
        if n:
            segs.append((ex, start, start + n))
            start += n
    return order, segs


class RoutedExperts(torch.autograd.Function):
    """out[t] = sum_j w[t, j] * ffn_{idx[t, j]}(x[t]) over each token's k
    slots in order, in float32, rounded to x's dtype once; each assignment
    computed once (module docstring).  x [T, D], idx [T, k], w [T, k]
    float32, w_in / w_gate [E, D, F], w_out [E, F, D].  The backward
    recomputes each expert's forward and differentiates it; gradients for
    x, w and the three weights (zeros for experts with no tokens)."""

    @staticmethod
    def forward(ctx, x, idx, w, w_in, w_gate, w_out):
        t, d = x.shape
        k = idx.shape[1]
        e, _, f = w_in.shape
        ctx.save_for_backward(x, idx, w, w_in, w_gate, w_out)
        with census.kernel_call(lambda: (MOE_FWD,
                                         *fwd_work(t, k, e, d, f, x.dtype))):
            if x.device.type == "meta":
                _expert_ffn(x.new_empty((t * k, d)), w_in[0], w_gate[0],
                            w_out[0])
                return torch.empty((t, d), dtype=x.dtype, device=x.device)
            CALLS[MOE_FWD] += 1
            y = _assignment_outputs(x, idx, w_in, w_gate, w_out)
            wx = w.to(x.dtype).float()
            out = (y.view(t, k, d).float() * wx[..., None]).sum(1)
            return out.to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        x, idx, w, w_in, w_gate, w_out = ctx.saved_tensors
        t, d = x.shape
        k = idx.shape[1]
        e, _, f = w_in.shape
        with census.kernel_call(lambda: (MOE_BWD,
                                         *bwd_work(t, k, e, d, f, x.dtype))):
            if x.device.type == "meta":
                rows = x.new_empty((t * k, d))
                _expert_grads(rows, rows, w_in[0], w_gate[0], w_out[0])
                return (torch.empty_like(x), None, torch.empty_like(w),
                        torch.empty_like(w_in), torch.empty_like(w_gate),
                        torch.empty_like(w_out))
            CALLS[MOE_BWD] += 1
            return _backward(dout, x, idx, w, w_in, w_gate, w_out)


def _assignment_outputs(x, idx, w_in, w_gate, w_out) -> torch.Tensor:
    """Each assignment's expert output [T k, D] in the flat (token, slot)
    order."""
    t, d = x.shape
    k = idx.shape[1]
    order, segs = _segments(idx, w_in.shape[0])
    rows = x[order // k]
    y = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    ys = torch.empty_like(rows)
    for ex, a, b in segs:
        ys[a:b] = _expert_ffn(rows[a:b], w_in[ex], w_gate[ex], w_out[ex])
    y[order] = ys
    return y


def _expert_grads(rows, dy, w_in, w_gate, w_out):
    """One expert's forward over its ``rows`` recomputed and differentiated
    against ``dy``: (its output, (d rows, d w_in, d w_gate, d w_out))."""
    with torch.enable_grad():
        xe = rows.detach().requires_grad_(True)
        wi, wg, wo = (t.detach().requires_grad_(True)
                      for t in (w_in, w_gate, w_out))
        ye = _expert_ffn(xe, wi, wg, wo)
        grads = torch.autograd.grad(ye, (xe, wi, wg, wo), dy)
    return ye.detach(), grads


def _backward(dout, x, idx, w, w_in, w_gate, w_out):
    t, d = x.shape
    k = idx.shape[1]
    order, segs = _segments(idx, w_in.shape[0])
    tok = order // k
    rows = x[tok]
    # the gradient of each assignment's output: its token's output gradient
    # times its weight (rounded to x's dtype, as the forward's product)
    wx = w.to(x.dtype).reshape(-1)[order]
    dy = (dout[tok].float() * wx.float()[:, None]).to(x.dtype)
    d_rows = torch.empty_like(rows)
    ys = torch.empty_like(rows)
    g_in, g_gate, g_out = (torch.zeros_like(w_in), torch.zeros_like(w_gate),
                           torch.zeros_like(w_out))
    for ex, a, b in segs:
        ys[a:b], grads = _expert_grads(rows[a:b], dy[a:b], w_in[ex],
                                       w_gate[ex], w_out[ex])
        d_rows[a:b], g_in[ex], g_gate[ex], g_out[ex] = grads
    # back to (token, slot) order, each token's k slots summed in order
    dx_slots = torch.empty_like(rows)
    dx_slots[order] = d_rows
    dx = dx_slots.view(t, k, d).float().sum(1).to(x.dtype)
    y = torch.empty_like(rows)
    y[order] = ys
    # the combine weights' gradient: <dout[t], y[t, j]>, through the
    # forward's rounding of w to x's dtype
    dw = (dout.float()[:, None, :] * y.view(t, k, d).float()).sum(-1)
    dw = dw.to(x.dtype).float()
    return dx, None, dw, g_in, g_gate, g_out


def moe_block(p, cfg, x: torch.Tensor, dist=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (routed experts + shared experts [B, S, D], aux): the
    reference's ``moe_dense`` numbers with each assignment computed once.
    A mesh (``dist``) raises: ROADMAP.md Queue 1 item 12e step 5."""
    if dist is not None:
        raise NotImplementedError(_MESH)
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    idx, w, aux = route(p, cfg, xf)
    out = RoutedExperts.apply(xf, idx, w, p["w_in"], p["w_gate"],
                              p["w_out"])
    if "shared" in p:
        out = out + L.ffn_block(p["shared"], cfg, x).reshape(-1, d)
    return out.reshape(b, s, d), aux


def moe_ep_local(*args, **kwargs):
    """The reference's expert-parallel body (inside ``shard_map``): not
    ported, ROADMAP.md Queue 1 item 12e step 5."""
    raise NotImplementedError(_MESH)
