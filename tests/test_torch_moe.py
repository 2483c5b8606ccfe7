"""The port's mixture of experts (``repro_torch.models.moe``) against the
reference's ``models/moe.py`` (``_route``, ``moe_dense``) on the CPU.

8 routed experts top-2 of width 32 and one shared expert over d_model 64,
for softmax routing (v2) and sigmoid routing with a random ``router_bias``
(v3); the router redrawn at scale 0.5 so that tokens pick different
experts.  Routing is compared by index SETS per token (``torch.topk`` and
``jax.lax.top_k`` may order ties otherwise; none tie here) and the combine
weights by index.  Tolerances, relative to the scale (max |reference|):
float32 1e-5 (measured ~1e-7), bf16 5e-2; gradients (``jax.grad`` of the
reference's dense combine against the port's routed experts and their
backward) float32 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro_torch.core import census
from repro_torch.models import moe

from _deepseek_cases import ARCHS, configs, numpy_tree, randomize, rel

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
T = 40


def _case(arch, dtype="float32", seed=0):
    rcfg, cfg = configs(arch, dtype)
    rp = randomize(rmoe.init_moe(jax.random.PRNGKey(seed), rcfg),
                   np.random.default_rng(seed + 1))
    p = {}
    for k, v in numpy_tree(rp).items():
        if isinstance(v, dict):
            p[k] = {kk: torch.from_numpy(vv).to(TORCH[dtype])
                    for kk, vv in v.items()}
        else:
            dt = torch.float32 if k.startswith("router") else TORCH[dtype]
            p[k] = torch.from_numpy(v).to(dt)
    x = np.random.default_rng(seed + 2).normal(
        0, 1, (2, T // 2, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, rcfg.dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TORCH[dtype])
    return rcfg, cfg, rp, p, xj, xt


@pytest.mark.parametrize("arch", ARCHS)
def test_route_index_sets_weights_and_aux_match(arch):
    rcfg, cfg, rp, p, xj, xt = _case(arch)
    r_idx, r_w, r_aux = rmoe._route(rp, rcfg, xj.reshape(-1, cfg.d_model))
    idx, w, aux = moe.route(p, cfg, xt.reshape(-1, cfg.d_model))
    r_idx, r_w = np.asarray(r_idx), np.asarray(r_w)
    assert idx.dtype == torch.int64 and w.dtype == torch.float32
    assert len({tuple(sorted(r)) for r in r_idx}) > 4   # routing varies
    for t in range(T):
        assert set(idx[t].tolist()) == set(r_idx[t].tolist()), t
        by_index = dict(zip(r_idx[t].tolist(), r_w[t].tolist()))
        for e, wt in zip(idx[t].tolist(), w[t].tolist()):
            assert abs(wt - by_index[e]) <= 1e-6
    assert abs(float(aux) - float(r_aux)) <= 1e-6 * abs(float(r_aux))


def test_sigmoid_bias_moves_the_selection_not_the_weights():
    """v3: the bias picks the experts; the weights are the picked experts'
    sigmoid scores, renormalised."""
    _, cfg, _, p, _, xt = _case("deepseek_v3_671b")
    xf = xt.reshape(-1, cfg.d_model)
    idx, w, _ = moe.route(p, cfg, xf)
    scores = torch.sigmoid(xf @ p["router"])
    want = torch.gather(scores, -1, idx)
    torch.testing.assert_close(w, want / want.sum(-1, keepdim=True))
    unbiased = dict(p, router_bias=torch.zeros_like(p["router_bias"]))
    assert not torch.equal(moe.route(unbiased, cfg, xf)[0], idx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_moe_dense(arch, dtype):
    rcfg, cfg, rp, p, xj, xt = _case(arch, dtype)
    r_out, r_aux = rmoe.moe_dense(rp, rcfg, xj)
    out, aux = moe.moe_block(p, cfg, xt)
    assert tuple(out.shape) == tuple(xt.shape) and out.dtype == TORCH[dtype]
    assert rel(out, r_out) <= TOL[dtype]
    assert abs(float(aux) - float(r_aux)) <= 1e-5 * abs(float(r_aux))


def test_routed_experts_equal_every_expert_on_every_token():
    """Each assignment computed once equals the dense combine of every
    expert on every token (the reference's shape) in float32."""
    _, cfg, _, p, _, xt = _case("deepseek_v2_236b")
    xf = xt.reshape(-1, cfg.d_model)
    idx, w, _ = moe.route(p, cfg, xf)
    got = moe.RoutedExperts.apply(xf, idx, w, p["w_in"], p["w_gate"],
                                  p["w_out"])
    ys = torch.stack([moe._expert_ffn(xf, p["w_in"][e], p["w_gate"][e],
                                      p["w_out"][e])
                      for e in range(cfg.num_experts)])        # [E, T, D]
    combine = torch.zeros((T, cfg.num_experts)).scatter(1, idx, w)
    want = torch.einsum("te,etd->td", combine, ys)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad_of_moe_dense(arch):
    """d/d(x, router, w_in, w_gate, w_out, shared) of <out, r> + 0.5 aux:
    the routed experts' hand-written backward (each expert's forward
    recomputed and differentiated) and the router's gradient through the
    combine weights, against ``jax.grad`` of the reference's dense
    combine; the router bias gets none (the reference's stop-gradient)."""
    rcfg, cfg, rp, p, xj, xt = _case(arch)
    r = np.random.default_rng(9).normal(0, 1, xt.shape).astype(np.float32)

    def rloss(rp, x):
        out, aux = rmoe.moe_dense(rp, rcfg, x)
        return jnp.sum(out * r) + 0.5 * aux

    g_p, g_x = jax.grad(rloss, argnums=(0, 1))(rp, xj)
    leaves = {"router": p["router"], "w_in": p["w_in"],
              "w_gate": p["w_gate"], "w_out": p["w_out"],
              **{f"shared/{k}": v for k, v in p["shared"].items()}}
    for t in leaves.values():
        t.requires_grad_(True)
    xg = xt.clone().requires_grad_(True)
    out, aux = moe.moe_block(p, cfg, xg)
    loss = (out * torch.from_numpy(r)).sum() + 0.5 * aux
    grads = torch.autograd.grad(loss, [xg, *leaves.values()])
    assert rel(grads[0], g_x) <= TOL["float32"]
    flat = {"router": g_p["router"], "w_in": g_p["w_in"],
            "w_gate": g_p["w_gate"], "w_out": g_p["w_out"],
            **{f"shared/{k}": v for k, v in g_p["shared"].items()}}
    for name, g in zip(leaves, grads[1:]):
        assert rel(g, flat[name]) <= TOL["float32"], name
    assert not np.asarray(g_p["router_bias"]).any()


def test_two_runs_are_bitwise_equal():
    _, cfg, _, p, _, xt = _case("deepseek_v3_671b")
    a, b = moe.moe_block(p, cfg, xt), moe.moe_block(p, cfg, xt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_experts_without_tokens_get_zero_gradients():
    _, cfg, _, p, _, xt = _case("deepseek_v2_236b")
    xf = xt.reshape(-1, cfg.d_model)[:1]        # one token: 2 experts used
    idx, w, _ = moe.route(p, cfg, xf)
    ws = [p[k].clone().requires_grad_(True)
          for k in ("w_in", "w_gate", "w_out")]
    out = moe.RoutedExperts.apply(xf, idx, w, *ws)
    grads = torch.autograd.grad(out.sum(), ws)
    used = set(idx[0].tolist())
    for g in grads:
        for e in range(cfg.num_experts):
            assert bool(g[e].abs().sum() > 0) == (e in used)


def test_calls_count_forward_and_backward():
    _, cfg, _, p, _, xt = _case("deepseek_v2_236b")
    moe.reset_calls()
    w = p["w_in"].clone().requires_grad_(True)
    out, _ = moe.moe_block(dict(p, w_in=w), cfg, xt)
    out.sum().backward()
    assert moe.CALLS == {moe.MOE_FWD: 1, moe.MOE_BWD: 1}


def test_census_books_the_routed_experts_by_shape():
    """Under a census the routed experts are one entry whose work comes
    from shapes alone (``fwd_work`` / ``bwd_work``), the ops inside
    hidden; on the meta device (no values to route by) the same entries
    and empty outputs of the right shapes."""
    _, cfg, _, p, _, xt = _case("deepseek_v3_671b")
    t, d, f, e, k = T, cfg.d_model, cfg.moe_d_ff, cfg.num_experts, 2

    def step(p, x):
        ws = {n: p[n].detach().requires_grad_(True)
              for n in ("w_in", "w_gate", "w_out")}
        out, _ = moe.moe_block({**p, **ws}, cfg, x)
        torch.autograd.grad(out.float().sum(), list(ws.values()))

    want = {moe.MOE_FWD: moe.fwd_work(t, k, e, d, f, torch.float32),
            moe.MOE_BWD: moe.bwd_work(t, k, e, d, f, torch.float32)}
    meta = {n: (v.to("meta") if isinstance(v, torch.Tensor)
                else {kk: vv.to("meta") for kk, vv in v.items()})
            for n, v in p.items()}
    for args in ((p, xt), (meta, xt.to("meta"))):
        got = census.analyze_step(step, *args)["kernels"]
        assert {n: (got[n]["flops"], got[n]["bytes"]) for n in got} == \
            {n: (float(a), float(b)) for n, (a, b) in want.items()}
        assert all(got[n]["launches"] == 1 for n in got)
    out, aux = moe.moe_block(meta, cfg, xt.to("meta"))
    assert out.device.type == "meta" and tuple(out.shape) == tuple(xt.shape)


def test_a_mesh_raises():
    _, cfg, _, p, _, xt = _case("deepseek_v2_236b")
    with pytest.raises(NotImplementedError, match="12e step 5"):
        moe.moe_block(p, cfg, xt, dist=object())
    with pytest.raises(NotImplementedError, match="12e step 5"):
        moe.moe_ep_local(p, cfg, xt)
