"""The port's deepseek v2 / v3 serving path (the MoE family:
``transformer.Transformer`` with MLA and the experts) against the
reference's ``models/transformer.py`` on the CPU.

Configs and weights: ``tests/_deepseek_cases.py`` (3 layers -- 1 dense + 2
MoE -- at MLA's real head dims, d_model 64, 8 experts top-2, one shared;
v3 with its MTP head, which serving does not run).  Tokens are numpy
draws; prefill runs attention on K3's plain version at (192, 128), decode
the absorbed MLA over the compressed cache.  Tolerances, relative to the
scale (max |reference|): float32 1e-5 (measured ~3e-7), bf16 5e-2 for
logits and 2e-2 for cache entries (those of
``tests/test_torch_transformer.py``).  In bf16 a token near a tie in the
router can pick another expert than in the reference; the bf16 cases
compare the prefill (every token's route agrees at these draws), and the
decode steps run in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as rt
from repro_torch.configs import base
from repro_torch.models import api
from repro_torch.models.api import build_model

from _deepseek_cases import (ARCHS, B, S, configs, port_model,
                             reference_params, rel, tokens)

LOGIT_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]

_CASES = {}


def _case(arch, dtype):
    """(reference cfg, port cfg, reference params, port model, tokens,
    reference prefill (logits, cache)), built once per (arch, dtype)."""
    key = (arch, dtype)
    if key not in _CASES:
        rcfg, cfg = configs(arch, dtype)
        params = reference_params(rcfg)
        model = port_model(params, cfg)
        toks = tokens(cfg)
        _CASES[key] = (rcfg, cfg, params, model, toks,
                       rt.prefill(params, rcfg, jnp.asarray(toks)))
    return _CASES[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_build_on_meta(arch):
    """The published widths build (shapes only, on the meta device): two
    stacks, MLA, the experts, v3's MTP head; the compressed cache."""
    cfg = base.get_config(arch)
    model = build_model(cfg).init(device="meta")
    assert [k for k, _ in model.stacks()] == ["dense", "moe"]
    assert len(model.dense_layers) == cfg.first_k_dense
    assert len(model.moe_layers) == cfg.num_layers - cfg.first_k_dense
    moe = model.moe_layers[0]["moe"]
    assert tuple(moe["w_in"].shape) == (cfg.num_experts, cfg.d_model,
                                        cfg.moe_d_ff)
    assert moe["router"].dtype == torch.float32
    assert (model.mtp is not None) == bool(cfg.mtp_depth)
    cache = build_model(cfg).init_cache(2, 16, device="meta")
    assert set(cache) == {"len", "dense", "moe"}
    assert tuple(cache["moe"]["c_kv"].shape) == (
        cfg.num_layers - cfg.first_k_dense, 2, 16, cfg.kv_lora_rank)
    assert tuple(cache["dense"]["k_rope"].shape) == (
        cfg.first_k_dense, 2, 16, cfg.qk_rope_head_dim)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_compressed_cache_match(arch, dtype):
    rcfg, cfg, params, model, toks, (r_logits, r_cache) = _case(arch, dtype)
    logits, cache = model.prefill(torch.from_numpy(toks))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    assert cache["len"] == S
    assert rel(logits, r_logits) <= LOGIT_TOL[dtype]
    for key in ("dense", "moe"):
        for name in ("c_kv", "k_rope"):
            assert rel(cache[key][name], r_cache[key][name]) <= \
                CACHE_TOL[dtype], (key, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_four_decode_steps_match(arch):
    """The prefill's cache copied into one of S + 4 positions (the port
    raises on a full cache where the reference clamps), then 4 greedy
    ``decode_step``s fed the reference's tokens: logits and caches."""
    rcfg, cfg, params, model, toks, (r_logits, r_cache) = _case(arch,
                                                                "float32")
    _, cache = model.prefill(torch.from_numpy(toks))
    big = model.init_cache(B, S + 4)
    r_big = rt.init_cache(rcfg, B, S + 4)
    for key in ("dense", "moe"):
        for name in ("c_kv", "k_rope"):
            big[key][name][:, :, :S] = cache[key][name]
            r_big[key][name] = r_big[key][name].at[:, :, :S].set(
                r_cache[key][name])
    big["len"], r_big["len"] = S, jnp.asarray(S, jnp.int32)
    tok = np.asarray(r_logits[:, -1]).argmax(-1).astype(np.int32)[:, None]
    for _ in range(4):
        r_step, r_big = rt.decode_step(params, rcfg, jnp.asarray(tok), r_big)
        step, big = model.decode_step(torch.from_numpy(tok), big)
        assert tuple(step.shape) == (B, 1, cfg.vocab_size)
        assert rel(step, r_step) <= LOGIT_TOL["float32"]
        tok = np.asarray(r_step[:, -1]).argmax(-1).astype(np.int32)[:, None]
    assert big["len"] == S + 4
    for key in ("dense", "moe"):
        for name in ("c_kv", "k_rope"):
            assert rel(big[key][name], r_big[key][name]) <= \
                CACHE_TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_raises_on_a_full_cache(arch):
    _, _, _, model, toks, _ = _case(arch, "float32")
    _, cache = model.prefill(torch.from_numpy(toks))
    with pytest.raises(ValueError, match="cache is full"):
        model.decode_step(torch.from_numpy(toks[:, :1]), cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_api_entries_serve_on_the_cpu(arch):
    """``build_model``'s entries: init, prefill, init_cache, decode on the
    CPU at the test widths (seed weights); ``forward`` is the prefill's
    logits."""
    _, cfg = configs(arch)
    m = build_model(cfg)
    model = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(tokens(cfg))
    logits, cache = m.prefill(model, {"tokens": toks})
    full = m.init_cache(B, S + 1, device="cpu")
    for key in ("dense", "moe"):
        for name in ("c_kv", "k_rope"):
            full[key][name][:, :, :S] = cache[key][name]
    full["len"] = S
    step, full = m.decode(model, {"tokens": logits[:, -1:].argmax(-1)}, full)
    assert tuple(step.shape) == (B, 1, cfg.vocab_size) and full["len"] == S + 1
    assert torch.isfinite(step).all()
    torch.testing.assert_close(model(toks), logits)


def test_the_moe_family_is_a_serving_and_training_family():
    assert "moe" in api._SERVING and "moe" in api._TRAINING
    api.check_trainable(base.get_config("deepseek_v3_671b"))
