"""The port's token ``ServingEngine`` (``repro_torch.serving.engine``)
against the reference's (``repro.serving.engine``) on the CPU.

The reduced stablelm-1.6b, mamba2-130m and zamba2-1.2b (``cfg.reduced()``:
2 layers -- zamba's one site of its shared block after them -- d_model 64,
vocab 256) in float32, with the reference's ``init_params``
weights carried over by ``params_from_reference``, serve the same seeded
requests through both engines: 2 slots, 4 requests, so a freed slot is
reused and inherits its old cache rows.  Gate: every request's
``tokens_out`` equal, token for token (greedy argmax over float32 logits
that agree to ~1e-6 relative; ties would go to the first index in both).
``max_len`` covers the run's total decode steps, since every prompt token
is a full [slots, 1] decode on the one shared cache position: the
reference clamps a full cache, the port raises (tested below).  The
reference's own engine tests are ported on the port alone, and
``launch/serve.serve`` runs on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import api as rapi
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch.configs import base
from repro_torch.launch.serve import serve
from repro_torch.models import mamba as tm
from repro_torch.models import transformer as tt
from repro_torch.models import zamba as tz
from repro_torch.models.api import build_model
from repro_torch.serving import Request, ServingEngine

ARCHS = {"stablelm_1_6b": tt, "mamba2_130m": tm, "zamba2_1_2b": tz}
SLOTS, N_REQ, MAX_NEW, MAX_LEN = 2, 4, 5, 64


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), tree)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, rng.integers(3, 10)).astype(np.int32)
            for _ in range(N_REQ)]


def _run(engine, prompts, max_new=MAX_NEW, req=Request):
    reqs = [req(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    stats = engine.run_until_drained()
    return reqs, stats


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_matches_reference_engine(arch):
    """Same weights, same requests: the port's engine emits the
    reference's tokens for every request, through a reused slot."""
    rcfg = dataclasses.replace(rbase.get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(base.get_config(arch).reduced(),
                              dtype="float32")
    rmodel = rapi.build_model(rcfg)
    params = rmodel.init(jax.random.PRNGKey(3), max_seq=MAX_LEN)
    module = ARCHS[arch].params_from_reference(_numpy_tree(params), cfg,
                                               device="cpu")
    prompts = _prompts()

    ref = RServingEngine(rmodel, slots=SLOTS, max_len=MAX_LEN)
    ref.load(params)
    want, want_stats = _run(ref, prompts, req=RRequest)
    eng = ServingEngine(build_model(cfg), slots=SLOTS, max_len=MAX_LEN,
                        device="cpu")
    eng.load(module)
    got, stats = _run(eng, prompts)

    assert all(r.done for r in got)
    assert [r.tokens_out for r in got] == [r.tokens_out for r in want]
    assert stats["decoded_tokens"] == want_stats["decoded_tokens"]
    assert list(eng.slot_len) == list(ref.slot_len)
    # every prompt token and every step was one decode of the shared cache,
    # and the reference never had to clamp
    assert eng.cache["len"] == int(ref.cache["len"]) < MAX_LEN


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_completes_requests(arch):
    """The reference's ``test_engine_completes_requests``, on the port."""
    cfg = base.get_config(arch).reduced()
    model = build_model(cfg)
    module = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(model, slots=2, max_len=64, device="cpu")
    eng.load(module)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, 4)
                    .astype(np.int32), max_new_tokens=5) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(len(r.tokens_out) == 5 for r in reqs)
    # first token of each request comes from prefill; 4 more via step()
    assert stats["decoded_tokens"] >= 4 * 4
    assert all(r.finished_s >= r.first_token_s >= r.arrived_s for r in reqs)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_matches_direct_decode(arch):
    """The reference's ``test_engine_matches_direct_decode``, on the port:
    greedy tokens from the engine == a plain per-token decode loop."""
    cfg = base.get_config(arch).reduced()
    model = build_model(cfg)
    module = model.init(torch.Generator().manual_seed(1), device="cpu")
    prompt = np.asarray([3, 5, 7], np.int32)

    eng = ServingEngine(model, slots=1, max_len=32, device="cpu")
    eng.load(module)
    req = Request(rid=0, prompt=prompt, max_new_tokens=4)
    eng.submit(req)
    eng.run_until_drained()

    cache = model.init_cache(1, 32, device="cpu")
    for t in prompt:
        logits, cache = model.decode(
            module, {"tokens": torch.tensor([[t]], dtype=torch.int32)}, cache)
    toks = [int(np.argmax(logits[0, -1].numpy()))]
    for _ in range(3):
        logits, cache = model.decode(
            module, {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32)},
            cache)
        toks.append(int(np.argmax(logits[0, -1].numpy())))
    assert req.tokens_out == toks


def test_engine_raises_where_the_reference_clamps_a_full_cache():
    """Two 4-token requests through one slot with ``max_len`` 8: the
    second request's first decode would write past the shared position's
    end.  The reference clamps the write and completes; the port raises."""
    arch = "stablelm_1_6b"
    rcfg = rbase.get_config(arch).reduced()
    rmodel = rapi.build_model(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0), max_seq=8)
    prompts = [np.asarray([3, 5, 7, 9], np.int32)] * 2
    ref = RServingEngine(rmodel, slots=1, max_len=8)
    ref.load(params)
    reqs, _ = _run(ref, prompts, max_new=16, req=RRequest)
    assert all(r.done for r in reqs)

    cfg = base.get_config(arch).reduced()
    module = tt.params_from_reference(_numpy_tree(params), cfg, device="cpu")
    eng = ServingEngine(build_model(cfg), slots=1, max_len=8, device="cpu")
    eng.load(module)
    with pytest.raises(ValueError, match="cache is full"):
        _run(eng, prompts, max_new=16)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_completes_on_the_cpu(arch):
    reqs, stats = serve(arch, device="cpu")
    assert stats["completed"] == len(reqs) == 8
    assert all(len(r.tokens_out) == 16 for r in reqs)
    assert stats["decoded_tokens"] > 0 and stats["mean_latency_s"] > 0


def test_engine_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(base.get_config("stablelm_1_6b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="cuda"):
        serve("stablelm_1_6b")


def test_engine_refuses_a_module_on_another_device():
    model = build_model(base.get_config("stablelm_1_6b").reduced())
    module = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(model, device="cpu")
    eng.device = torch.device("meta")
    with pytest.raises(ValueError, match="lies on"):
        eng.load(module)
