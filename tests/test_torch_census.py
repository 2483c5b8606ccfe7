"""The port's workload census (``launch/lowering.py``, ``launch/dryrun.py``)
and what reads it (``Campaign.from_artifacts``, ``dataset.build_dataset``),
against the reference and against closed forms, on the CPU.

* Full width, on the meta device (no card, no memory): the census's matmul
  flops EQUAL ``FlopCounterMode``'s (the artifact's ``cost``); for every
  dense prefill and train cell of stablelm-1.6b and qwen3-14b the total
  flops are within 3 % of ``features.analytic_counts`` less its
  input-embedding term (a gather, not a matmul); a decode's matmul flops
  EQUAL the closed form 2 B (the multiplying parameters) + 4 B L H hd S
  (scores and values over the whole cache).  K3 launches per cell: one a
  layer in prefill; a train step one forward and one backward a layer,
  plus one recomputed forward a layer under ``remat="dots"`` (qwen3).
* ``state_gb_per_device`` equals the reference's ``sharded_bytes_per_device``
  of ``jax.eval_shape`` of its parameters, optimizer state, batch and cache
  (``repro.launch.lowering``) on tiny configs: exactly.
* ``Campaign.from_artifacts`` on reference-format artifacts written inline
  gives the reference's workloads; ``build_dataset`` on ``pod1`` artifacts
  with a ``mesh`` is bitwise the reference's (X; labels 1e-15, as
  ``test_torch_predictors``); on ``card1`` artifacts (``dryrun.run_cell``)
  every point has mesh (1, 1).
* ``dryrun.reanalyze`` of an inline artifact with its gzipped HLO equals the
  one rebuilt from the reference's functions (``repro.core.hxa``,
  ``repro.launch.lowering.kernel_substitution``, ``repro.core.costmodel``;
  ``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` to 512
  host devices at import); ``sim`` within 1e-15 relative (the port cubes
  as ``x*x*x``).
* Refusals: the meta device outside the census, a multi-pod census.
"""

import dataclasses
import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.core import costmodel as rcostmodel
from repro.core import dataset as rdataset
from repro.core import hxa as rhxa
from repro.dse_campaign import runner as rrunner
from repro.dse_campaign.config import CampaignConfig as RCampaignConfig
from repro.dse_campaign.space import tiny_campaign_space as rtiny_space
from repro.hw import get_chip as rget_chip
from repro.launch import lowering as rlowering
from repro.models import api as rapi
from repro import optim as roptim
from repro_torch.configs import base
from repro_torch.core import dataset, features
from repro_torch.device import resolve_device
from repro_torch.dse_campaign import (Campaign, CampaignConfig,
                                      tiny_campaign_space)
from repro_torch.launch import dryrun, lowering
from repro_torch.launch import train as train_mod
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ssd_scan as k4

ANALYTIC_TOL = 0.03
SIM_TOL = 1e-15
DENSE_CELLS = [(a, s) for a in ("stablelm_1_6b", "qwen3_14b")
               for s in ("train_4k", "prefill_32k")]
DECODE_CELLS = [("stablelm_1_6b", "decode_32k"), ("qwen3_14b", "decode_32k")]

_ARTS = {}


def _art(arch: str, shape: str) -> dict:
    if (arch, shape) not in _ARTS:
        _ARTS[(arch, shape)] = lowering.lower_cell(base.get_config(arch),
                                                   base.SHAPES[shape])
    return _ARTS[(arch, shape)]


# --- full width, on meta ------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", DENSE_CELLS + DECODE_CELLS)
def test_matmul_flops_equal_flop_counter(arch, shape):
    a = _art(arch, shape)
    assert a["device"] == "meta"
    assert a["hxa"]["matmul_flops"] == a["cost"]["flops"] > 0
    assert a["roofline"]["n_chips"] == 1
    assert a["hxa"]["kernel_substitution"] == {"attn_bytes_saved_pd": 0.0,
                                               "ssm_bytes_saved_pd": 0.0}
    assert a["memory"]["per_device_peak_gb"] is None


@pytest.mark.parametrize("arch,shape", DENSE_CELLS)
def test_flops_within_3pct_of_analytic_counts(arch, shape):
    cfg, sh = base.get_config(arch), base.SHAPES[shape]
    a = _art(arch, shape)
    an = features.analytic_counts(cfg, sh, 1, 1)["an_flops_pd_t"] * 1e12
    mult = 6.0 if sh.kind == "train" else 2.0
    embedding = mult * cfg.vocab_size * cfg.d_model * sh.tokens
    want = an - embedding
    assert abs(a["hxa"]["flops"] - want) <= ANALYTIC_TOL * want
    launches = {k: v["launches"] for k, v in a["hxa"]["kernels"].items()}
    layers = cfg.num_layers
    if sh.kind == "prefill":
        assert launches == {k3.TC: layers}
    else:
        recompute = layers if cfg.remat == "dots" else 0
        assert launches == {k3.TC: layers + recompute, k3.BWD_BF16: layers}
    assert a["useful_flops_ratio"] == cfg.model_flops(sh) / a["hxa"]["flops"]


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_products_equal_closed_form(arch, shape):
    cfg, sh = base.get_config(arch), base.SHAPES[shape]
    b, s = sh.global_batch, sh.seq_len
    module = lowering.make_step(cfg, sh, "meta").args[0]
    multiplying = sum(p.numel() for n, p in module.named_parameters()
                      if p.dim() >= 2 and (n != "embed.embed_w"
                                           or module.head is None))
    attention = 2 * b * cfg.num_layers * cfg.num_heads * s * (
        cfg.head_dim + cfg.head_dim)
    a = _art(arch, shape)
    assert a["hxa"]["matmul_flops"] == 2 * b * multiplying + attention
    assert a["hxa"]["kernels"] == {}


def test_state_bytes_of_a_full_width_cell():
    """stablelm-1.6b prefill: parameters + int32 tokens, exactly."""
    cfg = base.get_config("stablelm_1_6b")
    a = _art("stablelm_1_6b", "prefill_32k")
    module = lowering.make_step(cfg, base.SHAPES["prefill_32k"],
                                "meta").args[0]
    params = sum(p.numel() * p.element_size() for p in module.parameters())
    assert a["memory"]["state_gb_per_device"] * 1e9 == pytest.approx(
        params + 4 * 32 * 32768, rel=1e-15)


# --- state bytes against the reference ------------------------------------------------


TINY = {"stablelm_1_6b": dict(num_layers=2, d_model=128, num_heads=2,
                              num_kv_heads=2, head_dim=64, d_ff=256,
                              vocab_size=256),
        "mamba2_130m": dict(num_layers=2, d_model=128, ssm_headdim=64,
                            ssm_state=64, ssm_chunk=64, vocab_size=256),
        # two sites of the shared block and a 1-layer tail
        "zamba2_1_2b": dict(num_layers=5, attn_every=2, d_model=128,
                            num_heads=2, num_kv_heads=2, head_dim=64,
                            d_ff=256, ssm_headdim=64, ssm_state=64,
                            ssm_chunk=64, vocab_size=256)}
STATE_CASES = [("stablelm_1_6b", "train"), ("stablelm_1_6b", "prefill"),
               ("stablelm_1_6b", "decode"), ("mamba2_130m", "prefill"),
               ("mamba2_130m", "decode"), ("zamba2_1_2b", "train"),
               ("zamba2_1_2b", "prefill"), ("zamba2_1_2b", "decode")]


def _reference_state_bytes(name: str, shape) -> float:
    rcfg = dataclasses.replace(rbase.get_config(name).reduced(), **TINY[name])
    model = rapi.build_model(rcfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    batch = rapi.input_specs(rcfg, shape, None)
    if shape.kind == "train":
        opt = jax.eval_shape(roptim.make_optimizer(rcfg.optimizer).init,
                             params)
        tree = (rapi.TrainState(params, opt), batch)
    elif shape.kind == "prefill":
        tree = (params, batch)
    else:
        tree = (params, batch, rapi.cache_specs(model, shape, None))
    return rlowering.sharded_bytes_per_device(tree)


@pytest.mark.parametrize("name,kind", STATE_CASES)
def test_state_bytes_equal_reference(name, kind):
    shape = base.ShapeConfig(f"tiny_{kind}", 64, 2, kind)
    rshape = rbase.ShapeConfig(f"tiny_{kind}", 64, 2, kind)
    cfg = dataclasses.replace(base.get_config(name).reduced(), **TINY[name])
    got = lowering.state_bytes(lowering.make_step(cfg, shape, "meta").resident)
    assert got == _reference_state_bytes(name, rshape)


# --- artifacts and datasets -------------------------------------------------------------


def _reference_format(arch, shape, pod, scale):
    return {"hxa": {"flops": 3.2e14 * scale, "hbm_bytes": 4.5e13 * scale,
                    "collective_bytes": 5e11 * scale,
                    "wire_bytes": 7e11 * scale},
            "roofline": {"n_chips": 512 if pod == "pod2" else 256},
            "memory": {"state_gb_per_device": 0.7 * scale},
            "mesh": "2x16x16" if pod == "pod2" else "16x16",
            "arch": arch, "shape": shape}


def _write(path, cells):
    for arch, shape, pod, scale in cells:
        (path / f"{arch}__{shape}__{pod}.json").write_text(json.dumps(
            _reference_format(arch, shape, pod, scale)))


CELLS = [("qwen3_14b", "train_4k", "pod1", 1.0),
         ("qwen3_14b", "train_4k", "pod2", 0.6),
         ("mamba2_130m", "decode_32k", "pod1", 0.03),
         ("stablelm_1_6b", "prefill_32k", "pod2", 0.2)]


def test_from_artifacts_gives_the_reference_workloads(tmp_path):
    _write(tmp_path, CELLS)
    got = Campaign.from_artifacts(str(tmp_path), CampaignConfig(
        space=tiny_campaign_space(), device="cpu")).workloads
    want = rrunner.Campaign.from_artifacts(str(tmp_path), RCampaignConfig(
        space=rtiny_space())).workloads
    assert [dataclasses.astuple(w) for w in got] == \
        [dataclasses.astuple(w) for w in want]
    assert ("qwen3_14b", "train_4k:pod2") in [(w.arch, w.shape) for w in got]
    with pytest.raises(FileNotFoundError):
        Campaign.from_artifacts(str(tmp_path / "none"), CampaignConfig(
            space=tiny_campaign_space(), device="cpu"))


@pytest.mark.parametrize("pod", ["pod1", "pod2"])
def test_build_dataset_with_mesh_is_bitwise_reference(tmp_path, pod):
    _write(tmp_path, CELLS)
    kw = dict(pod=pod, freq_points=3, mesh_counts=(16,), mesh_freq_points=2)
    X, yp, yc, meta = dataset.build_dataset(str(tmp_path), **kw)
    rX, ryp, ryc, rmeta = rdataset.build_dataset(str(tmp_path), **kw)
    assert len(X) > 20
    np.testing.assert_array_equal(X, rX)
    np.testing.assert_allclose(yp, ryp, rtol=1e-15, atol=0)
    np.testing.assert_allclose(yc, ryc, rtol=1e-15, atol=0)
    assert [tuple(m.mesh) for m in meta] == [tuple(m.mesh) for m in rmeta]


@pytest.fixture
def card1_dir(tmp_path, monkeypatch):
    """Two port artifacts written by ``dryrun.run_cell`` (meta, full
    width)."""
    monkeypatch.setenv("REPRO_ART_DIR", str(tmp_path))
    for arch, shape in (("stablelm_1_6b", "prefill_32k"),
                        ("mamba2_130m", "decode_32k")):
        dryrun.run_cell(arch, shape)
    return tmp_path


def test_card1_artifacts_feed_campaign_and_dataset(card1_dir):
    names = sorted(os.listdir(card1_dir))
    assert names == ["mamba2_130m__decode_32k__card1.json",
                     "stablelm_1_6b__prefill_32k__card1.json"]
    art = json.loads((card1_dir / names[1]).read_text())
    assert art["mesh"] == "1x1" and art["roofline"]["n_chips"] == 1
    assert art["hxa"]["collective_bytes"] == art["hxa"]["wire_bytes"] == 0.0
    wls = Campaign.from_artifacts(str(card1_dir), CampaignConfig(
        space=tiny_campaign_space(), device="cpu")).workloads
    assert [(w.arch, w.shape, w.base_chips) for w in wls] == [
        ("mamba2_130m", "decode_32k", 1), ("stablelm_1_6b", "prefill_32k", 1)]
    assert wls[1].base_analysis["flops"] == art["hxa"]["flops"]
    X, yp, yc, meta = dataset.build_dataset(str(card1_dir), pod="card1",
                                            mesh_counts=(), freq_points=4)
    assert len(X) and all(tuple(m.mesh) == (1, 1) and m.n_chips == 1
                          for m in meta)
    assert np.isfinite(yp).all() and (yc > 0).all()


def test_reanalyze_equals_reference_functions(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ART_DIR", str(tmp_path))
    rcfg = dataclasses.replace(rbase.get_config("stablelm_1_6b").reduced(),
                               **TINY["stablelm_1_6b"])
    model = rapi.build_model(rcfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32)}
    text = jax.jit(rapi.make_serve_step(model, "prefill", None)).lower(
        params, batch).compile().as_text()
    tag = "stablelm_1_6b__prefill_32k__pod1"
    art = {"arch": "stablelm_1_6b", "shape": "prefill_32k", "mesh": "16x16",
           "config": {"attn_impl": "pallas", "ssm_impl": "xla",
                      "remat": "none"},
           "roofline": {"n_chips": 256}, "model_flops": 1.5e13, "hxa": {}}
    (tmp_path / f"{tag}.json").write_text(json.dumps(art))
    os.makedirs(tmp_path / "hlo")
    with gzip.open(tmp_path / "hlo" / f"{tag}.hlo.gz", "wt") as f:
        f.write(text)
    got = dryrun.reanalyze(tag)
    assert json.loads((tmp_path / f"{tag}.json").read_text()) == got

    # the reference's reanalyze, from its functions
    analysis = rhxa.analyze_hlo_text(text)
    analysis["hbm_bytes_xla"] = analysis["hbm_bytes"]
    cfg = dataclasses.replace(rbase.get_config("stablelm_1_6b"),
                              attn_impl="pallas", ssm_impl="xla",
                              remat="none")
    subst = rlowering.kernel_substitution(cfg, rbase.SHAPES["prefill_32k"],
                                          256, 16)
    saved = subst["attn_bytes_saved_pd"] + subst["ssm_bytes_saved_pd"]
    assert saved > 0
    analysis["hbm_bytes"] = max(analysis["hbm_bytes"] - saved,
                                analysis["hbm_bytes"] * 0.05)
    analysis["kernel_substitution"] = subst
    chip = rget_chip()
    assert got["hxa"] == {k: analysis[k] for k in lowering.HXA_KEYS}
    assert got["roofline"] == rcostmodel.roofline_terms(analysis, chip, 256)
    want_sim = rcostmodel.simulate(analysis, chip, 256,
                                   mesh=(16, 16)).as_dict()
    assert set(got["sim"]) == set(want_sim)
    for k, v in want_sim.items():
        if isinstance(v, str):
            assert got["sim"][k] == v
        else:
            assert abs(got["sim"][k] - v) <= SIM_TOL * abs(v), k
    assert got["useful_flops_ratio"] == 1.5e13 / (analysis["flops"] * 256)


# --- the cells and the refusals -------------------------------------------------------


def test_applicable_and_skipped_cells():
    cells = set(dryrun.applicable_cells())
    dense = ("stablelm_1_6b", "qwen3_14b", "qwen2_72b", "granite_20b")
    assert cells - {(a, s) for a in ("deepseek_v3_671b", "deepseek_v2_236b")
                    for s in ("train_4k", "prefill_32k", "decode_32k")} == (
                     {(a, s) for a in dense
                      for s in ("train_4k", "prefill_32k", "decode_32k")}
                     | {(a, s) for a in ("mamba2_130m", "zamba2_1_2b")
                        for s in ("train_4k", "prefill_32k", "decode_32k",
                                  "long_500k")}
                     | {(a, s) for a in ("whisper_small", "paligemma_3b")
                        for s in ("train_4k", "prefill_32k", "decode_32k")})
    deepseek = {(a, s) for a in ("deepseek_v3_671b", "deepseek_v2_236b")
                for s in ("train_4k", "prefill_32k", "decode_32k")}
    assert deepseek <= cells
    assert len(cells) == 32
    skipped = {(a, s): why for a, s, why in dryrun.skipped_cells()}
    assert len(skipped) == 1
    assert ("resnet50", "-") in skipped
    assert not cells & set(skipped)


def test_mamba2_train_cell_books_the_scan_and_its_backward():
    """mamba2 x train_4k, traced on meta at full width and depth (B = 256,
    S = 4096): every layer's scan on K4 twice (the forward, and its
    recomputation under remat "dots") and K4's backward once, each entry
    the kernels' own census work."""
    cfg = base.get_config("mamba2_130m")
    art = dryrun.run_cell("mamba2_130m", "train_4k", save=False)
    kern = art["hxa"]["kernels"]
    assert set(kern) == {"ssd_scan_bf16", "ssd_scan_bwd_bf16"}
    layers = cfg.num_layers
    assert kern["ssd_scan_bf16"]["launches"] == 2 * layers
    assert kern["ssd_scan_bwd_bf16"]["launches"] == layers
    shape = (256, 4096, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
             cfg.ssm_chunk)
    flops, nbytes = k4.census_work_bwd(*shape, torch.bfloat16, False)
    assert kern["ssd_scan_bwd_bf16"]["flops"] == layers * flops
    assert kern["ssd_scan_bwd_bf16"]["bytes"] == layers * nbytes
    assert art["model_flops"] > 0 and art["useful_flops_ratio"] > 0


def test_zamba2_train_cell_books_both_kernels_and_their_backwards():
    """zamba2 x train_4k, traced on meta at full width and depth (B = 256,
    S = 4096): every layer's scan on K4 twice (remat "dots" recomputes it)
    and its backward once; the shared block's attention on K3 (its
    ``_lse`` instance) and K3's backward once a site -- the shared block
    runs outside remat, as the reference's."""
    cfg = base.get_config("zamba2_1_2b")
    art = dryrun.run_cell("zamba2_1_2b", "train_4k", save=False)
    kern = art["hxa"]["kernels"]
    layers, sites = cfg.num_layers, cfg.num_layers // cfg.attn_every
    assert {k: v["launches"] for k, v in kern.items()} == {
        "ssd_scan_bf16": 2 * layers, "ssd_scan_bwd_bf16": layers,
        k3.TC: sites, k3.BWD_BF16: sites}
    shape = (256, 4096, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
             cfg.ssm_chunk)
    flops, nbytes = k4.census_work_bwd(*shape, torch.bfloat16, False)
    assert kern["ssd_scan_bwd_bf16"]["flops"] == layers * flops
    assert kern["ssd_scan_bwd_bf16"]["bytes"] == layers * nbytes
    assert art["model_flops"] > 0 and art["useful_flops_ratio"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_paligemma_cells_book_k3_with_the_prefix(shape):
    """paligemma-3b's three cells, traced on meta at full width and depth
    (18 layers, 8 heads of 256, one kv head, 256 patches): K3 once a layer
    over patches + text with the 256 patches' bidirectional prefix, each
    entry K3's own census work with the prefix's pairs -- at head dim 256
    the ``wgmma`` forward and backward; a train step under
    remat "dots" runs the forward (with its log-sum-exp) twice a layer (the
    checkpoint recomputes it) and the backward once; nothing in decode."""
    cfg = base.get_config("paligemma_3b")
    sh = base.SHAPES[shape]
    art = dryrun.run_cell("paligemma_3b", shape, save=False)
    kern = art["hxa"]["kernels"]
    assert art["model_flops"] > 0 and art["useful_flops_ratio"] > 0
    if sh.kind == "decode":
        assert kern == {}
        return
    b, s, n, p = sh.global_batch, sh.seq_len, cfg.num_layers, \
        cfg.num_patches
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    train = sh.kind == "train"
    passes = 2 if train else 1
    fwd = k3.fwd_work(b, s, h, kv, hd, hd, True, torch.bfloat16, lse=train,
                      prefix=p)
    assert fwd[0] == 4 * hd * b * h * (s * (s + 1) // 2 + p * (p - 1) // 2)
    want = {k3.TC: {"launches": float(passes * n),
                     "flops": float(passes * n * fwd[0]),
                     "bytes": float(passes * n * fwd[1])}}
    if train:
        bwd = k3.bwd_work(b, s, h, kv, hd, hd, True, torch.bfloat16,
                          prefix=p)
        want[k3.BWD_BF16] = {"launches": float(n),
                             "flops": float(n * bwd[0]),
                             "bytes": float(n * bwd[1])}
    assert kern == want


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_whisper_cells_book_every_attention_on_k3(shape):
    """whisper-small's three cells, traced on meta at full width and depth:
    K3 once an encoder layer (the 1500 frames, not causal), once a decoder
    layer's self attention (causal) and once its cross attention (the
    decoder's S queries over the 1500 frames' keys), each entry K3's own
    census work -- the forward with its log-sum-exp and the backward once
    each in a train step (remat "none"); nothing in decode."""
    cfg = base.get_config("whisper_small")
    sh = base.SHAPES[shape]
    art = dryrun.run_cell("whisper_small", shape, save=False)
    kern = art["hxa"]["kernels"]
    assert art["model_flops"] > 0 and art["useful_flops_ratio"] > 0
    if sh.kind == "decode":
        assert kern == {}
        return
    b, s, f = sh.global_batch, sh.seq_len, cfg.num_frames
    h, kv, hd, n = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_layers
    train = sh.kind == "train"
    calls = ([(f, f, False)] * cfg.encoder_layers
             + [(s, s, True), (s, f, False)] * n)
    fwd = [k3.fwd_work(b, sq, h, kv, hd, hd, causal, torch.bfloat16,
                       lse=train, sk=sk) for sq, sk, causal in calls]
    want = {k3.TC: {"launches": float(len(calls)),
                    "flops": float(sum(w[0] for w in fwd)),
                    "bytes": float(sum(w[1] for w in fwd))}}
    if train:
        bwd = [k3.bwd_work(b, sq, h, kv, hd, hd, causal, torch.bfloat16,
                           sk=sk) for sq, sk, causal in calls]
        want[k3.BWD_BF16] = {"launches": float(len(calls)),
                             "flops": float(sum(w[0] for w in bwd)),
                             "bytes": float(sum(w[1] for w in bwd))}
    assert kern == want


def test_all_names_every_skipped_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_ART_DIR", str(tmp_path))
    monkeypatch.setattr(dryrun, "applicable_cells",
                        lambda: iter([("mamba2_130m", "long_500k")]))
    dryrun.main(["--all"])
    out = capsys.readouterr().out
    for arch, shape, why in dryrun.skipped_cells():
        assert f"[dryrun] skip {arch} x {shape}: {why}" in out
    assert os.listdir(tmp_path) == ["mamba2_130m__long_500k__card1.json"]


def test_multi_pod_raises_naming_item_12e():
    with pytest.raises(NotImplementedError, match="item 12e"):
        dryrun.run_cell("stablelm_1_6b", "prefill_32k", multi_pod=True,
                        save=False)
    with pytest.raises(NotImplementedError, match="item 12e"):
        dryrun.main(["--all", "--multi-pod"])


def test_meta_is_refused_outside_the_census():
    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="meta"):
        CampaignConfig(space=tiny_campaign_space(), device="meta")
    with pytest.raises(ValueError, match="meta"):
        train_mod.train("stablelm-1.6b", steps=1, device="meta")
    module = lowering.make_step(
        dataclasses.replace(base.get_config("stablelm_1_6b").reduced(),
                            **TINY["stablelm_1_6b"]),
        base.ShapeConfig("t", 16, 1, "prefill"), "meta").args[0]
    assert all(p.device.type == "meta" for p in module.parameters())
    assert isinstance(next(module.parameters()), torch.nn.Parameter)
