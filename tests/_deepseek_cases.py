"""Shared set-up of the deepseek (MoE family) parity tests: the configs at
the real attention head dims and narrow everything else, the reference's
``init_params`` weights made to matter, and the port's model holding them.

Widths: d_model 64, 2 heads with MLA's real head dims (nope 128, rope 64,
v 128: the pair (192, 128) that K3 takes on the card; ``cfg.reduced()``'s
hd 24 / hv 16 is a pair the kernel refuses), q_lora / kv_lora 32, 8 routed
experts top-2 of width 32, one shared expert, the first layer dense (d_ff
64), 3 layers (1 dense + 2 MoE), vocab 256, v3's MTP head of depth 1.  The
router is redrawn at scale 0.5 (the init's 0.006 routes every token almost
uniformly), v3's ``router_bias`` at random (so that it moves the selection
and not the weights), and norm scales in [0.5, 1.5], so that each of them
matters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as rbase
from repro.models import transformer as rt
from repro_torch.configs import base
from repro_torch.models import layers as L
from repro_torch.models import transformer as tt

ARCHS = ("deepseek_v2_236b", "deepseek_v3_671b")
TEST_WIDTHS = dict(num_layers=3, d_model=64, num_heads=2, num_kv_heads=2,
                   d_ff=64, vocab_size=256, head_dim=192, q_lora_rank=32,
                   kv_lora_rank=32, qk_nope_head_dim=128,
                   qk_rope_head_dim=64, v_head_dim=128, num_experts=8,
                   experts_per_token=2, moe_d_ff=32, first_k_dense=1,
                   num_shared_experts=1)
B, S = 2, 16


def configs(arch: str, dtype: str = "float32", **kw):
    """(reference cfg, port cfg) of ``arch`` at the test widths."""
    kw = {**TEST_WIDTHS, "dtype": dtype, **kw}
    rcfg = dataclasses.replace(rbase.get_config(arch), **kw)
    cfg = dataclasses.replace(base.get_config(arch), **kw)
    if cfg.mtp_depth:
        rcfg = dataclasses.replace(rcfg, mtp_depth=1)
        cfg = dataclasses.replace(cfg, mtp_depth=1)
    return rcfg, cfg


def randomize(tree, rng):
    """Norm scales in [0.5, 1.5], the router at scale 0.5, the router bias
    normal(0, 0.3) -- each leaf kept in its dtype and shape."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
        elif k == "scale":
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32), v.dtype)
        elif k == "router":
            out[k] = jnp.asarray(rng.normal(0, 0.5, v.shape)
                                 .astype(np.float32), v.dtype)
        elif k == "router_bias":
            out[k] = jnp.asarray(rng.normal(0, 0.3, v.shape)
                                 .astype(np.float32), v.dtype)
        else:
            out[k] = v
    return out


def numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), tree)


def reference_params(rcfg, seed: int = 0):
    return randomize(rt.init_params(jax.random.PRNGKey(seed), rcfg),
                     np.random.default_rng(seed + 1))


def port_model(params, cfg) -> tt.Transformer:
    return tt.params_from_reference(numpy_tree(params), cfg, device="cpu")


def tokens(cfg, seed: int = 2, b: int = B, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def rel(got, want) -> float:
    """max |got - want| / max |want| (a tensor or array against a jax or
    numpy array)."""
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def flat_reference(tree) -> dict:
    """{path "a/b/c": float32 array} of a reference tree."""
    out = {}

    def walk(node, pre):
        for k, v in node.items():
            path = f"{pre}/{k}" if pre else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                out[path] = np.asarray(jnp.asarray(v).astype(jnp.float32))

    walk(tree, "")
    return out


def reference_leaf(flat: dict, name: str) -> np.ndarray:
    """The reference's value of the port's parameter ``name`` (its layer of
    a stacked leaf)."""
    path, layer = L.reference_key(name)
    return flat[path] if layer is None else flat[path][layer]
