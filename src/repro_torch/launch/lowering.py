"""One (arch, shape) cell traced to its census and priced (the reference's
``launch/lowering.py``).

The reference lowers the jitted step on 512 placeholder devices, compiles
it and parses the HLO text with HxA.  The port has no compiler IR and no
mesh: ``lower_cell`` builds the model and the step's inputs on ``device``
-- the meta device by default, where nothing is drawn, computed or
allocated -- and traces the port's own step op by op with
``hxa.analyze_step``; the hand-written kernels book their own entries.  The
result carries the reference's artifact keys:

  config   -- the cell's ``ArchConfig``
  memory   -- ``state_gb_per_device``: the exact bytes of parameters,
              optimizer state, cache and batch (the reference's
              ``sharded_bytes_per_device`` at one device); the XLA-only
              fields are None; ``per_device_peak_gb`` is
              ``torch.cuda.max_memory_allocated`` when traced on the card
  cost     -- ``FlopCounterMode``'s reading, torch's own counter (the
              analogue of XLA's ``cost_analysis``): the aten matmuls only;
              it does not see the hand-written kernels
  hxa      -- the census (per device, one device); ``kernel_substitution``
              is recorded as zeros, because the census already counts the
              kernels' own traffic (the reference subtracts the XLA
              fallback's score blocks analytically, the port never has them)
  roofline -- ``costmodel.roofline_terms`` at 1 chip
  sim      -- ``costmodel.simulate`` at 1 chip, mesh (1, 1)
  model_flops, useful_flops_ratio

Pricing uses the reference's chip table (``chip_name``, default
``tpu-v5e``), as the reference does: the census is the port's, the chip it
is priced on is the design space's.  The step reads nothing back to the
host (the cache length is a Python int, the loss metrics stay tensors),
so the same trace runs on the meta device and on the card; a decode cell
traces one step at the last position of a cache of ``seq_len`` positions.

``_COERCE``, ``apply_overrides`` and ``kernel_substitution`` are the
reference's, kept for ``dryrun.reanalyze`` of reference artifacts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import optim
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import costmodel, hxa
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hw import get_chip
from repro_torch.models import api, layers

_COERCE = {
    "remat": str, "capacity_factor": float, "optimizer": str, "dtype": str,
    "ssm_chunk": int, "attn_type": str, "attn_impl": str, "ssm_impl": str,
    "cache_layout": str,
}

# the census keys an artifact's ``hxa`` holds
HXA_KEYS = ("flops", "hbm_bytes", "hbm_bytes_xla", "collective_bytes",
            "wire_bytes", "op_counts", "hbm_by_opcode", "collectives", "loops",
            "n_computations", "kernel_substitution")


def kernel_substitution(cfg: ArchConfig, shape: ShapeConfig, n_chips: int,
                        mesh_model: int) -> Dict[str, float]:
    """Analytic HBM-traffic delta of Pallas kernelization.

    The XLA fallback materializes fp32 attention-score / SSD-decay blocks in
    HBM every chunk; the fused Pallas kernels (kernels/flash_attention.py,
    kernels/ssd_scan.py) keep them in VMEM.  The dry-run cannot lower TPU
    pallas_call on the CPU backend, so kernelized cells substitute the
    score-block traffic analytically (documented in EXPERIMENTS.md §Perf).
    Returns bytes saved per device (>= 0).
    """
    saved = 0.0
    if shape.kind == "decode":
        return {"attn_bytes_saved_pd": 0.0, "ssm_bytes_saved_pd": 0.0}
    passes = 3.0 if shape.kind == "train" else 1.0   # fwd + bwd(recompute+grads)
    touches = 5.0                                     # s write/read, p write/read, d(p)
    if cfg.attn_impl == "pallas" and cfg.attn_type != "none" and cfg.num_heads:
        causal_pairs = shape.seq_len * shape.seq_len / 2.0
        heads = cfg.num_heads
        layers = cfg.num_layers + cfg.encoder_layers
        total = (causal_pairs * heads * layers * shape.global_batch
                 * 4.0 * touches * passes)
        saved_attn = total / n_chips
    else:
        saved_attn = 0.0
    if cfg.ssm_impl == "pallas" and cfg.ssm_state:
        Q = cfg.ssm_chunk
        nc = shape.seq_len // max(Q, 1)
        blocks = nc * Q * Q * cfg.ssm_nheads * shape.global_batch
        saved_ssm = blocks * 4.0 * touches * passes * cfg.num_layers / n_chips
    else:
        saved_ssm = 0.0
    return {"attn_bytes_saved_pd": saved_attn, "ssm_bytes_saved_pd": saved_ssm}


def apply_overrides(cfg: ArchConfig, overrides: Dict[str, str]) -> ArchConfig:
    if not overrides:
        return cfg
    kw = {}
    for k, v in overrides.items():
        field_types = {f.name: f.type for f in dataclasses.fields(cfg)}
        if k not in field_types:
            raise KeyError(f"unknown config field {k}")
        coerce = _COERCE.get(k)
        if coerce is None:
            cur = getattr(cfg, k)
            coerce = type(cur) if cur is not None else str
            if coerce is bool:
                v = v.lower() in ("1", "true", "yes")
                kw[k] = v
                continue
        kw[k] = coerce(v)
    return dataclasses.replace(cfg, **kw)


def state_bytes(tree) -> int:
    """Exact bytes of the tensors in ``tree`` (modules, mappings, sequences,
    named tuples), each counted once; a Python int counter (an optimizer's
    ``step``, a cache's ``len``) counts as the reference's int32 scalar."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.nn.Module):
            for t in x.parameters():
                walk(t)
        elif isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, int):
            total += 4

    walk(tree)
    return total


class Step(NamedTuple):
    """A cell's step ready to run: ``fn(*args)``; ``resident`` is what stays
    in memory across steps (the reference's: parameters or the train state,
    the batch, and a decode cell's cache)."""
    fn: Callable
    args: Tuple[Any, ...]
    resident: Tuple[Any, ...]


def make_step(cfg: ArchConfig, shape: ShapeConfig,
              device: DeviceLike = "meta") -> Step:
    """The step of one cell on ``device`` (the meta device, the card or the
    CPU): the model from ``Model.init(max_seq=S)`` (seed-0 weights; none on
    meta) and the reference's inputs -- int32 tokens [B, S] (and labels)
    for train and prefill, [B, 1] for decode; the audio family's frames [B,
    num_frames, d] in the model dtype for train and prefill; the VLM
    family's S - num_patches text tokens (and labels) after its patch
    embeddings [B, num_patches, d] in the model dtype for train and prefill
    (the reference's ``input_specs``).  train: a fresh
    ``TrainState`` with the config's optimizer
    (``optim.make_optimizer(cfg.optimizer)``) and one ``make_train_step``
    call; prefill: ``Model.prefill``; decode: one ``Model.decode`` against
    ``init_cache(B, S)`` (whisper's with its cross part) at position
    S - 1."""
    dev = resolve_device(device, allow_meta=True)
    model = api.build_model(cfg)
    b, s = shape.global_batch, shape.seq_len
    extra, text = {}, s
    if cfg.family == "audio" and shape.kind != "decode":
        extra["frames"] = torch.zeros((b, cfg.num_frames, cfg.d_model),
                                      dtype=layers.dtype_of(cfg), device=dev)
    if cfg.family == "vlm" and shape.kind != "decode":
        text = s - cfg.num_patches
        extra["prefix_embeds"] = torch.zeros(
            (b, cfg.num_patches, cfg.d_model), dtype=layers.dtype_of(cfg),
            device=dev)
    if shape.kind == "train":
        api.check_trainable(cfg)
        optimizer = optim.make_optimizer(cfg.optimizer)
        state = api.init_train_state(model.init(device=dev, max_seq=s),
                                     optimizer)
        tokens = torch.zeros((b, text), dtype=torch.int32, device=dev)
        batch = {"tokens": tokens, "labels": tokens.clone(), **extra}
        return Step(api.make_train_step(model, optimizer), (state, batch),
                    (state.params, state.opt, batch))
    if model.prefill is None:
        raise NotImplementedError(f"{cfg.name} has no serving step")
    module = model.init(device=dev, max_seq=s)
    if shape.kind == "prefill":
        batch = {"tokens": torch.zeros((b, text), dtype=torch.int32,
                                       device=dev), **extra}
        return Step(model.prefill, (module, batch), (module, batch))
    batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32, device=dev)}
    cache = model.init_cache(b, s, device=dev)
    cache["len"] = s - 1
    return Step(model.decode, (module, batch, cache), (module, batch, cache))


def trace(step: Step) -> Tuple[Dict, Dict]:
    """(census, cost) of one run of ``step``: ``hxa.analyze_step`` and, in
    the same run, ``FlopCounterMode``'s total (aten matmuls only)."""
    with FlopCounterMode(display=False) as counter:
        analysis = hxa.analyze_step(step.fn, *step.args)
    return analysis, {"flops": float(counter.get_total_flops()),
                      "bytes_accessed": None}


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, *,
               device: DeviceLike = "meta", chip_name: str = "tpu-v5e",
               overrides: Optional[Dict[str, str]] = None) -> Dict:
    """The cell's artifact (keys: the module docstring), traced on
    ``device``."""
    cfg = apply_overrides(cfg, overrides or {})
    dev = resolve_device(device, allow_meta=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step = make_step(cfg, shape, dev)
    analysis, cost = trace(step)
    analysis["hbm_bytes_xla"] = analysis["hbm_bytes"]
    analysis["kernel_substitution"] = {"attn_bytes_saved_pd": 0.0,
                                       "ssm_bytes_saved_pd": 0.0}
    chip = get_chip(chip_name)
    roof = costmodel.roofline_terms(analysis, chip, 1)
    sim = costmodel.simulate(analysis, chip, 1, mesh=(1, 1))
    mf = cfg.model_flops(shape)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    memory = {k: None for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes", "peak_memory_in_bytes",
        "per_device_total_gb")}
    memory["per_device_peak_gb"] = peak
    memory["state_gb_per_device"] = state_bytes(step.resident) / 1e9
    return {
        "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if not k.startswith("_")},
        "memory": memory,
        "cost": cost,
        "hxa": {k: analysis[k] for k in HXA_KEYS + ("matmul_flops",
                                                    "kernels")},
        "roofline": roof,
        "sim": sim.as_dict(),
        "model_flops": mf,
        "useful_flops_ratio": (mf / analysis["flops"]
                               if analysis["flops"] else 0.0),
        "device": dev.type,
    }
