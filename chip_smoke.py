#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`:

    python3 chip_smoke.py [--seed 0] [--large-freq-points 25600]

It builds the hand-written kernels from `src/repro_torch/kernels/csrc/` (one
`nvcc` per source, all five started together), holds each against its plain
PyTorch version on the card, and drives the port's main paths: training the
dense transformer (stablelm-1.6b at full width and depth through
`launch.train.train`, every layer's attention on K3 and its hand-written
backward), the fused
campaign sweep through `Campaign.run`, the paper's predictors (dataset,
k-fold, the forest walk and KNN on the card), the `"fast"` campaign tier
and the surrogate-guided `AdaptiveCampaign`, the accelerator-selection
serving layer (`FrontierIndex`, `SelectionEngine`: index hits, novel queries
on the fused kernel, the predictor paths), the distributed campaign layer
(`spawn` fabric workers on the one card, fault injection, respawn, the
distributed adaptive campaign, a chaos policy, 1 / 2 / 4 workers), ResNet-50
inference through
`build_model(get_config("resnet50")).init(...)`, dense-transformer serving
(prefill, KV cache, greedy decode) of stablelm-1.6b and a depth-cut
qwen3-14b, and mamba2-130m serving (chunked prefill on the SSD scan kernel,
recurrent greedy decode), each through `build_model(get_config(...))`,
and the token `ServingEngine` over full-width stablelm-1.6b and mamba2-130m.
Every phase prints one JSON object on a line of its own; any failed phase
raises, so the exit code is non-zero and the last line is missing.  Without
a CUDA device the script exits non-zero before printing anything.

Lines, in order:
  {"phase": "device", ...}           card, power limit, torch / CUDA versions
  {"phase": "build", ...}            seconds nvcc took, ptxas register report
  {"phase": "flash_attention", ...}  K3 vs plain: test, ragged, model
                                     shapes, other scales; plans
  {"phase": "ssd_scan", ...}         K4 vs plain: test, shared_cb and
                                     mamba2 shapes, views; plans, cum
  {"phase": "training", ...}         (a) stablelm-1.6b bf16 B=1 S=4096, 4
                                     steps: ms / step, tokens/s, device ms
                                     by kind, idle, peak memory, K3
                                     launches; (b) float32 depth 2 card vs
                                     CPU; (c) resume == fresh bitwise; (d)
                                     K3 backward vs plain, SDPA's backward
  {"phase": "kernels", ...}          fused K1 vs plain per case (bitwise,
                                     twice), plans, K1 / K1a vs plain,
                                     timings of the fused tile and the
                                     old chain, K1b
  {"phase": "campaign_default", ...} 125,440-candidate campaign, three tiers
  {"phase": "campaign_resume", ...}  checkpoint / resume == fresh
  {"phase": "campaign_large", ...}   ~10M-candidate campaign, float32
  {"phase": "predictors", ...}       dataset, k-fold MAPE / R^2 (synthetic
                                     census), forest walk and KNN card vs
                                     CPU, fast-path pick card vs CPU
  {"phase": "campaign_fast", ...}    the "fast" tier over the default space
  {"phase": "adaptive", ...}         AdaptiveCampaign card vs CPU, resume
  {"phase": "selection", ...}        FrontierIndex + SelectionEngine: index
                                     hits, a novel query over the whole
                                     space (one fused launch, W=1 x
                                     N=125,440), a one-launch flush of six,
                                     predictor paths, card vs CPU; fused K1
                                     vs plain at W 1 / 6 / 12 x N 4096 /
                                     125,440
  {"phase": "fabric", ...}           spawn workers on the card: faults at 2
                                     workers (float64), float32, respawn,
                                     distributed adaptive, chaos (all
                                     bitwise the single-process runs);
                                     1 / 2 / 4 workers over ~1 M candidates
  {"phase": "conv2d", ...}           K2 vs plain: ResNet-50 shapes at B=1,
                                     8, 32, test and ragged shapes, plans
  {"phase": "resnet50", ...}         inference at B=1, 32 (bf16), 8 (f32)
  {"phase": "transformer", ...}      prefill + decode: stablelm, qwen3 (L=4)
  {"phase": "mamba2", ...}           prefill + decode: mamba2-130m, f32 (L=4)
  {"phase": "token_serving", ...}    ServingEngine: stablelm-1.6b bf16 (4
                                     slots, 8 requests), mamba2-130m; engine
                                     == a direct decode loop
  {"phase": "total", ...}            seconds the whole script took
  {"kernels": [...]}                 one entry per kernel: times, bound, launches
  <name>, <power limit>              as nvidia-smi prints them
  {"ok": true, "device": {...}}      the last line

It imports nothing of `jax` or of the reference package `repro`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import (costmodel, dataset, dse,  # noqa: E402
                              features, predictors)
from repro_torch.dse_campaign import (AdaptiveCampaign,  # noqa: E402
                                      AdaptiveConfig, Campaign,
                                      CampaignConfig, ChaosPolicy,
                                      ChaosRunner, DEFAULT_VARIANTS,
                                      FaultInjection, MultiprocessFabric,
                                      SpaceSpec, StreamingFrontier,
                                      TileEvaluator, canonical_frontier,
                                      default_campaign_space,
                                      frontiers_identical, hypervolume_2d,
                                      run_adaptive_distributed,
                                      run_distributed, store, tile_span)
from repro_torch.dse_campaign.fabric import (  # noqa: E402
    _expand_intervals, worker_launches)
from repro_torch.runtime.fault_tolerance import RetryPolicy  # noqa: E402
from repro_torch.hw import CHIPS, get_chip  # noqa: E402
from repro_torch.configs.base import (SHAPES, ShapeConfig,  # noqa: E402
                                      get_config)
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import conv2d as k2  # noqa: E402
from repro_torch.kernels import dse_sweep as kern  # noqa: E402
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.checkpoint import store as ckpt_store  # noqa: E402
from repro_torch.select import FrontierIndex, SelectionEngine  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.telemetry import Telemetry, metric_value  # noqa: E402

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/dse_sweep.cu"
CONV_SOURCE = "src/repro_torch/kernels/csrc/conv2d.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
# file:line of what each kernel replaces in the reference package
REPLACES = {"sweep_reduce": "src/repro/kernels/dse_sweep.py:52",
            "dse_sweep": "src/repro/kernels/dse_sweep.py:52",
            "screen_rows": "src/repro/core/costmodel.py:486",
            "conv2d": "src/repro/kernels/conv2d.py:21",
            "flash_attention": "src/repro/kernels/flash_attention.py:25",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:24"}

# Published peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of device
# memory; 67 TFLOP/s float32 outside the tensor cores; float64 vector rate
# is half of that; 989 TFLOP/s bf16 dense on the tensor cores (the bound of
# a bf16 convolution, whatever units the kernel uses).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12,
              torch.bfloat16: 989e12}
# 495 TFLOP/s TF32 dense on the tensor cores (NVIDIA data sheet): the rate
# of K4's 3xTF32 products, three (or two) TF32 products per float32 one
TF32_FLOPS = 495e12
# arithmetic operations per (workload, lane) element, counted off the kernel
# source (adds, multiplies, divides, compares, min/max each as one)
SWEEP_OPS_PER_ELEMENT = 122
SCREEN_OPS_PER_ELEMENT = 80
# the fused tile (K1 + K1a + K1b in one launch): the clusters the plan takes
# at the campaign's two tile widths, and the survivor slots of a row
FUSED_CLUSTERS = {4096: 8, 65536: 16}
MAX_SURVIVORS = 2048
# a float64 tile width past the fused kernel's shared memory: `general`
GENERAL_N = 262_144

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}
CELLS = [("qwen3_14b", "train_4k"), ("qwen3_14b", "decode_32k"),
         ("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "prefill_32k"),
         ("mamba2_130m", "train_4k"), ("zamba2_1_2b", "train_4k")]
DTYPES = (torch.float64, torch.float32)
SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_workloads(seed: int):
    """Six workloads named after real (arch, shape) cells; the census values
    are SYNTHETIC: one base census scaled log-uniformly over two decades."""
    rng = np.random.default_rng(seed)
    out = []
    for arch, shape in CELLS:
        scale = float(10.0 ** rng.uniform(-1.5, 0.5))
        out.append(dse.Workload(
            arch, shape, {k: v * scale for k, v in BASE.items()}, 256,
            float(rng.uniform(0.1, 2.0))))
    return out


def time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two tensors of
    positive finite floats of one dtype."""
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return int((a.view(it).to(torch.int64)
                - b.view(it).to(torch.int64)).abs().max())


def device_us(fns: dict, reps: int = 20) -> dict:
    """Mean device microseconds per call of each ``fn`` in the kernels whose
    name holds its symbol, as ``torch.profiler`` sees them (kernel execution
    only, no launch overhead; summed where one call launches several),
    keyed like ``fns``; values are None where the profiler
    reports no device time on this machine.  An extra reading beside the
    event timings: the comparison and the campaign gates do not depend on
    it."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for key, (fn, symbol) in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if symbol in ev.key:
                total += float(getattr(ev, "device_time_total",
                                       getattr(ev, "cuda_time_total", 0.0)))
                count += int(ev.count)
        out[key] = total / reps if count and total > 0 else None
    return out


def sweep_bound(w: int, n: int, dtype) -> dict:
    s = torch.finfo(dtype).bits // 8
    nbytes = (18 * n + 6 * w) * s + 2 * w * n * s + w * n
    return bound(nbytes, SWEEP_OPS_PER_ELEMENT * w * n, dtype)


def screen_bound(w: int, n: int, dtype) -> dict:
    s = torch.finfo(dtype).bits // 8
    nbytes = 2 * w * n * s + w * n + w * n + 2 * w * 8 + 2 * w * s
    return bound(nbytes, SCREEN_OPS_PER_ELEMENT * w * n, dtype)


def compact_bound(keep: torch.Tensor, dtype, max_survivors: int = 2048
                  ) -> dict:
    """K1b, the cumsum-rank survivor compaction: it reads the keep mask
    once and the energy / latency of the kept lanes it gathers (at most K
    per row, counted from this tile's data), and writes [W, K] int64 lane
    indices and two [W, K] value rows; about four operations per (row,
    lane): the cumsum add, the rank compare, the and, the select."""
    w, n = (int(d) for d in keep.shape)
    k = min(max_survivors, n)
    s = torch.finfo(dtype).bits // 8
    gathered = int(keep.sum(dim=1).clamp(max=k).sum())
    nbytes = w * n + gathered * 2 * s + w * k * (8 + 2 * s)
    return bound(nbytes, 4 * w * n, dtype)


def fused_bound(w: int, n: int, k: int, dtype) -> dict:
    """The fused tile: the candidate columns and the workload rows read
    once, the packed [W] aggregates and [W, K] survivors written once,
    against the sweep's and the screen's operations."""
    s = torch.finfo(dtype).bits // 8
    nbytes = (18 * n + 6 * w) * s + kern.packed_layout(w, k, dtype)[1]
    return bound(nbytes, (SWEEP_OPS_PER_ELEMENT + SCREEN_OPS_PER_ELEMENT)
                 * w * n, dtype)


def device_total_ms(fn, reps: int = 20):
    """Mean device milliseconds per call of ``fn`` over every kernel it
    launches (``torch.profiler``'s self device time, summed); None where
    the profiler reads no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(float(getattr(ev, "self_device_time_total",
                              getattr(ev, "self_cuda_time_total", 0.0)))
                for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == DeviceType.CUDA)
    return total / reps / 1e3 if total > 0 else None


def bound(nbytes: int, ops: int, dtype) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


# --- phases --------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return smi


def phase_build() -> dict:
    """One nvcc per source, all started together; returns the report per
    source."""
    t0 = time.perf_counter()
    sources = (kern.SOURCE, k2.SOURCE, k3.SOURCE, k3.BWD_SOURCE, k4.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(
            lambda src: build.build(src, force=True), sources)))
    for kernel in (kern, k2, k3, k4):
        kernel._library()
    k3._bwd_library()
    out = {}
    for src in sources:
        usage = [ln.strip() for ln in build.build_logs[src].splitlines()
                 if "registers" in ln or "spill" in ln]
        out[src] = {"nvcc_seconds": build.build_seconds[src],
                    "flags": " ".join(build.flags(src)),
                    "library": os.path.relpath(paths[src], ROOT),
                    "ptxas": usage}
    out[kern.SOURCE]["kernels"] = ptxas_report(
        build.build_logs[kern.SOURCE])
    out[k2.SOURCE]["kernels"] = ptxas_report(build.build_logs[k2.SOURCE])
    out[k3.SOURCE]["kernels"] = ptxas_report(build.build_logs[k3.SOURCE])
    tc = [r for r in out[k3.SOURCE]["kernels"]
          if K3_TC_KERNEL in r["kernel"]]
    if not tc or any(r["spill_stores"] or r["spill_loads"] for r in tc):
        raise AssertionError(f"K3's tensor-core kernel spills (or is "
                             f"missing from the ptxas report): {tc}")
    out[k3.BWD_SOURCE]["kernels"] = ptxas_report(
        build.build_logs[k3.BWD_SOURCE])
    bwd = [r for r in out[k3.BWD_SOURCE]["kernels"]
           if any(name in r["kernel"] for name in BWD_TC_KERNELS)]
    if len(bwd) != 2 * len(BWD_TC_KERNELS) or any(
            r["spill_stores"] or r["spill_loads"] for r in bwd):
        raise AssertionError(f"K3's backward kernels (dQ and dK / dV, bf16 "
                             f"and float32, at hd 64 and 128) spill (or are "
                             f"missing from the ptxas report): {bwd}")
    out[k4.SOURCE]["kernels"] = ptxas_report(build.build_logs[k4.SOURCE])
    tiles = [r for r in out[k4.SOURCE]["kernels"]
             if any(k in r["kernel"] for k in SSD_TILE_KERNELS)]
    if {k for k in SSD_TILE_KERNELS if any(k in r["kernel"] for r in tiles)} \
            != set(SSD_TILE_KERNELS) or any(
                r["spill_stores"] or r["spill_loads"] for r in tiles):
        raise AssertionError(f"K4's shared_cb kernels spill (or are missing "
                             f"from the ptxas report): {tiles}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": out})
    return out


def ptxas_report(log: str) -> list:
    """Registers, shared memory and spills of each kernel in an ``nvcc
    -Xptxas -v`` log, keyed by the kernel's mangled name (its template
    arguments in it, e.g. ``ILi128ELb1EE`` = <128, true>)."""
    rows, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"kernel": ln.split("'")[1]}
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            f = ln.split(",")
            cur["spill_stores"] = int(f[1].split()[0])
            cur["spill_loads"] = int(f[2].split()[0])
        elif cur is not None and "Used" in ln and "registers" in ln:
            f = ln.split("Used")[1]
            cur["registers"] = int(f.split()[0])
            cur["smem_bytes"] = sum(int(t.split()[0]) for t in f.split(",")
                                    if "smem" in t)
    return rows


def batch_inputs(engine: TileEvaluator, batch, dtype, device):
    """Packed (cand_cols, wl_cols) on the card for ``batch``, padded to the
    engine's chunk exactly as the evaluator pads a tile."""
    arrays = engine.padded_tile_arrays(batch)
    cand = costmodel.pack_cand_cols(arrays, dtype).to(device)
    wl = torch.as_tensor(engine.wl_cols).to(device=device, dtype=dtype)
    return cand, wl.contiguous()


def tile_inputs(engine: TileEvaluator, lo: int, hi: int, dtype, device):
    """``batch_inputs`` of space[lo:hi)."""
    return batch_inputs(engine, engine.space.slice(
        lo, hi, with_candidates=False), dtype, device)


def compare_case(name, cand, wl, cons, dtype) -> dict:
    """One kernel-vs-plain comparison of both kernels; raises on mismatch."""
    kw = dict(max_power_w=cons.max_power_w, max_latency_s=cons.max_latency_s,
              min_hbm_fit=cons.min_hbm_fit)
    e, l, f = kern.dse_sweep(cand, wl, **kw)
    pe, pl, pf = kern.dse_sweep_plain(cand, wl, **kw)
    torch.cuda.synchronize()
    if not torch.equal(f, pf):
        bad = int((f != pf).sum())
        raise AssertionError(f"{name}: feasible differs on {bad} lanes")
    if not (torch.isfinite(e).all() and torch.isfinite(l).all()):
        raise AssertionError(f"{name}: non-finite energy / latency")
    err_abs = max(float((e - pe).abs().max()), float((l - pl).abs().max()))
    err_rel = max(float(((e - pe).abs() / pe.abs()).max()),
                  float(((l - pl).abs() / pl.abs()).max()))
    ulps = max(ulp_diff(e, pe), ulp_diff(l, pl))
    if dtype == torch.float64 and ulps > 2:
        raise AssertionError(f"{name}: float64 sweep off by {ulps} ulp")
    if dtype == torch.float32 and err_rel > 1e-6:
        raise AssertionError(f"{name}: float32 sweep rel err {err_rel}")
    # the screen is held to its plain version on the SAME rows
    k, ns, nf, re_, rl_ = kern.screen_rows(e, l, f)
    pk, pns, pnf, pre, prl = kern.screen_rows_plain(e, l, f)
    torch.cuda.synchronize()
    if not torch.equal(k, pk):
        raise AssertionError(f"{name}: keep differs on "
                             f"{int((k != pk).sum())} lanes")
    if not (torch.equal(ns, pns) and torch.equal(nf, pnf)):
        raise AssertionError(f"{name}: counts differ {ns} {pns} {nf} {pnf}")
    if not (torch.equal(re_, pre) and torch.equal(rl_, prl)):
        raise AssertionError(f"{name}: reference maxima differ")
    ref_err = torch.stack([re_ - pre, rl_ - prl])
    screen_err = float(torch.where(torch.isfinite(ref_err), ref_err.abs(),
                                   torch.zeros_like(ref_err)).max())
    return {"case": name, "dtype": SUFFIX[dtype], "W": int(wl.shape[0]),
            "N": int(cand.shape[1]), "feasible": int(f.sum()),
            "survivors": int(ns.sum()), "sweep_max_abs_err": err_abs,
            "sweep_max_rel_err": err_rel, "sweep_max_ulp": ulps,
            "screen_max_abs_err": screen_err, "screen_equal": True}


def fused_field_diff(got: torch.Tensor, want: torch.Tensor, p) -> str:
    """The fields of two packed results that differ, for the message."""
    return ", ".join(
        name for name, f in p.layout.items()
        if not torch.equal(got[f.offset:f.offset + f.nbytes],
                           want[f.offset:f.offset + f.nbytes]))


def compare_fused(name, cand, wl, cons, dtype, host_buffer,
                  max_survivors: int = MAX_SURVIVORS) -> dict:
    """The fused kernel against ``sweep_reduce_plain`` on one tile: the
    packed results of two launches each bitwise equal to the plain
    version's, and the host path's ``SweepReduced`` equal to the plain
    one's; raises on a mismatch."""
    kw = dict(max_power_w=cons.max_power_w, max_latency_s=cons.max_latency_s,
              min_hbm_fit=cons.min_hbm_fit)
    p = kern.plan_for(cand, wl, max_survivors)
    if p.variant != kern.FUSED:
        raise AssertionError(f"{name}: planned {p.variant}, not fused")
    want = kern.sweep_reduce_plain(cand, wl, **kw,
                                   max_survivors=max_survivors)
    for run in range(2):
        got = kern.sweep_reduce_packed(cand, wl, **kw,
                                       max_survivors=max_survivors)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {SUFFIX[dtype]} run {run}: fused "
                                 f"differs from plain in "
                                 f"{fused_field_diff(got, want, p)}")
    red = kern.sweep_reduce(cand, wl, **kw, max_survivors=max_survivors,
                            host_buffer=host_buffer)
    ref = kern.unpack(want.cpu().numpy(), p, lambda: None)
    for f in ("surv_idx", "surv_energy", "surv_latency", "n_survivors",
              "n_feasible", "ref_energy", "ref_latency"):
        if not np.array_equal(getattr(red, f), getattr(ref, f)):
            raise AssertionError(f"{name}: host path differs in {f}")
    ns = red.n_survivors
    return {"case": name, "dtype": SUFFIX[dtype], "W": p.w, "N": p.n,
            "K": p.k, "clusters": p.clusters,
            "feasible": int(red.n_feasible.sum()), "survivors": int(ns.sum()),
            "overflowed_rows": int((ns > max_survivors).sum()),
            "bitwise_equal_twice": True}


def phase_kernels(workloads, device, ptxas: list) -> dict:
    """The fused kernel against its plain version, bitwise and twice, at the
    main-path shape (W=6, N=4096: a full tile, an all-infeasible one, the
    partial last one, every tile of the default campaign) and at W=6,
    N=65536, plus overflow at K 1 and 16; the plans and their cluster
    occupancy; K1 and K1a (the ``general`` variant) against theirs as
    before; then the timings.  Returns per-(dtype, N) numbers."""
    cons = dse.Constraint(max_power_w=40_000)
    none_ok = dse.Constraint(max_power_w=1e-3, min_hbm_fit=False)
    cases, fused_cases, all_tiles, numbers, plans = [], [], [], {}, []
    host = kern.ResultBuffer()
    for dtype in DTYPES:
        sfx = SUFFIX[dtype]
        for n in (4096, 65536):
            space = default_campaign_space(chunk_size=n)
            eng = TileEvaluator(workloads, CampaignConfig(
                space=space, evaluator="cuda", dtype=dtype, device=device,
                constraint=cons))
            # a full tile on which the constraint mask bites (some rows
            # partly feasible, some not at all); tile 0 at 65536
            lo = 5 * n if n == 4096 else 0
            cand, wl = tile_inputs(eng, lo, lo + n, dtype, device)
            w = int(wl.shape[0])
            p = kern.plan_for(cand, wl, MAX_SURVIVORS)
            active = kern.max_active_clusters(p, dtype, device)
            if p.variant != kern.FUSED or p.clusters != FUSED_CLUSTERS[n] \
                    or active < 1:
                raise AssertionError(f"plan at N={n} {sfx}: {p.variant}, "
                                     f"C={p.clusters}, {active} clusters "
                                     f"active at most")
            plans.append({"dtype": sfx, "W": w, "N": n, "variant": p.variant,
                          "clusters": p.clusters, "lanes": p.lanes,
                          "threads": p.threads, "smem_bytes": p.smem_bytes,
                          "portable": p.portable,
                          "max_active_clusters": active})
            cases.append(compare_case(f"full_n{n}", cand, wl, cons, dtype))
            fused_cases.append(compare_fused(f"full_n{n}", cand, wl, cons,
                                             dtype, host))
            for k in (1, 16):
                c = compare_fused(f"overflow_n{n}_k{k}", cand, wl, cons,
                                  dtype, host, max_survivors=k)
                if not c["overflowed_rows"]:
                    raise AssertionError(f"K={k} did not overflow")
                fused_cases.append(c)
            cases.append(compare_case(f"all_infeasible_n{n}", cand, wl,
                                      none_ok, dtype))
            if cases[-1]["feasible"] != 0 or cases[-1]["survivors"] != 0:
                raise AssertionError("all-infeasible tile has feasible lanes")
            fused_cases.append(compare_fused(f"all_infeasible_n{n}", cand,
                                             wl, none_ok, dtype, host))
            # the space's last tile is partial: padding lanes carry valid=0
            last_lo = (space.n_tiles() - 1) * n
            pc, pw = tile_inputs(eng, last_lo, len(space), dtype, device)
            n_valid = len(space) - last_lo
            if not 0 < n_valid < n:
                raise AssertionError("expected a partial last tile")
            cases.append(compare_case(f"partial_n{n}_valid{n_valid}", pc, pw,
                                      cons, dtype))
            fused_cases.append(compare_fused(f"partial_n{n}_valid{n_valid}",
                                             pc, pw, cons, dtype, host))
            _, _, pf = kern.dse_sweep(pc, pw, max_power_w=cons.max_power_w)
            if bool(pf[:, n_valid:].any()):
                raise AssertionError("padding lanes came out feasible")
            if n == 4096:
                # every tile the default campaign will launch
                tot = {"feasible": 0, "survivors": 0, "sweep_max_ulp": 0}
                for _, t_lo, b in space.tiles(with_candidates=False):
                    tc, tw = tile_inputs(eng, t_lo, t_lo + len(b), dtype,
                                         device)
                    c = compare_case("tile", tc, tw, cons, dtype)
                    f = compare_fused("tile", tc, tw, cons, dtype, host)
                    if (f["feasible"], f["survivors"]) != (c["feasible"],
                                                           c["survivors"]):
                        raise AssertionError("fused and K1 + K1a counts "
                                             "differ")
                    tot["feasible"] += c["feasible"]
                    tot["survivors"] += c["survivors"]
                    tot["sweep_max_ulp"] = max(tot["sweep_max_ulp"],
                                               c["sweep_max_ulp"])
                all_tiles.append({"case": f"all_{space.n_tiles()}_tiles_n{n}",
                                  "dtype": sfx, **tot, "screen_equal": True,
                                  "fused_bitwise_equal_twice": True})

            # timings on the full tile
            kw = dict(max_power_w=cons.max_power_w)
            e, l, f = kern.dse_sweep(cand, wl, **kw)
            iters = 200 if n == 4096 else 50
            t = {
                "fused_ms": time_ms(lambda: kern.sweep_reduce_packed(
                    cand, wl, **kw), iters),
                "fused_plain_ms": time_ms(lambda: kern.sweep_reduce_plain(
                    cand, wl, **kw), 20),
                # the wrapper the campaign calls: launch, one copy, one sync
                "fused_tile_ms": time_ms(lambda: kern.sweep_reduce(
                    cand, wl, **kw, host_buffer=host), iters),
                "sweep_ms": time_ms(lambda: kern.dse_sweep(cand, wl, **kw),
                                    iters),
                "sweep_plain_ms": time_ms(
                    lambda: kern.dse_sweep_plain(cand, wl, **kw), 20),
                "screen_ms": time_ms(lambda: kern.screen_rows(e, l, f),
                                     iters),
                "screen_plain_ms": time_ms(
                    lambda: kern.screen_rows_plain(e, l, f), 20),
            }

            def chain():
                ee, ll, ff = kern.dse_sweep(cand, wl, **kw)
                kk = kern.screen_rows(ee, ll, ff)[0]
                costmodel._compact_rows_device(kk, ee, ll, MAX_SURVIVORS)

            def general_tile():
                ee, ll, ff = kern.dse_sweep(cand, wl, **kw)
                costmodel.build_sweep_reduced(
                    kern.screen_rows(ee, ll, ff) + (ee, ll, ff),
                    MAX_SURVIVORS)

            # the old chain, K1 -> K1a -> K1b, device work only, and with
            # its four copies to the host (the general variant's wrapper)
            t["device_chain_ms"] = time_ms(chain, iters)
            t["general_tile_ms"] = time_ms(general_tile, iters)
            # K1b alone: the compaction's tensor ops on this tile's keep mask
            kk = kern.screen_rows(e, l, f)[0]
            t["compact_ms"] = time_ms(
                lambda: costmodel._compact_rows_device(kk, e, l,
                                                       MAX_SURVIVORS), iters)
            t["compact_device_ms"] = device_total_ms(
                lambda: costmodel._compact_rows_device(kk, e, l,
                                                       MAX_SURVIVORS))
            kb = compact_bound(kk, dtype)
            t["compact_bound_ms"] = kb["bound_ms"]
            t["compact_bound_by"] = kb["bound_by"]
            us = device_us({
                "fused": (lambda: kern.sweep_reduce_packed(cand, wl, **kw),
                          "k1_sweep_reduce_kernel"),
                "sweep": (lambda: kern.dse_sweep(cand, wl, **kw),
                          "dse_sweep_kernel"),
                "screen": (lambda: kern.screen_rows(e, l, f),
                           "screen_rows_kernel")})
            for key in ("fused", "sweep", "screen"):
                t[f"{key}_device_ms"] = None if us[key] is None \
                    else us[key] / 1e3
            numbers[(sfx, n)] = {**t, "W": w,
                                 "fused": fused_bound(w, n, p.k, dtype),
                                 "sweep": sweep_bound(w, n, dtype),
                                 "screen": screen_bound(w, n, dtype),
                                 "err": cases[-3]}
    # the general variant through the same wrapper, on a float64 tile past
    # the fused kernel's shared memory (one partial tile of the space)
    n = GENERAL_N
    space = default_campaign_space(chunk_size=n)
    eng = TileEvaluator(workloads, CampaignConfig(
        space=space, evaluator="cuda", dtype=torch.float64, device=device,
        constraint=cons))
    cand, wl = tile_inputs(eng, 0, len(space), torch.float64, device)
    p = kern.plan_for(cand, wl, MAX_SURVIVORS)
    if p.variant != kern.GENERAL:
        raise AssertionError(f"N={n} float64 planned {p.variant}")
    red = kern.sweep_reduce(cand, wl, max_power_w=cons.max_power_w,
                            host_buffer=host)
    ref = kern.unpack(kern.sweep_reduce_plain(
        cand, wl, max_power_w=cons.max_power_w).cpu().numpy(), p,
        lambda: None)
    for f in p.layout:
        if not np.array_equal(getattr(red, f), getattr(ref, f)):
            raise AssertionError(f"general variant differs in {f}")
    general_case = {"case": f"general_n{n}_valid{len(space)}",
                    "dtype": "f64", "variant": p.variant,
                    "survivors": int(red.n_survivors.sum()), "equal": True}
    fused_ptxas = [r for r in ptxas if "k1_sweep_reduce_kernel" in r["kernel"]]
    if len(fused_ptxas) != 4:
        raise AssertionError(f"the fused kernel's four instances are not in "
                             f"the ptxas report: {fused_ptxas}")
    emit({"phase": "kernels", "fused_cases": fused_cases,
          "general_case": general_case,
          "cases": cases + all_tiles, "plans": plans,
          "fused_ptxas": fused_ptxas,
          "timing": [{"dtype": k[0], "N": k[1],
                      "fused_bound_ms": val["fused"]["bound_ms"],
                      "fused_bound_by": val["fused"]["bound_by"],
                      "compact_bound_by": val["compact_bound_by"],
                      **{m: v for m, v in val.items() if m.endswith("_ms")}}
                     for k, val in numbers.items()],
          "timing_note": "*_ms: CUDA events around back-to-back calls after "
                         "warm-up (launch overhead included, inputs "
                         "L2-resident); *_device_ms: kernel execution alone "
                         "as torch.profiler reports it; fused_ms: the fused "
                         "kernel's launch alone; fused_tile_ms: its wrapper "
                         "(launch, one copy to pinned host memory, one "
                         "synchronisation); device_chain_ms: the old chain "
                         "K1 -> K1a -> K1b without copies; general_tile_ms: "
                         "the old chain with its four copies to the host; "
                         "compact_*: K1b (costmodel._compact_rows_device, "
                         "tensor ops) alone on the tile's keep mask, "
                         "max_survivors 2048"})
    return numbers


def run_campaign(workloads, space, evaluator, dtype, device, cons,
                 trace: bool = True):
    tel = Telemetry() if trace else None
    camp = Campaign(workloads, CampaignConfig(
        space=space, evaluator=evaluator, dtype=dtype, device=device,
        constraint=cons), telemetry=tel)
    torch.cuda.synchronize()
    result = camp.run()
    torch.cuda.synchronize()
    spans = {}
    if trace:
        dur = {}
        for r in tel.tracer.records:
            dur[r.name] = dur.get(r.name, 0.0) + r.dur
        total = dur.get("tile_eval", 0.0)
        tiles = max(result.tiles_done, 1)
        names = ("pad", "launch", "compact", "merge")
        spans = {"share": {k: dur.get(k, 0.0) / total for k in names},
                 "ms_per_tile": {k: 1e3 * dur.get(k, 0.0) / tiles
                                 for k in names}}
    return camp, result, spans


def summarize(result, spans) -> dict:
    return {"wall_s": result.wall_s,
            "evaluations_per_s": result.candidates_evaluated / result.wall_s,
            "tile_ms": 1e3 * result.sweep_wall_s / max(result.tiles_done, 1),
            "span_share_of_tile": spans.get("share", {}),
            "span_ms_per_tile": spans.get("ms_per_tile", {})}


class OverflowSpy:
    """Counts the overflow fallback's reads of full rows during a run:
    (tile, workload) pairs, and the tiles (results) they fall in."""

    def __init__(self):
        self.pairs = 0
        self.tiles = 0
        self._patch = None

    def __enter__(self):
        orig = costmodel.SweepReduced.full_rows

        def full_rows(red, w, n=None):
            self.pairs += 1
            if "_spied" not in red.__dict__:       # first read of this tile
                red.__dict__["_spied"] = True
                self.tiles += 1
            return orig(red, w, n)

        self._patch = mock.patch.object(costmodel.SweepReduced, "full_rows",
                                        full_rows)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def hv(result, key) -> float:
    return result.trajectories[key][-1].hypervolume


def same_candidate_set(a, b) -> bool:
    ca, _, _, ia = canonical_frontier(a)
    cb, _, _, ib = canonical_frontier(b)
    return ca == cb and np.array_equal(ia, ib)


def phase_campaign_default(workloads, device) -> dict:
    """The main path: `Campaign.run` over `default_campaign_space()`.
    Launch counts are zeroed just before the two fused runs and read just
    after; the exact per-workload tier runs outside that window."""
    cons = dse.Constraint(max_power_w=40_000)
    space = default_campaign_space()
    n_tiles = space.n_tiles()
    _, exact, _ = run_campaign(workloads, space, "torch", torch.float64,
                               device, cons, trace=False)

    kern.reset_launch_counts()
    with OverflowSpy() as spy:
        c64, r64, s64 = run_campaign(workloads, space, "cuda", torch.float64,
                                     device, cons)
        c32, r32, s32 = run_campaign(workloads, space, "cuda", torch.float32,
                                     device, cons)
    launches = kern.launch_counts()

    # one fused launch a tile and tier; K1 only where a tile overflowed, K1a
    # (the general variant's) never
    want = {k: 0 for k in launches}
    want["sweep_reduce_f64"] = want["sweep_reduce_f32"] = n_tiles
    if launches["dse_sweep_f64"] + launches["dse_sweep_f32"] != spy.tiles \
            or {k: v for k, v in launches.items() if "dse_sweep" not in k} \
            != {k: v for k, v in want.items() if "dse_sweep" not in k}:
        raise AssertionError(f"launches on the main path {launches}, "
                             f"expected {n_tiles} fused a tier and K1 once "
                             f"for each of {spy.tiles} overflowed tiles")
    if c64.engine.fused_launches != n_tiles:
        raise AssertionError("fused_launches != tiles")
    hv64, hv32, frontier_sizes = 0.0, 0.0, {}
    for key in exact.frontiers:
        fa, fb = exact.frontiers[key], r64.frontiers[key]
        if not same_candidate_set(fa, fb):
            ca, cb = set(fa.candidates), set(fb.candidates)
            raise AssertionError(
                f"{key}: float64 fused frontier differs from the exact "
                f"tier: only exact {sorted(ca - cb)[:4]}, only fused "
                f"{sorted(cb - ca)[:4]}")
        if fa.feasible_count != fb.feasible_count:
            raise AssertionError(f"{key}: feasible counts differ")
        if not (np.isfinite(fb.energy_j).all()
                and np.isfinite(fb.latency_s).all() and len(fb)):
            raise AssertionError(f"{key}: bad frontier values")
        h = hv(exact, key)
        hv64 = max(hv64, abs(hv(r64, key) - h) / h)
        hv32 = max(hv32, abs(hv(r32, key) - h) / h)
        frontier_sizes["|".join(key)] = len(fa)
    if hv64 > 1e-12:
        raise AssertionError(f"float64 hypervolume rel diff {hv64} > 1e-12")
    if hv32 > 1e-5:
        raise AssertionError(f"float32 hypervolume rel diff {hv32} > 1e-5")
    emit({"phase": "campaign_default", "candidates": len(space),
          "workloads": len(workloads), "tiles": n_tiles,
          "workload_census": "synthetic (seeded scaling of one base census)",
          "constraint": {"max_power_w": 40_000, "min_hbm_fit": True},
          "identical_candidate_sets_float64": True,
          "hypervolume_rel_diff_float64": hv64,
          "hypervolume_rel_diff_float32": hv32,
          "frontier_sizes": frontier_sizes, "launches": launches,
          "overflowed_tile_workload_pairs": spy.pairs,
          "exact_torch_float64": summarize(exact, {}),
          "cuda_float64": summarize(r64, s64),
          "cuda_float32": summarize(r32, s32)})
    return {"launches": launches, "fresh64": r64, "fresh32": r32,
            "exact": exact, "campaign64": c64}


def phase_campaign_resume(workloads, device, fresh) -> None:
    cons = dse.Constraint(max_power_w=40_000)
    cfg = CampaignConfig(space=default_campaign_space(), evaluator="cuda",
                         dtype=torch.float64, device=device, constraint=cons,
                         checkpoint_every=5)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "campaign.json")
        partial = Campaign(workloads, cfg).run(checkpoint_path=ckpt,
                                               max_tiles=10)
        if partial.complete or partial.tiles_done != 10:
            raise AssertionError("interruption did not stop at 10 tiles")
        resumed = Campaign.from_checkpoint(ckpt, device=device)
        if resumed.next_tile != 10 or resumed.evaluator != "cuda":
            raise AssertionError("checkpoint did not restore the campaign")
        final = resumed.run(checkpoint_path=ckpt)
    if not final.complete:
        raise AssertionError("resumed campaign did not finish")
    for key in fresh.frontiers:
        if not frontiers_identical(final.frontiers[key], fresh.frontiers[key]):
            raise AssertionError(f"{key}: resumed frontier != fresh")
    emit({"phase": "campaign_resume", "interrupted_after_tiles": 10,
          "tiles": final.n_tiles, "frontier_identical_to_fresh": True})


def phase_campaign_large(workloads, device, freq_points, numbers) -> dict:
    """A space a user of a million-point campaign would call real, float32
    fused tier; frontier members re-checked against the scalar simulator.
    Launch counts are zeroed just before the run and read just after; a spy
    counts the tiles and (tile, workload) pairs that overflowed
    ``max_survivors`` and took the fallback through K1's full rows."""
    cons = dse.Constraint(max_power_w=40_000)
    space = SpaceSpec(chips=tuple(CHIPS),
                      chip_counts=(4, 8, 16, 32, 64, 128, 256, 512, 1024),
                      freq_points=freq_points, mesh_dims=3,
                      variants=DEFAULT_VARIANTS, chunk_size=65_536)
    kern.reset_launch_counts()
    with OverflowSpy() as spy:
        _, res, shares = run_campaign(workloads, space, "cuda", torch.float32,
                                      device, cons)
    launches = kern.launch_counts()
    want = {k: 0 for k in launches}
    want["sweep_reduce_f32"] = res.n_tiles
    want["dse_sweep_f32"] = spy.tiles
    if launches != want:
        raise AssertionError(f"launches in the large campaign {launches}, "
                             f"expected {want}")
    if not res.complete:
        raise AssertionError("large campaign incomplete")
    worst, sizes = 0.0, {}
    for wl in workloads:
        front = res.frontiers[(wl.arch, wl.shape)]
        if front.feasible_count <= 0 or not len(front):
            raise AssertionError(f"{wl.arch}|{wl.shape}: empty frontier")
        traj = res.trajectories[(wl.arch, wl.shape)][-1]
        if traj.evaluated != len(space):
            raise AssertionError("evaluated count != space size")
        # up to 64 evenly spaced frontier members per workload
        pick = np.unique(np.linspace(0, len(front) - 1, 64).astype(int))
        sizes["|".join((wl.arch, wl.shape))] = len(front)
        for i in pick:
            cand, e, l = (front.candidates[i], front.energy_j[i],
                          front.latency_s[i])
            ana = dse._scale_analysis(wl.base_analysis, wl.base_chips, cand)
            ref = costmodel.simulate(ana, get_chip(cand.chip), cand.n_chips,
                                     freq_mhz=cand.freq_mhz, mesh=cand.mesh)
            worst = max(worst, abs(e - ref.energy_j) / ref.energy_j,
                        abs(l - ref.latency_s) / ref.latency_s)
    if worst > 1e-5:
        raise AssertionError(f"large-campaign frontier off the scalar "
                             f"simulator by {worst}")
    num = numbers[("f32", 65536)]
    busy_s = (res.n_tiles * num["fused_ms"] + spy.tiles * num["sweep_ms"]) \
        / 1e3
    emit({"phase": "campaign_large", "candidates": len(space),
          "rows": space.n_rows, "freq_points": freq_points,
          "workloads": len(workloads), "tiles": res.n_tiles,
          "dtype": "float32", **summarize(res, shares),
          "launches": launches,
          "overflowed_tiles": spy.tiles,
          "overflowed_tile_workload_pairs": spy.pairs,
          "frontier_sizes": sizes,
          "frontier_max_rel_err_vs_scalar_simulator": worst,
          "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / res.wall_s,
          "device_idle_note": "busy = tiles x the fused kernel's launch and "
                              "overflowed tiles x K1's, as CUDA events timed "
                              "them at this tile shape in the kernels phase; "
                              "the rest of the wall is host work and copies"})
    return launches


# --- the paper's predictors, the fast tier, the adaptive campaign ------------

PREDICTOR_MODELS = ("knn", "decision_tree", "random_forest")
# rows k-fold evaluation takes from the dataset (a seeded subsample): a
# random-forest fold fits 40 trees in numpy on the host, ~0.2 s a tree at
# ~1,000 rows, so the whole dataset would take ~100 s for the two targets
KFOLD_ROWS = 256
# the forests the walk is timed with (RandomForestRegressor's defaults)
WALK_TREES, WALK_DEPTH = 40, 12
# query rows the KNN's card-against-CPU comparison takes (the CPU's
# difference blocks over the whole space would take tens of seconds)
KNN_CPU_ROWS = 8192
KNN_TOL = 1e-5
TREE_NODE_BYTES = 8 + 4 + 8 + 8 + 4     # feature, threshold, left, right, value


class CallSpy:
    """Counts calls of ``module.name`` while active (patched in place)."""

    def __init__(self, module, name: str):
        self.calls = 0
        self._module, self._name = module, name
        self._patch = None

    def __enter__(self):
        orig = getattr(self._module, self._name)

        def spy(*args, **kwargs):
            self.calls += 1
            return orig(*args, **kwargs)

        self._patch = mock.patch.object(self._module, self._name, spy)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def span_ms(tel: Telemetry, names) -> dict:
    dur = {}
    for r in tel.tracer.records:
        dur[r.name] = dur.get(r.name, 0.0) + r.dur
    return {k: 1e3 * dur.get(k, 0.0) for k in names}


def write_artifacts(workloads, path: str) -> None:
    """The dry-run artifact JSONs ``dataset.load_dryrun_artifacts`` reads,
    one per workload cell, holding the workloads' SYNTHETIC census."""
    for wl in workloads:
        art = {"hxa": dict(wl.base_analysis),
               "roofline": {"n_chips": wl.base_chips}}
        with open(os.path.join(path, f"{wl.arch}__{wl.shape}__pod1.json"),
                  "w") as f:
            json.dump(art, f)


def walk_levels(model, X: torch.Tensor) -> int:
    """(tree, sample) steps that met an internal node in one walk of ``X``
    — the comparisons this data needs, the walk's operation count."""
    feat, thr, left, right, _ = model._stacked
    node = torch.zeros((feat.shape[0], X.shape[0]), dtype=torch.int64,
                       device=X.device)
    xt, visits = X.t(), 0
    for _ in range(model.max_depth + 1):
        f = feat.gather(1, node)
        visits += int((f >= 0).sum())
        x = xt.gather(0, f.clamp(min=0))
        nxt = torch.where(x <= thr.gather(1, node), left.gather(1, node),
                          right.gather(1, node))
        node = torch.where(f < 0, node, nxt)
    return visits


def walk_bound(model, X: torch.Tensor) -> dict:
    """The forest walk: the feature matrix, the stacked trees and the
    [T, N] float32 leaf values each moved once; one comparison for each
    internal node a sample meets in a tree."""
    t, nodes = model._stacked[0].shape
    n, f = X.shape
    nbytes = n * f * 4 + t * nodes * TREE_NODE_BYTES + t * n * 4
    return bound(nbytes, walk_levels(model, X), torch.float32)


def knn_bound(model, n: int) -> dict:
    """KNN predict: queries, the standardized training set and its
    targets read once, predictions written once; three operations (sub,
    mul, add) per (query, training row, feature)."""
    m, f = model._x.shape
    nbytes = (n * f + m * f + m + n) * 4
    return bound(nbytes, 3 * n * m * f, torch.float32)


def kernel_count(fn) -> int:
    """CUDA kernels one call of ``fn`` launches, as the profiler counts
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(int(ev.count) for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == DeviceType.CUDA)


def phase_predictors(workloads, device, seed: int) -> dict:
    """The paper's predictors on the card: a dataset built from artifact
    JSONs of the six cells, k-fold MAPE / R^2 of the three models on power
    and cycles, the forest walk and KNN over the whole campaign space held
    card against CPU, and the fast path's pick card against CPU."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_artifacts(workloads, tmp)
        t = time.perf_counter()
        X, y_power, y_cycles, _ = dataset.build_dataset(tmp)
        dataset_s = time.perf_counter() - t
    if not (len(X) and np.isfinite(X).all() and (y_power > 0).all()
            and (y_cycles > 0).all()):
        raise AssertionError("bad dataset")
    rng = np.random.default_rng(seed)
    cap = np.sort(rng.choice(len(X), size=min(KFOLD_ROWS, len(X)),
                             replace=False))
    kfold = {}
    for target, y in (("power", y_power), ("cycles", y_cycles)):
        for name in PREDICTOR_MODELS:
            t = time.perf_counter()
            r = predictors.kfold_evaluate(name, X[cap], y[cap], device=device)
            if not (np.isfinite(r["mape"]) and np.isfinite(r["r2"])):
                raise AssertionError(f"{target}/{name}: {r}")
            kfold[f"{target}/{name}"] = {
                "mape_pct": r["mape"], "r2": r["r2"],
                "mape_std": r["mape_std"],
                "seconds": time.perf_counter() - t}

    # the fast tier's models, fitted on the whole dataset: the paper's picks
    t = time.perf_counter()
    power = predictors.RandomForestRegressor(
        n_trees=WALK_TREES, max_depth=WALK_DEPTH, device=device).fit(
        X, y_power)
    cycles = predictors.KNNRegressor(device=device).fit(X, y_cycles)
    fit_s = time.perf_counter() - t
    power_cpu, cycles_cpu = (predictors.params_from_reference(
        predictors.model_state(m), device="cpu") for m in (power, cycles))

    # the design matrix of the whole campaign space, first workload's cell
    space = default_campaign_space()
    batch = space.slice(0, len(space), with_candidates=False)
    wl = workloads[0]
    xs = features.extract_batch(get_config(wl.arch), SHAPES[wl.shape],
                                batch.chip_idx, batch.n_chips,
                                batch.mesh_data, batch.mesh_model,
                                batch.freq_mhz)
    xs_dev = torch.from_numpy(xs).to(device)
    leaves = power.tree_predictions(xs_dev)
    if not torch.equal(leaves.cpu(), power_cpu.tree_predictions(xs)):
        raise AssertionError("forest walk: card != CPU")
    stats, stats_cpu = (power.predict_log_stats(xs_dev),
                        power_cpu.predict_log_stats(xs))
    if not all(np.array_equal(a, b) for a, b in zip(stats, stats_cpu)):
        raise AssertionError("predict_log_stats: card != CPU")
    if not np.array_equal(power.predict(xs_dev), power_cpu.predict(xs)):
        raise AssertionError("forest predict: card != CPU")
    walk = lambda: power.tree_predictions(xs_dev)
    walk_ms = time_ms(walk, iters=10, warmup=2)
    walk_stats_ms = time_ms(lambda: power.predict_log_stats(xs_dev),
                            iters=5, warmup=1)
    walk_device = device_total_ms(walk, reps=3)

    knn = cycles.predict(xs_dev)
    knn_cpu = cycles_cpu.predict(xs[:KNN_CPU_ROWS])
    knn_err = float(np.max(np.abs(knn[:KNN_CPU_ROWS] / knn_cpu - 1.0)))
    if not (np.isfinite(knn).all() and knn_err <= KNN_TOL):
        raise AssertionError(f"KNN card vs CPU {knn_err} > {KNN_TOL}")
    knn_fn = lambda: cycles.predict(xs_dev)
    knn_ms = time_ms(knn_fn, iters=3, warmup=1)
    knn_device = device_total_ms(knn_fn, reps=2)

    # the fast path's pick, each workload's cell, card against CPU
    cons = dse.Constraint(max_power_w=40_000)
    picks = {}
    for w in workloads:
        def verify(c, w=w):
            return costmodel.simulate(
                dse._scale_analysis(w.base_analysis, w.base_chips, c),
                get_chip(c.chip), c.n_chips, freq_mhz=c.freq_mhz,
                mesh=c.mesh)
        got = [dse.fast_path_search(w.arch, w.shape, p, c,
                                    dse.default_space(), cons,
                                    verify_top_k=5, slow_verify=verify)
               for p, c in ((power, cycles), (power_cpu, cycles_cpu))]
        if got[0][0] != got[1][0] or got[0][0] is None:
            raise AssertionError(f"{w.arch}|{w.shape}: fast-path pick on "
                                 f"the card {got[0][0]} != CPU {got[1][0]}")
        picks["|".join((w.arch, w.shape))] = dataclasses.astuple(got[0][0])
    emit({"phase": "predictors", "census": "synthetic",
          "dataset": {"rows": int(len(X)), "features": int(X.shape[1]),
                      "cells": len(workloads), "seconds": dataset_s},
          "kfold": {"rows_cap": int(len(cap)), "folds": 5,
                    "models": kfold},
          "fit_seconds_full_dataset": fit_s,
          "forest_walk": {
              "trees": WALK_TREES, "max_depth": WALK_DEPTH,
              "nodes_padded": int(power._stacked[0].shape[1]),
              "rows": int(len(xs)), "features": int(xs.shape[1]),
              "card_vs_cpu_leaves_bitwise": True,
              "predict_log_stats_bitwise": True, "predict_bitwise": True,
              "ms": walk_ms, "device_ms": walk_device,
              "predict_log_stats_ms": walk_stats_ms,
              "rows_per_s": len(xs) / (walk_ms / 1e3),
              "kernels_per_walk": kernel_count(walk),
              **walk_bound(power, xs_dev)},
          "knn": {"k": cycles.k, "train_rows": int(cycles._x.shape[0]),
                  "rows": int(len(xs)), "block_rows": cycles.block_rows(),
                  "block_bytes": predictors.KNN_BLOCK_BYTES,
                  "cpu_rows_compared": KNN_CPU_ROWS,
                  "max_rel_err_card_vs_cpu": knn_err, "tolerance": KNN_TOL,
                  "ms": knn_ms, "device_ms": knn_device,
                  "rows_per_s": len(xs) / (knn_ms / 1e3),
                  **knn_bound(cycles, len(xs))},
          "fast_path_pick_card_equals_cpu": True, "fast_path_picks": picks,
          "seconds": time.perf_counter() - t_phase})
    return {"power": power, "cycles": cycles,
            "walk": {"ms": walk_ms, "device_ms": walk_device}}


def frontier_hv_ratio(wl, cands, exact_front, cons, device) -> dict:
    """The predicted frontier's candidates priced exactly: the hypervolume
    of those truly feasible against the exact frontier's, both against a
    reference point 1.1x the exact frontier's largest energy and latency."""
    ref_e = 1.1 * float(np.max(exact_front.energy_j))
    ref_l = 1.1 * float(np.max(exact_front.latency_s))
    res, feas = dse.evaluate_workload_tile(
        wl, dse.CandidateBatch.from_candidates(cands), cons, device=device)
    feas = feas.cpu().numpy()
    hv_pred = hypervolume_2d(res.energy_j.cpu().numpy()[feas],
                             res.latency_s.cpu().numpy()[feas], ref_e, ref_l)
    hv_exact = hypervolume_2d(exact_front.energy_j, exact_front.latency_s,
                              ref_e, ref_l)
    return {"hv_ratio": hv_pred / hv_exact,
            "truly_feasible": int(feas.sum()), "size": len(cands)}


def phase_campaign_fast(workloads, device, models, exact) -> dict:
    """``Campaign.run`` with the fast tier (the phase's fitted forest for
    power, KNN for cycles) over the default space; each predicted frontier
    priced exactly and held against the exact tier's (report only)."""
    cons = dse.Constraint(max_power_w=40_000)
    space = default_campaign_space()
    tel = Telemetry()
    with CallSpy(predictors, "forest_predict") as walks:
        camp = Campaign(workloads, CampaignConfig(
            space=space, evaluator="fast", device=device, constraint=cons,
            power_model=models["power"], cycles_model=models["cycles"]),
            telemetry=tel)
        torch.cuda.synchronize()
        res = camp.run()
        torch.cuda.synchronize()
    if not res.complete:
        raise AssertionError("fast campaign incomplete")
    sizes, hv = {}, {}
    for wl in workloads:
        key = (wl.arch, wl.shape)
        front = res.frontiers[key]
        if not (len(front) and np.isfinite(front.energy_j).all()
                and np.isfinite(front.latency_s).all()):
            raise AssertionError(f"{key}: bad predicted frontier")
        if res.trajectories[key][-1].evaluated != len(space):
            raise AssertionError("evaluated count != space size")
        name = "|".join(key)
        sizes[name] = len(front)
        hv[name] = frontier_hv_ratio(wl, list(front.candidates),
                                     exact.frontiers[key], cons, device)
    spans = span_ms(tel, ("launch", "merge"))
    emit({"phase": "campaign_fast", "candidates": len(space),
          "workloads": len(workloads), "tiles": res.n_tiles,
          "models": {"power": "random_forest (40 trees, depth 12)",
                     "cycles": "knn (k 5)"},
          "census": "synthetic",
          "wall_s": res.wall_s,
          "evaluations_per_s": res.candidates_evaluated / res.wall_s,
          "tile_ms": 1e3 * res.sweep_wall_s / res.tiles_done,
          "span_ms_per_tile": {k: v / res.tiles_done
                               for k, v in spans.items()},
          "forest_walks": walks.calls,
          "frontier_sizes": sizes,
          "predicted_frontier_priced_exactly": hv,
          "hv_note": "report only: hypervolume of the predicted frontier's "
                     "truly feasible candidates at their exact costs over "
                     "the exact torch tier's frontier's, reference point "
                     "1.1x the exact frontier's largest energy and latency"})
    return {"walks": walks.calls}


def phase_adaptive(workloads, device, exact) -> dict:
    """The main path of the adaptive campaign: the default ``AdaptiveConfig``
    over the default space on the fused float64 tier, card against the same
    run on the CPU, resume == fresh on the card.  Launch counts are zeroed
    just before the card's fresh run and read just after."""
    cons = dse.Constraint(max_power_w=40_000)
    acfg = AdaptiveConfig()
    cfg = CampaignConfig(space=default_campaign_space(), evaluator="cuda",
                         dtype=torch.float64, device=device, constraint=cons,
                         adaptive=acfg)
    tel = Telemetry()
    kern.reset_launch_counts()
    with CallSpy(predictors, "forest_predict") as walks:
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = AdaptiveCampaign(workloads, cfg, telemetry=tel)
        res = card.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = kern.launch_counts()
    want = {k: 0 for k in launches}
    want["sweep_reduce_f64"] = res.tiles_evaluated
    want["dse_sweep_f64"] = res.tiles_evaluated     # the training samples
    if launches != want:
        raise AssertionError(f"adaptive launches {launches}, expected {want}")

    t = time.perf_counter()
    cpu = AdaptiveCampaign(workloads, cfg.replace(device="cpu"))
    res_cpu = cpu.run()
    cpu_s = time.perf_counter() - t
    if (res_cpu.rounds != res.rounds or res_cpu.hv_history != res.hv_history
            or res_cpu.stopped_on != res.stopped_on):
        raise AssertionError(f"adaptive card {res.rounds} {res.hv_history} "
                             f"!= CPU {res_cpu.rounds} {res_cpu.hv_history}")
    for key in res.frontiers:
        if not frontiers_identical(res.frontiers[key],
                                   res_cpu.frontiers[key]):
            raise AssertionError(f"{key}: adaptive frontier card != CPU")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "adaptive.json")
        part = AdaptiveCampaign(workloads, cfg).run(checkpoint_path=ckpt,
                                                    max_rounds=1)
        if part.stopped_on != "max_rounds" or len(part.rounds) != 1:
            raise AssertionError("adaptive interruption did not stop")
        resumed = AdaptiveCampaign.from_checkpoint(ckpt, device=device)
        final = resumed.run(checkpoint_path=ckpt)
    if (final.rounds != res.rounds or final.hv_history != res.hv_history
            or final.stopped_on != res.stopped_on):
        raise AssertionError("adaptive resume != fresh")
    for key in res.frontiers:
        if not frontiers_identical(final.frontiers[key], res.frontiers[key]):
            raise AssertionError(f"{key}: resumed adaptive frontier != fresh")

    hv = {}
    for key, refs in card.acq_refs.items():
        fr, ex = res.frontiers[key], exact.frontiers[key]
        if refs is None or not len(fr):
            raise AssertionError(f"{key}: no adaptive frontier")
        if not set(fr.indices.tolist()) <= {
                i for t in sum(res.rounds, [])
                for i in range(*tile_span(card.space, t))}:
            raise AssertionError(f"{key}: frontier outside evaluated tiles")
        hv["|".join(key)] = (hypervolume_2d(fr.energy_j, fr.latency_s, *refs)
                             / hypervolume_2d(ex.energy_j, ex.latency_s,
                                              *refs))
    emit({"phase": "adaptive", "candidates": res.space_size,
          "workloads": len(workloads), "config": acfg.to_dict(),
          "evaluator": "cuda", "dtype": "float64",
          "rounds": res.rounds, "stopped_on": res.stopped_on,
          "tiles_evaluated": res.tiles_evaluated, "n_tiles": res.n_tiles,
          "fraction_evaluated": res.fraction_evaluated,
          "hv_history": res.hv_history,
          "hv_ratio_vs_exact_frontier": hv,
          "hv_note": "each workload's adaptive frontier over the exact torch "
                     "tier's frontier (campaign_default), both against the "
                     "adaptive run's pinned acquisition reference point",
          "card_vs_cpu_identical": True, "resume_equals_fresh": True,
          "wall_s": wall, "cpu_run_s": cpu_s,
          "span_ms": span_ms(tel, ("tile_eval", "launch", "sample",
                                   "compact", "refit", "acquisition")),
          "launches": launches, "forest_walks": walks.calls})
    return {"launches": launches, "walks": walks.calls, "result": res,
            "config": cfg}


# --- accelerator selection serving --------------------------------------------

# index hits asked per offline workload; the seeded census factor of the
# novel queries (each workload's census scaled by one draw: a family the
# index has not seen, under the same (arch, shape))
SELECT_HIT_REPEATS = 8
NOVEL_SCALE = (1.01, 1.3)
SELECT_VERIFY_TOP = 256
TIGHT_POWER_W = 20_000
# the fused K1 held at the serving path's shapes: workload rows (a lone
# query, a six-query flush, twelve) x lanes (a pruned slice padded to the
# chunk, the whole default space as one tile)
SELECT_W = (1, 6, 12)
SELECT_N = (4096, 125_440)


def novel_workloads(workloads, seed: int):
    rng = np.random.default_rng(seed + 1)
    out = []
    for wl in workloads:
        f = float(rng.uniform(*NOVEL_SCALE))
        out.append(dse.Workload(
            wl.arch, wl.shape, {k: v * f for k, v in wl.base_analysis.items()},
            wl.base_chips, wl.state_gb_per_device))
    return out


def latency_summary(ms: list) -> dict:
    """``spread`` (its median the p50) with the p99."""
    return {**spread(ms), "p99": float(np.percentile(ms, 99))}


def k1_delta(before: dict) -> dict:
    """K1's launches since ``before`` (``sweep_reduce_*`` and
    ``dse_sweep_*`` apart), the kernels that moved only."""
    now = kern.launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def timed_select(engine, *args, **kw):
    """(answer, host ms, K1 launches) of one ``engine.select``."""
    before = kern.launch_counts()
    t0 = time.perf_counter()
    answer = engine.select(*args, **kw)
    torch.cuda.synchronize()
    return answer, (time.perf_counter() - t0) * 1e3, k1_delta(before)


def span_stats(tel: Telemetry, names) -> dict:
    out = {}
    for name in names:
        durs = [r.dur * 1e3 for r in tel.tracer.records if r.name == name]
        if durs:
            out[name] = {"n": len(durs), "total_ms": sum(durs),
                         "mean_ms": sum(durs) / len(durs),
                         "max_ms": max(durs)}
    return out


def slice_frontier(w, cfg, space, gidx):
    """The exact frontier of ``w`` over the slice ``gidx`` of ``space``,
    by a direct ``TileEvaluator.reduce_tile`` of that slice."""
    ev = TileEvaluator([w], cfg)
    batch = dse.CandidateBatch.from_candidates(space.candidates_at(gidx))
    tr = ev.reduce_tile(batch, 0)
    fr = StreamingFrontier()
    loc = tr.surv_gidx[0]
    fr.merge_reduced(space.candidates_at(gidx[loc]), tr.surv_energy[0],
                     tr.surv_latency[0], loc, span=(0, int(gidx.size)),
                     n_feasible=tr.n_feasible[0],
                     ref_energy_j=tr.ref_energy_j[0],
                     ref_latency_s=tr.ref_latency_s[0])
    front = fr.as_pareto_frontier(w)
    return dse.ParetoFrontier(
        workload=w, candidates=front.candidates, energy_j=front.energy_j,
        latency_s=front.latency_s, indices=gidx[front.indices],
        feasible_count=front.feasible_count)


def select_kernel_checks(workloads, novel, cons, pruned_gidx, device):
    """The fused K1 against ``sweep_reduce_plain`` at the serving path's
    shapes, bitwise and twice (``compare_fused``), in both dtypes: W in
    SELECT_W x N in SELECT_N.  N=4096 is the pruned slice the predictor
    path verified, padded to the chunk as the evaluator pads it; N=125,440
    the whole default space as one tile.  Then the timings at N=125,440.
    Returns (cases, plans, timing keyed (dtype, W))."""
    host = kern.ResultBuffer()
    space = default_campaign_space()
    rows = {1: novel[:1], 6: novel, 12: list(workloads) + list(novel)}
    cases, plans, timing = [], [], {}
    for dtype in DTYPES:
        sfx = SUFFIX[dtype]
        for w in SELECT_W:
            wls = [dataclasses.replace(x, shape=f"{x.shape}:q{i}")
                   for i, x in enumerate(rows[w])]
            ev = TileEvaluator(wls, CampaignConfig(
                space=space, evaluator="cuda", dtype=dtype, device=device,
                constraint=cons))
            for n in SELECT_N:
                if n == len(space):
                    batch = space.slice(0, n, with_candidates=False)
                else:
                    batch = dse.CandidateBatch.from_candidates(
                        space.candidates_at(pruned_gidx))
                cand, wl = batch_inputs(ev, batch, dtype, device)
                if int(cand.shape[1]) != n:
                    raise AssertionError(f"tile of {cand.shape[1]} lanes, "
                                         f"expected {n}")
                p = kern.plan_for(cand, wl, MAX_SURVIVORS)
                active = kern.max_active_clusters(p, dtype, device)
                if p.variant != kern.FUSED or active < 1:
                    raise AssertionError(f"W={w} N={n} {sfx}: {p.variant}, "
                                         f"{active} clusters active")
                plans.append({"dtype": sfx, "W": w, "N": n,
                              "valid_lanes": len(batch),
                              "variant": p.variant, "clusters": p.clusters,
                              "lanes": p.lanes, "threads": p.threads,
                              "lanes_per_thread": p.lanes / p.threads,
                              "smem_bytes": p.smem_bytes,
                              "portable": p.portable,
                              "max_active_clusters": active})
                cases.append(compare_fused(f"select_w{w}_n{n}", cand, wl,
                                           cons, dtype, host))
                if n != len(space):
                    continue
                kw = dict(max_power_w=cons.max_power_w)
                t = {"fused_ms": time_ms(lambda: kern.sweep_reduce_packed(
                         cand, wl, **kw), 50),
                     "fused_tile_ms": time_ms(lambda: kern.sweep_reduce(
                         cand, wl, **kw, host_buffer=host), 50),
                     "fused_plain_ms": time_ms(
                         lambda: kern.sweep_reduce_plain(cand, wl, **kw), 5,
                         warmup=2),
                     "sweep_ms": time_ms(lambda: kern.dse_sweep(
                         cand, wl, **kw), 50)}
                us = device_us({
                    "fused": (lambda: kern.sweep_reduce_packed(cand, wl, **kw),
                              "k1_sweep_reduce_kernel"),
                    "sweep": (lambda: kern.dse_sweep(cand, wl, **kw),
                              "dse_sweep_kernel")})
                for key in ("fused", "sweep"):
                    t[f"{key}_device_ms"] = None if us[key] is None \
                        else us[key] / 1e3
                fb = fused_bound(w, n, p.k, dtype)
                sb = sweep_bound(w, n, dtype)
                timing[(sfx, w)] = {
                    **t, "W": w, "N": n,
                    "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
                    "sweep_bound_ms": sb["bound_ms"],
                    "sweep_bound_by": sb["bound_by"],
                    "overflowed_rows": cases[-1]["overflowed_rows"],
                    "plan": {k: plans[-1][k] for k in
                             ("clusters", "lanes", "threads", "smem_bytes",
                              "max_active_clusters")}}
    return cases, plans, timing


def phase_selection(workloads, device, campaign, fresh, models,
                    seed: int) -> dict:
    """The serving layer's main path: a ``FrontierIndex`` of
    campaign_default's float64 ``"cuda"`` campaign, saved and loaded; index
    hits; a novel query over the whole space (ONE fused launch of W=1 x
    N=125,440), twice; a flush of six novel queries and one hit (one
    launch); the same six one by one (six); a constraint override; the
    predictor paths with the predictors phase's forest and KNN.  Counts are
    zeroed just before the engines answer and read just after; then the
    checks: standalone campaigns, a direct evaluation of the pruned slice,
    the same queries on the CPU, and the fused K1 at the new shapes."""
    t_phase = time.perf_counter()
    cons = campaign.constraint
    novel = novel_workloads(workloads, seed)
    tight = dse.Constraint(max_power_w=TIGHT_POWER_W)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        path = FrontierIndex.from_campaign(campaign).save(
            os.path.join(tmp, "frontier_index.json"))
        index = FrontierIndex.load(path)
        index_s = time.perf_counter() - t
        index_bytes = os.path.getsize(path)
    if (len(index), index.evaluator, index.dtype) != (len(workloads), "cuda",
                                                      "float64"):
        raise AssertionError(f"index {len(index)} {index.evaluator} "
                             f"{index.dtype}")
    tel, ptel = Telemetry(), Telemetry()
    engine = SelectionEngine(index, device=device, telemetry=tel)
    cfg = engine.config
    if (cfg.evaluator, cfg.dtype, cfg.device) != ("cuda", torch.float64,
                                                  device):
        raise AssertionError(f"derived config {cfg.evaluator} {cfg.dtype} "
                             f"{cfg.device}")
    pcfg = cfg.replace(power_model=models["power"],
                       cycles_model=models["cycles"])
    pengine = SelectionEngine(index, pcfg, telemetry=ptel,
                              verify_top=SELECT_VERIFY_TOP)
    seq = SelectionEngine(index, device=device)
    ms, deltas = {}, {}

    torch.cuda.synchronize()
    kern.reset_launch_counts()
    hits, ms["index_exact"] = [], []
    for _ in range(SELECT_HIT_REPEATS):
        for w in workloads:
            a, t_ms, d = timed_select(engine, w)
            hits.append((w, a))
            ms["index_exact"].append(t_ms)
            if d:
                raise AssertionError(f"an index hit launched {d}")
    hit_launches = engine.fused_launches
    lone, ms["mini_campaign_first"], deltas["lone_first"] = timed_select(
        engine, novel[0])
    again, ms["mini_campaign_warm"], deltas["lone_warm"] = timed_select(
        engine, novel[0])
    before, fused0 = kern.launch_counts(), engine.fused_launches
    for w in novel:
        engine.submit(w)
    engine.submit(workloads[1])
    t = time.perf_counter()
    batched = engine.flush()
    torch.cuda.synchronize()
    ms["flush_7_queries"] = (time.perf_counter() - t) * 1e3
    deltas["flush"] = k1_delta(before)
    flush_launches = engine.fused_launches - fused0
    seq_answers, ms["sequential"] = [], []
    before = kern.launch_counts()
    for w in novel:
        a, t_ms, _ = timed_select(seq, w)
        seq_answers.append(a)
        ms["sequential"].append(t_ms)
    deltas["sequential"] = k1_delta(before)
    over, ms["constraint_override"], deltas["constraint_override"] = \
        timed_select(engine, workloads[0], constraint=tight)
    degraded, ms["predictor_only"], deltas["predictor_only"] = timed_select(
        pengine, novel[0], deadline_s=0.0)
    degraded_launches = pengine.fused_launches
    pruned, ms["mini_campaign_pruned"], deltas["pruned"] = timed_select(
        pengine, novel[0])
    torch.cuda.synchronize()
    launches = kern.launch_counts()

    # every exact-path query answered exactly, one fused sweep a group
    exact = [lone, again, over, pruned] + batched[:6] + seq_answers
    if [a.provenance for a in exact] != ["mini_campaign"] * len(exact) \
            or batched[6].provenance != "index_exact":
        raise AssertionError("provenances " + str(
            [a.provenance for a in exact + [batched[6]]]))
    for name, d in deltas.items():
        want = {"predictor_only": 0, "sequential": 6}.get(name, 1)
        if d.get("sweep_reduce_f64", 0) != want or any(
                k not in ("sweep_reduce_f64", "dse_sweep_f64") for k in d):
            raise AssertionError(f"{name}: K1 launches {d}, expected {want} "
                                 "fused float64 (and K1 alone on overflow)")
    if (hit_launches, flush_launches, seq.fused_launches,
            degraded_launches) != (0, 1, 6, 0):
        raise AssertionError(f"fused_launches: hits {hit_launches}, flush "
                             f"{flush_launches}, sequential "
                             f"{seq.fused_launches}, predictor-only "
                             f"{degraded_launches}")
    fails = [e.telemetry.counter("selection_minicampaign_failures_total")
             .value for e in (engine, pengine, seq)]
    if any(fails):
        raise AssertionError(f"mini-campaign failures {fails}")
    for w, a in hits:
        if a.provenance != "index_exact" or not frontiers_identical(
                a.frontier(), fresh.frontiers[(w.arch, w.shape)]):
            raise AssertionError(f"{w.arch}|{w.shape}: index hit != the "
                                 "offline frontier")
    space = engine.space
    if lone.verified_gidx.size != len(space) or not frontiers_identical(
            lone.frontier(), again.frontier()):
        raise AssertionError("lone query: slice or repeat differs")
    t = time.perf_counter()
    standalone = Campaign([novel[0]], cfg).run()
    standalone_s = time.perf_counter() - t
    if not frontiers_identical(
            lone.frontier(), standalone.frontiers[(novel[0].arch,
                                                   novel[0].shape)]):
        raise AssertionError("full-space mini-campaign != standalone "
                             "Campaign.run")
    for w, got, solo in zip(novel, batched, seq_answers):
        if not frontiers_identical(got.frontier(), solo.frontier()):
            raise AssertionError(f"{w.arch}|{w.shape}: batched != sequential")
    w0 = workloads[0]
    tight_run = Campaign([w0], cfg.replace(constraint=tight)).run()
    if not frontiers_identical(over.frontier(),
                               tight_run.frontiers[(w0.arch, w0.shape)]):
        raise AssertionError("constraint override != standalone campaign")
    if degraded.provenance != "predictor_only" \
            or degraded.degraded_reason != "deadline" \
            or any(c.exact for c in degraded.choices):
        raise AssertionError("deadline 0 did not degrade to predictor_only")
    gidx = pruned.verified_gidx
    if not 0 < gidx.size < len(space):
        raise AssertionError(f"pruned slice of {gidx.size}")
    if not frontiers_identical(pruned.frontier(),
                               slice_frontier(novel[0], pcfg, space, gidx)):
        raise AssertionError("pruned answer != direct evaluation of its "
                             "slice")

    # the same exact-path queries on the CPU: the kernels' plain versions
    t = time.perf_counter()
    cpu = SelectionEngine(index, device="cpu")
    cpu_pairs = [(lone, cpu.select(novel[0]))]
    for w in novel:
        cpu.submit(w)
    cpu_pairs += list(zip(batched[:6], cpu.flush()))
    cpu_pairs.append((over, cpu.select(w0, constraint=tight)))
    cpu_s = time.perf_counter() - t
    bitwise = True
    for card, host_answer in cpu_pairs:
        if not same_candidate_set(card.frontier(), host_answer.frontier()):
            raise AssertionError(f"{card.workload.arch}|"
                                 f"{card.workload.shape}: card != CPU")
        bitwise &= frontiers_identical(card.frontier(),
                                       host_answer.frontier())

    cases, plans, timing = select_kernel_checks(workloads, novel, cons, gidx,
                                                device)
    lone_t = timing[("f64", 1)]
    lone_busy = lone_t["fused_device_ms"] or lone_t["fused_ms"]
    if deltas["lone_warm"].get("dse_sweep_f64"):
        lone_busy += lone_t["sweep_device_ms"] or lone_t["sweep_ms"]
    hit_wall = [a.wall_s * 1e3 for _, a in hits]
    emit({"phase": "selection", "candidates": len(space),
          "index": {"families": len(index), "evaluator": index.evaluator,
                    "dtype": index.dtype, "bytes": index_bytes,
                    "build_save_load_s": index_s},
          "engine": {"evaluator": cfg.evaluator, "dtype": "float64",
                     "device": str(cfg.device),
                     "verify_top": SELECT_VERIFY_TOP},
          "novel_census": f"each workload's census x U{NOVEL_SCALE} "
                          f"(seed {seed + 1})",
          "provenances": {"engine": engine.stats,
                          "predictor_engine": pengine.stats,
                          "sequential": seq.stats},
          "index_hits_identical_to_offline": True,
          "full_space_equals_standalone_campaign": True,
          "flush_fused_launches": flush_launches,
          "sequential_fused_launches": seq.fused_launches,
          "batched_equals_sequential": True,
          "constraint_override_equals_campaign": True,
          "pruned_slice": {"size": int(gidx.size),
                           "equals_direct_evaluation": True},
          "card_vs_cpu_candidate_sets_identical": True,
          "card_vs_cpu_bitwise": bool(bitwise),
          "minicampaign_failures": 0,
          "launch_deltas": deltas, "launches": launches,
          "latency_ms": {
              "index_exact": latency_summary(ms["index_exact"]),
              "index_exact_answer_wall": latency_summary(hit_wall),
              **{k: v for k, v in ms.items()
                 if k not in ("index_exact", "sequential")},
              "sequential": latency_summary(ms["sequential"])},
          "spans_ms": span_stats(tel, ("index_lookup", "mini_campaign",
                                       "pad", "launch", "compact")),
          "predictor_spans_ms": span_stats(ptel, (
              "predictor_only", "mini_campaign", "pad", "launch",
              "compact")),
          "lone_query_device_idle_share": 1.0 - lone_busy
          / ms["mini_campaign_warm"],
          "standalone_campaign_s": standalone_s, "cpu_engine_s": cpu_s,
          "seconds": time.perf_counter() - t_phase,
          "k1_cases": cases, "k1_plans": plans,
          "k1_n125440": [{"dtype": k[0], **v} for k, v in timing.items()],
          "timing_note": "latency_ms: host clock around select() / flush() "
                         "ending in a synchronize; *_first includes building "
                         "the space's 125,440 Candidate objects once; "
                         "k1_n125440: fused_ms CUDA events around the launch "
                         "alone, fused_tile_ms the wrapper (launch, copy, "
                         "sync), *_device_ms torch.profiler; idle share: 1 - "
                         "(fused [+ K1 alone if the row overflowed] device "
                         "ms) / the warm lone query's host ms"})
    return {"launches": launches, "timing": timing}


# --- the distributed campaign fabric -------------------------------------------

# the scaling run: its worker counts, and the DVFS lattice that takes the
# default chips and slice sizes to ~1 M candidates (392 rows x 2,560 points:
# 1,003,520 candidates, 245 tiles of 4,096)
FABRIC_WORKERS = (1, 2, 4)
FABRIC_FREQ_POINTS = 2_560
FABRIC_CHAOS_SEED = 7
FABRIC_COUNTS = ("lost_workers", "worker_crashes", "worker_clean_exits",
                 "deliveries", "duplicates", "reissued_tiles")


def fabric_config(space, dtype, device, **kw) -> CampaignConfig:
    return CampaignConfig(space=space, evaluator="cuda", dtype=dtype,
                          device=device,
                          constraint=dse.Constraint(max_power_w=40_000), **kw)


def check_frontiers(got, want, what: str) -> None:
    for key in want:
        if not frontiers_identical(got[key], want[key]):
            raise AssertionError(f"fabric {what}: {key} frontier differs "
                                 "from the single-process run")


def check_launches(got: dict, want: dict, what: str) -> None:
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"fabric {what}: launches {got}, expected "
                             f"{want}")


def per_worker_launches(metrics: dict) -> dict:
    """Each worker's nonzero kernel launches, from its terminal snapshot."""
    return {w: {k: v for k, v in worker_launches({w: snap}).items() if v}
            for w, snap in sorted(metrics.items())}


def fabric_row(stats: dict, tel: Telemetry) -> dict:
    """A fleet's counts, its clocks, and the coordinator's ``merge`` (from
    ``tel``, the campaign's telemetry) per delivery and as a share of the
    window."""
    merge = sum(r.dur for r in tel.tracer.records if r.name == "merge")
    return {**{k: stats[k] for k in FABRIC_COUNTS},
            "spawn_to_ready_s": stats["spawn_to_ready_s"],
            "window_s": stats["window_s"], "shutdown_s": stats["shutdown_s"],
            "merge_ms_per_tile": 1e3 * merge / max(stats["deliveries"], 1),
            "merge_share_of_window": merge / stats["window_s"],
            "worker_busy_cpu_s": stats["worker_busy_s"],
            "worker_launches": per_worker_launches(stats["worker_metrics"])}


def run_fabric(workloads, cfg, n_workers: int, checkpoint_path=None,
               **fabric_kw):
    """One ``MultiprocessFabric`` run, traced; returns its result and
    ``fabric_row``."""
    tel = Telemetry()
    fab = MultiprocessFabric(Campaign(workloads, cfg, telemetry=tel),
                             n_workers=n_workers, **fabric_kw)
    res = fab.run(checkpoint_path=checkpoint_path)
    if not res.complete or res.tiles_done != res.n_tiles:
        raise AssertionError(f"fabric run stopped at {res.tiles_done} of "
                             f"{res.n_tiles} tiles")
    return res, fab.stats, fabric_row(fab.stats, tel)


def phase_fabric(workloads, device, main_path, adaptive, space=None,
                 scaling_space=None) -> dict:
    """The distributed campaign layer on one card: ``spawn`` workers, each
    with its own CUDA context, evaluating tiles through the fused K1 and
    shipping ``TileReduction``s to the coordinator (this process).
    (a) 2 workers, float64, a worker killed after one tile and a duplicated
    delivery, checkpoints every 4 tiles, a mid-run checkpoint resumed by a
    plain ``Campaign``; (b) the same clean in float32; (c) one worker
    killed after one tile and respawned; (d) the distributed adaptive
    campaign, clean and with a worker crash; (e) a seeded chaos policy on
    the in-process fleet; (f) 1, 2 and 4 workers over ~1 M candidates.
    Every frontier is held bitwise against the single-process run's.
    Counts are zeroed just before (a) and read just after (f) in this
    process; each worker ships its own in its terminal snapshot (a worker
    that was killed ships none)."""
    t_phase = time.perf_counter()
    space = space or default_campaign_space()
    scaling_space = scaling_space or dataclasses.replace(
        default_campaign_space(), freq_points=FABRIC_FREQ_POINTS)
    n_tiles = space.n_tiles()
    f64, f32 = torch.float64, torch.float32
    fresh64, fresh32 = main_path["fresh64"], main_path["fresh32"]
    metrics = []        # every worker snapshot of the phase, for the sum
    out, seconds = {}, {}
    kern.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) faults at 2 workers
        t = time.perf_counter()
        ckpt = os.path.join(tmp, "fabric.json")
        res, st, row = run_fabric(
            workloads, fabric_config(space, f64, device), 2,
            checkpoint_path=ckpt, checkpoint_every=4,
            fault=FaultInjection(kill_worker=1, kill_after_tiles=1,
                                 duplicate=True))
        metrics.append(st["worker_metrics"])
        check_frontiers(res.frontiers, fresh64.frontiers, "(a)")
        for key in res.frontiers:
            if not same_candidate_set(res.frontiers[key],
                                      main_path["exact"].frontiers[key]):
                raise AssertionError(f"fabric (a): {key} candidate set "
                                     "differs from the torch tier's")
        if (st["lost_workers"] != [1] or st["duplicates"] != 1
                or st["reissued_tiles"] < 1):
            raise AssertionError(f"fabric (a): faults did not fire as "
                                 f"scripted: {row}")
        done = _expand_intervals(store.load_checkpoint(ckpt)["fabric"]["done"])
        if done != list(range(n_tiles)):
            raise AssertionError(f"fabric (a): final checkpoint done {done}")
        # the oldest generation kept is a mid-run checkpoint
        mid = os.path.join(tmp, "mid.json")
        with open(store.generation_paths(ckpt)[0][1]) as src, \
                open(mid, "w") as dst:
            dst.write(src.read())
        resumed = Campaign.from_checkpoint(mid, device=device)
        mid_tile = resumed.next_tile
        if not 0 < mid_tile < n_tiles:
            raise AssertionError(f"fabric (a): checkpoint at {mid_tile} is "
                                 "not mid-run")
        final = resumed.run()
        check_frontiers(final.frontiers, fresh64.frontiers, "(a) resumed")
        out["a_faults_2_workers"] = {**row, "resumed_from_tile": mid_tile}
        seconds["a"] = time.perf_counter() - t

        # (b) float32, clean
        t = time.perf_counter()
        res, st, row = run_fabric(workloads,
                                  fabric_config(space, f32, device), 2)
        metrics.append(st["worker_metrics"])
        check_frontiers(res.frontiers, fresh32.frontiers, "(b)")
        if st["lost_workers"] or st["reissued_tiles"]:
            raise AssertionError(f"fabric (b): a clean run lost workers "
                                 f"{row}")
        out["b_float32_2_workers"] = row
        seconds["b"] = time.perf_counter() - t

        # (c) the only worker killed after one tile, then respawned
        t = time.perf_counter()
        tel = Telemetry()
        camp = Campaign(workloads, fabric_config(
            space, f64, device, n_workers=1, lease_timeout_s=60.0),
            telemetry=tel)
        res, st = run_distributed(
            camp, fault=FaultInjection(kill_worker=0, kill_after_tiles=1),
            retry=RetryPolicy(base_s=0.05, max_s=0.2), max_respawns=2)
        metrics.append(st["worker_metrics"])
        check_frontiers(res.frontiers, fresh64.frontiers, "(c)")
        snap = tel.snapshot()
        counters = {k: metric_value(snap, k, default=0) for k in (
            "fabric_worker_crashed", "fabric_worker_done",
            "fabric_worker_respawns_total")}
        if (st["worker_crashes"] != [0] or st["worker_clean_exits"] != [1]
                or counters != {"fabric_worker_crashed": 1,
                                "fabric_worker_done": 1,
                                "fabric_worker_respawns_total": 1}):
            raise AssertionError(f"fabric (c): crash / clean exit counters "
                                 f"{st} {counters}")
        out["c_respawn_1_worker"] = {**fabric_row(st, tel),
                                     "counters": counters}
        seconds["c"] = time.perf_counter() - t

        # (d) the distributed adaptive campaign, clean and with a crash
        single = adaptive["result"]
        cfg = adaptive["config"].replace(n_workers=2)
        for name, fault in (("clean", None), ("worker_crash", FaultInjection(
                kill_worker=1, kill_after_tiles=0))):
            t = time.perf_counter()
            dr, st = run_adaptive_distributed(workloads, cfg, fault=fault)
            metrics.append(st["worker_metrics"])
            if (dr.rounds != single.rounds
                    or dr.hv_history != single.hv_history
                    or dr.stopped_on != single.stopped_on):
                raise AssertionError(
                    f"fabric (d) {name}: rounds {dr.rounds} "
                    f"{dr.hv_history} {dr.stopped_on} != single-process "
                    f"{single.rounds} {single.hv_history} "
                    f"{single.stopped_on}")
            check_frontiers(dr.frontiers, single.frontiers, f"(d) {name}")
            per_worker = per_worker_launches(st["worker_metrics"])
            if fault is None:
                # each tile: the fused K1 + K1 alone for its training
                # sample, in the worker that evaluated it; plus one warm-up
                # tile (both launches) a worker
                want = dr.tiles_evaluated + 2
                check_launches(worker_launches(st["worker_metrics"]),
                               {"sweep_reduce_f64": want,
                                "dse_sweep_f64": want}, "(d) clean")
            elif st["lost_workers"] != [1] or st["reissued_tiles"] < 1:
                raise AssertionError(f"fabric (d) {name}: the crash did not "
                                     f"fire: {st}")
            out[f"d_adaptive_{name}"] = {
                "rounds": dr.rounds, "stopped_on": dr.stopped_on,
                "tiles_evaluated": dr.tiles_evaluated,
                **{k: st[k] for k in ("lost_workers", "deliveries",
                                      "duplicates", "reissued_tiles")},
                "worker_launches": per_worker,
                "seconds": time.perf_counter() - t}
        seconds["d"] = sum(out[f"d_adaptive_{n}"]["seconds"]
                           for n in ("clean", "worker_crash"))

        # (e) a seeded chaos policy on the in-process fleet
        t = time.perf_counter()
        policy = ChaosPolicy.random(FABRIC_CHAOS_SEED, n_events=6,
                                    horizon=n_tiles)
        res, report = ChaosRunner(
            workloads, fabric_config(space, f64, device), policy).run(
                os.path.join(tmp, "chaos.json"))
        check_frontiers(res.frontiers, fresh64.frontiers, "(e) chaos")
        out["e_chaos"] = {
            "policy": policy.to_dict(),
            "report": {k: v for k, v in report.items()
                       if k not in ("recoveries", "quarantined_files",
                                    "events_fired")},
            "events_fired": [(e["completion"], e["kind"])
                             for e in report["events_fired"]],
            "quarantined_files": len(report["quarantined_files"])}
        seconds["e"] = time.perf_counter() - t

    # (f) scaling: 1, 2, 4 clean workers over ~1 M candidates
    scaling, first = [], None
    for n in FABRIC_WORKERS:
        t = time.perf_counter()
        before = kern.launch_counts()
        res, st, row = run_fabric(workloads, fabric_config(
            scaling_space, f64, device), n)
        metrics.append(st["worker_metrics"])
        here = kern.launch_counts()
        check_launches({k: here[k] - before[k] for k in here},
                       {k: 0 for k in here}, f"(f) {n} workers, coordinator")
        check_launches(worker_launches(st["worker_metrics"]),
                       {"sweep_reduce_f64": res.n_tiles + st["reissued_tiles"]
                        + n}, f"(f) {n} workers")
        if st["lost_workers"]:
            raise AssertionError(f"fabric (f): lost {st['lost_workers']}")
        if first is None:
            first = res
        check_frontiers(res.frontiers, first.frontiers,
                        f"(f) {n} workers vs 1")
        scaling.append({"workers": n, **row,
                        "tiles_per_s": res.n_tiles / st["window_s"],
                        "seconds": time.perf_counter() - t})
    seconds["f"] = sum(r["seconds"] for r in scaling)

    coordinator = kern.launch_counts()
    workers = {k: sum(worker_launches(m)[k] for m in metrics)
               for k in coordinator}
    launches = {k: coordinator[k] + workers[k] for k in coordinator}
    emit({"phase": "fabric", "candidates": len(space), "tiles": n_tiles,
          "workloads": len(workloads),
          "scaling_candidates": len(scaling_space),
          "scaling_tiles": scaling_space.n_tiles(),
          **out, "f_scaling": scaling,
          "launches": launches, "launches_in_coordinator": coordinator,
          "launches_in_workers": workers, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase,
          "timing_note": "spawn_to_ready_s: host clock from the first spawn "
                         "until every worker signalled ready (imports, its "
                         "CUDA context, the kernel library, one warm-up "
                         "tile); window_s: from then to the last fold, the "
                         "shutdown (shutdown_s: stop messages, snapshots, "
                         "process exits) excluded; "
                         "worker_busy_cpu_s: each worker's "
                         "time.process_time over its tiles (host CPU, "
                         "including the spin in the synchronise); "
                         "merge_ms_per_tile: the coordinator's merge span "
                         "per delivery; frontiers bitwise the "
                         "single-process runs (campaign_default, "
                         "adaptive)"})
    return {"launches": launches}


# --- token serving -------------------------------------------------------------

# (run, arch, dtype, slots, requests, prompt lengths [lo, hi], new tokens,
# max_len): max_len covers every decode of the run, since each prompt token
# is one [slots, 1] decode of the shared cache position
TOKEN_RUNS = (
    ("stablelm_bf16", "stablelm_1_6b", torch.bfloat16, 4, 8, (4, 32), 16,
     512),
    ("mamba2_bf16", "mamba2_130m", torch.bfloat16, 4, 8, (4, 16), 8, 256),
)


def token_requests(vocab: int, n: int, lens, max_new: int, seed: int):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        1, vocab, int(rng.integers(lens[0], lens[1] + 1))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def serve_requests(model, module, slots, max_len, reqs, device):
    eng = ServingEngine(model, slots=slots, max_len=max_len, device=device)
    eng.load(module)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, stats


# engine-shaped decode calls in the window the idle share is read over
# (profiling a whole run's ~250 calls x ~700 kernels took minutes)
IDLE_WINDOW = 16


def decode_call_window(model, module, slots: int, max_len: int,
                       device) -> dict:
    """The engine's unit of work, timed: ``IDLE_WINDOW`` decode calls of a
    [slots, 1] batch (one live slot, pad token 0 in the others), each read
    back to the host as the engine reads its logits.  Host ms per call
    (median of ``HOST_REPEATS`` windows, each on a fresh cache) and the
    device ms per call of one more window under the profiler; idle =
    1 - device / host."""
    def window():
        cache = model.init_cache(slots, max_len, device=device)
        toks = np.zeros((slots, 1), np.int32)
        for i in range(IDLE_WINDOW):
            toks[0, 0] = 1 + i
            logits, cache = model.decode(
                module, {"tokens": torch.from_numpy(toks)}, cache)
            logits[0, -1].cpu().numpy()

    host = host_ms(window, iters=HOST_REPEATS, warmup=1)
    dev = device_total_ms(window, reps=1)
    per_call = host["median"] / IDLE_WINDOW
    return {"host_ms_per_call": per_call, "host_spread": host,
            "device_ms_per_call": None if dev is None else dev / IDLE_WINDOW,
            "device_idle_share": None if dev is None
            else 1.0 - dev / host["median"]}


def phase_token_serving(device, seed: int) -> dict:
    """The token ``ServingEngine`` at full width: stablelm-1.6b bf16, then
    mamba2-130m bf16 (shorter).  Each run: the requests through the engine
    (K3 and K4 counted: a decode runs neither), every request complete,
    the shared cache position inside ``max_len``; the device's idle share
    over a window of engine-shaped decode calls; request 0 alone in one
    slot against a direct per-token decode loop, token for token."""
    t_phase, rows = time.perf_counter(), []
    for run, arch, dtype, slots, n, lens, max_new, max_len in TOKEN_RUNS:
        cfg = dataclasses.replace(get_config(arch),
                                  dtype=str(dtype).split(".")[-1])
        model = build_model(cfg)
        module = model.init(torch.Generator(device=device).manual_seed(seed),
                            device=device)
        reqs = token_requests(cfg.vocab_size, n, lens, max_new, seed)
        before = sum(k3.launch_counts().values()) + sum(
            k4.launch_counts().values())
        eng, stats = serve_requests(model, module, slots, max_len, reqs,
                                    device)
        kernel_launches = sum(k3.launch_counts().values()) + sum(
            k4.launch_counts().values()) - before
        decodes = int(eng.cache["len"])
        if kernel_launches or not all(
                r.done and len(r.tokens_out) == max_new for r in reqs):
            raise AssertionError(f"{run}: {kernel_launches} K3 / K4 "
                                 "launches, or requests unfinished")
        if decodes >= max_len or not all(
                0 <= t < cfg.vocab_size for r in reqs for t in r.tokens_out):
            raise AssertionError(f"{run}: {decodes} decodes (max_len "
                                 f"{max_len}) or a token off the vocabulary")
        idle = decode_call_window(model, module, slots, max_len, device)
        # request 0 alone in one slot == a direct per-token decode loop
        prompt = reqs[0].prompt
        lone = Request(rid=0, prompt=prompt, max_new_tokens=max_new)
        serve_requests(model, module, 1, len(prompt) + max_new, [lone],
                       device)
        cache = model.init_cache(1, len(prompt) + max_new, device=device)
        for t in prompt:
            logits, cache = model.decode(
                module, {"tokens": torch.tensor([[int(t)]],
                                                dtype=torch.int32)}, cache)
        toks = [int(np.argmax(logits[0, -1].cpu().numpy()))]
        while len(toks) < max_new:
            logits, cache = model.decode(
                module, {"tokens": torch.tensor([[toks[-1]]],
                                                dtype=torch.int32)}, cache)
            toks.append(int(np.argmax(logits[0, -1].cpu().numpy())))
        if lone.tokens_out != toks:
            raise AssertionError(f"{run}: engine {lone.tokens_out} != direct "
                                 f"decode {toks}")
        lat = [(r.finished_s - r.arrived_s) * 1e3 for r in reqs]
        ttft = [(r.first_token_s - r.arrived_s) * 1e3 for r in reqs]
        wall_ms = stats["wall_s"] * 1e3
        rows.append({
            "run": run, "arch": arch, "dtype": SUFFIX[dtype],
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "slots": slots, "requests": n,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "max_new_tokens": max_new, "max_len": max_len,
            "decode_calls": decodes,
            "completed": sum(r.done for r in reqs),
            "decoded_tokens": stats["decoded_tokens"],
            "wall_s": stats["wall_s"], "tokens_per_s": stats["tok_per_s"],
            "ms_per_decode_call": wall_ms / decodes,
            "mean_latency_ms": float(np.mean(lat)),
            "mean_time_to_first_token_ms": float(np.mean(ttft)),
            "decode_call_window": idle,
            "device_idle_share": idle["device_idle_share"],
            "k3_k4_launches": kernel_launches,
            "engine_equals_direct_decode": True,
            "direct_decode_tokens": len(toks)})
        del module, eng
        torch.cuda.empty_cache()
    emit({"phase": "token_serving", "runs": rows,
          "seconds": time.perf_counter() - t_phase,
          "note": "ServingEngine: every prompt token is a [slots, 1] "
                  "decode of the shared cache position, so decode_calls = "
                  "prompt tokens + engine steps; tokens_per_s: the "
                  "engine's generated tokens over run_until_drained's wall "
                  "(host clock); decode_call_window: "
                  f"{IDLE_WINDOW} [slots, 1] decode calls each read back "
                  "to the host, as the engine makes them: host ms (median "
                  "of 5 windows) and profiled device ms, idle = 1 - "
                  "device / host"})
    return {"runs": rows}


# --- ResNet-50 inference ----------------------------------------------------

CONV_DTYPES = (torch.float32, torch.bfloat16)
# every kernel of a K2 call (tensor-core, float32, SIMT, split-K sum) and
# no library kernel has this in its name
K2_SYMBOL = "k2_conv2d_"
# K2 vs conv2d_plain, max |diff| over the scale max |plain|: float32 sums of
# up to 4608 terms in another order (FMA-contracted) stay near 1e-6; a bf16
# output may round the other way, one bf16 ulp, 2^-7 of the value at most
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# kernel-path vs plain-path logits over their scale, after 53 convolutions:
# bf16 rounding flips in one layer feed every later one
LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# (B, H=W, Cin, Cout, k) of tests/test_kernels.py's conv2d cases
TEST_SHAPES = ((2, 16, 8, 16, 3), (2, 16, 4, 8, 1), (2, 24, 8, 8, 5))
# (B, H, W, Cin, Cout, k, misaligned): Cin and Cout not multiples of 64, M
# not a multiple of the tile, a Cout below one 64-wide box, 5x5; Cin = 12
# (bf16: SIMT) and 5 / Cout 7 (float32: 4-byte copies); x a view one
# element into its storage (bf16: SIMT, float32: 4-byte copies)
RAGGED_SHAPES = ((3, 13, 11, 72, 40, 3, False), (1, 9, 9, 24, 136, 1, False),
                 (2, 7, 5, 200, 8, 3, False), (1, 10, 9, 64, 72, 5, False),
                 (1, 5, 6, 12, 20, 3, False), (2, 6, 6, 5, 7, 3, False),
                 (2, 9, 9, 64, 64, 3, True), (1, 7, 7, 96, 64, 1, True))
# ResNet-50's stride-1 shapes are checked at these batch sizes
CONV_BATCHES = (1, 8, 32)

def conv_bound(x_shape, w_shape, y_shape, dtype) -> dict:
    """Least time for one convolution: each of x, w, y moved once, and
    2*M*N*K operations at the dtype's peak (bf16: the tensor cores)."""
    s = torch.finfo(dtype).bits // 8
    numel = [int(np.prod(t)) for t in (x_shape, w_shape, y_shape)]
    kh, kw, cin, _ = w_shape
    return bound(sum(numel) * s, 2 * numel[2] * kh * kw * cin, dtype)


def k2_calls(model, images) -> list:
    """(x shape, w shape, padding) of every call the K2 wrapper receives in
    one forward of ``model``, in order: the stride-1 convolutions of the
    network that runs.  The forward launches K2."""
    calls, real = [], k2.conv2d

    def spy(x, w, *, padding):
        calls.append((tuple(x.shape), tuple(w.shape), padding))
        return real(x, w, padding=padding)

    with mock.patch.object(k2, "conv2d", spy):
        model(images)
    return calls


def conv_case(x, w, pads, dtype) -> dict:
    """K2 against its plain version on the same inputs; raises on
    disagreement."""
    y = k2.conv2d(x, w, padding=pads)
    again = k2.conv2d(x, w, padding=pads)
    yp = k2.conv2d_plain(x, w, padding=pads)
    torch.cuda.synchronize()
    if y.shape != yp.shape or y.dtype != dtype:
        raise AssertionError(f"K2 returned {y.shape} {y.dtype}")
    if not torch.equal(y, again):
        raise AssertionError(f"K2 {tuple(x.shape)} x {tuple(w.shape)} "
                             f"{dtype}: two runs on the same inputs differ")
    if not torch.isfinite(y.float()).all():
        raise AssertionError("K2 returned non-finite values")
    err = float((y.float() - yp.float()).abs().max())
    scale = float(yp.float().abs().max())
    rel = err / scale
    if rel > CONV_TOL[dtype]:
        raise AssertionError(f"K2 {tuple(x.shape)} x {tuple(w.shape)} "
                             f"{dtype}: max err {err} / scale {scale} = "
                             f"{rel} > {CONV_TOL[dtype]}")
    p = k2.plan_for(x, w, pads)
    return {"x": list(x.shape), "w": list(w.shape), "dtype": SUFFIX[dtype],
            "max_abs_err": err, "rel_err": rel, "repeat_bitwise_equal": True,
            "plan": {"variant": p.variant, "tile": [p.bm, p.bn],
                     "split": p.split, "grid": list(p.grid),
                     "gather": p.gather, "vec": p.vec}}


def simt_timing(x, w, pads, dtype) -> dict:
    """K2's time on one shape beside its plain version's, the library's,
    the bound and its device time."""
    b = conv_bound(tuple(x.shape), tuple(w.shape),
                   tuple(x.shape[:3]) + (w.shape[3],), dtype)
    us = device_us({"k2": (lambda: k2.conv2d(x, w, padding=pads),
                           K2_SYMBOL)})
    return {"ms": time_ms(lambda: k2.conv2d(x, w, padding=pads), 20),
            "plain_ms": time_ms(lambda: k2.conv2d_plain(x, w, padding=pads),
                                5),
            "library_ms": time_ms(lambda: library_conv2d(x, w,
                                                         padding=pads), 20),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "device_ms": None if us["k2"] is None else us["k2"] / 1e3}


_OHWI = {}


def library_conv2d(x, w, *, padding):
    """K2's signature on the library: one ``F.conv2d`` (cuDNN) on a
    channels-last view of the NHWC input, the HWIO weight laid out OHWI once
    per weight and kept; the result is NHWC without a copy.  The yardstick,
    alone and in place of K2 inside a forward; never part of the port."""
    (pt, pb), (pl, pr) = padding
    if (pt, pl) != (pb, pr):
        raise ValueError(f"asymmetric padding {padding}")
    key = (w.data_ptr(), tuple(w.shape), w.dtype)
    if key not in _OHWI:          # w is kept too, so its address stays its own
        _OHWI[key] = (w, w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2))
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), _OHWI[key][1],
                                   padding=(pt, pl))
    return y.permute(0, 2, 3, 1).contiguous()


def conv_inputs(gen, device, xs, ws, dtype, scale=None, misaligned=False):
    """x ~ N(0, 1) and He-scaled w (``scale`` overrides) on the card in
    ``dtype``; ``misaligned`` puts x one element into its storage (a
    contiguous view off the 16-byte boundary)."""
    x = torch.randn(xs, generator=gen, device=device).to(dtype)
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(xs)
    if scale is None:
        scale = (2.0 / (ws[0] * ws[1] * ws[2])) ** 0.5
    w = (torch.randn(ws, generator=gen, device=device) * scale).to(dtype)
    return x, w


def phase_conv2d(device, seed: int, model, images) -> dict:
    """K2 against conv2d_plain, with a second run that must give the same
    bits, on each distinct stride-1 shape of ResNet-50 (read off one
    forward of ``model`` on ``images``) at B = 1, 8 and 32, on the
    test_kernels.py shapes and on a ragged set, float32 and bf16, each with
    its launch plan; then K2's time, the library's and the bound on every
    ResNet-50 shape at B=32, alone, and the plain version's and the device
    time on the heaviest."""
    shapes = {}
    for xs, ws, _ in k2_calls(model, images):
        shapes[(xs, ws)] = shapes.get((xs, ws), 0) + 1
    heavy = max(shapes, key=lambda k: conv_bound(
        k[0], k[1], k[0][:3] + (k[1][3],), torch.float32)["operations"])
    gen = torch.Generator(device=device).manual_seed(seed)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # float32 library = IEEE
    cases, per_dtype = [], {}
    try:
        for dtype in CONV_DTYPES:
            rows, errs = [], []
            for (xs32, ws), count in shapes.items():
                pads = ((ws[0] // 2, (ws[0] - 1) // 2),) * 2
                for batch in CONV_BATCHES:
                    xs = (batch,) + xs32[1:]
                    x, w = conv_inputs(gen, device, xs, ws, dtype)
                    case = conv_case(x, w, pads, dtype)
                    errs.append(case["rel_err"])
                    if batch != 32:
                        cases.append({"case": f"resnet50_b{batch}", **case})
                        continue
                    b = conv_bound(xs, ws, xs[:3] + (ws[3],), dtype)
                    lib_err = float((library_conv2d(x, w, padding=pads).float()
                                     - k2.conv2d_plain(x, w, padding=pads)
                                     .float()).abs().max())
                    row = {**case, "launches_per_forward": count,
                           "ms": time_ms(lambda: k2.conv2d(
                               x, w, padding=pads), 20),
                           "library_ms": time_ms(lambda: library_conv2d(
                               x, w, padding=pads), 20),
                           "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                           "library_max_abs_err": lib_err}
                    if (xs, ws) == heavy:
                        row["plain_ms"] = time_ms(
                            lambda: k2.conv2d_plain(x, w, padding=pads), 5)
                        us = device_us({"k2": (
                            lambda: k2.conv2d(x, w, padding=pads),
                            K2_SYMBOL)})
                        row["device_ms"] = (None if us["k2"] is None
                                            else us["k2"] / 1e3)
                        per_dtype[dtype] = {"heavy": row}
                    rows.append(row)
            for (b_, hw, cin, cout, kh) in TEST_SHAPES:
                x, w = conv_inputs(gen, device, (b_, hw, hw, cin),
                                   (kh, kh, cin, cout), dtype, scale=0.1)
                pads = ((kh // 2, (kh - 1) // 2),) * 2
                cases.append({"case": "test_kernels",
                              **conv_case(x, w, pads, dtype)})
            for (b_, h, wd, cin, cout, kh, off) in RAGGED_SHAPES:
                x, w = conv_inputs(gen, device, (b_, h, wd, cin),
                                   (kh, kh, cin, cout), dtype,
                                   misaligned=off)
                pads = ((kh // 2, (kh - 1) // 2),) * 2
                case = conv_case(x, w, pads, dtype)
                if case["plan"]["variant"] == k2.SIMT and \
                        "simt" not in per_dtype[dtype]:
                    # the SIMT kernel, off the main path, timed at its
                    # first ragged shape
                    case.update(simt_timing(x, w, pads, dtype))
                    per_dtype[dtype]["simt"] = case
                cases.append({"case": "ragged_misaligned" if off
                              else "ragged", **case})
            per_dtype[dtype]["max_rel_err"] = max(errs)
            cases += [{"case": "resnet50_b32", **r} for r in rows]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    variants = sorted({c["plan"]["variant"] for c in cases})
    if variants != sorted(k2.LAUNCHES):
        raise AssertionError(f"the conv2d phase ran the variants {variants}, "
                             f"not all of {sorted(k2.LAUNCHES)}")
    emit({"phase": "conv2d", "distinct_shapes": len(shapes),
          "launches_per_forward": sum(shapes.values()),
          "batches": list(CONV_BATCHES),
          "heaviest": {"x": list(heavy[0]), "w": list(heavy[1])},
          "tolerance_rel_to_scale": {SUFFIX[d]: CONV_TOL[d]
                                     for d in CONV_DTYPES},
          "cases": cases,
          "timing_note": "each B=32 shape alone: ms / library_ms are CUDA "
                         "events around 20 back-to-back calls after warm-up "
                         "(launch and wrapper included, inputs L2-warm); "
                         "library = F.conv2d (cuDNN, channels-last, TF32 "
                         "off); every case ran twice, bitwise equal"})
    return per_dtype


# host-clock readings: at least this many, reported as median, min, max
HOST_REPEATS = 5


def spread(ms: list) -> dict:
    """The median of host-clock readings in ms, with their min, max and
    count."""
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "n": len(ms)}


def host_ms(fn, iters: int = HOST_REPEATS, warmup: int = 3) -> dict:
    """Host-clock milliseconds of each of ``iters`` (at least
    ``HOST_REPEATS``) calls of ``fn``, each ending in a synchronize (the
    latency a caller sees), after ``warmup`` calls: ``spread`` of them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(iters, HOST_REPEATS)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return spread(times)


def enqueue_ms(fn, iters: int = HOST_REPEATS) -> dict:
    """Host-clock milliseconds until ``fn`` returns, WITHOUT a synchronize
    inside the timed region (each call starts on an idle device): the time
    the host takes to issue the call's kernels, ``spread`` over ``iters``
    calls.  Close to ``host_ms`` means the device waited on the host, or
    something in ``fn`` synchronized."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(iters, HOST_REPEATS)):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return spread(times)


def decode_window_ms(start, step, steps: int,
                     windows: int = HOST_REPEATS) -> dict:
    """Host-clock milliseconds per step of a window of ``steps`` greedy
    decode steps issued back to back, one synchronize at the window's end
    (the rate a generating caller sees, stalls included): ``spread`` over
    ``windows`` (at least ``HOST_REPEATS``) windows, each from the state
    ``start()`` sets up outside the timed region.  ``step()`` runs one
    step."""
    per_step = []
    for _ in range(max(windows, HOST_REPEATS)):
        start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3 / steps)
    return spread(per_step)


def decode_latency_ms(start, step, steps: int) -> dict:
    """Host-clock milliseconds of each of ``steps`` (at least
    ``HOST_REPEATS``) greedy decode steps from the state ``start()`` sets
    up, each ending in a synchronize (the latency of one step): ``spread``
    of them."""
    if steps < HOST_REPEATS:
        raise ValueError(f"{steps} decode steps: at least {HOST_REPEATS}")
    start()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return spread(times)


# calls a profile averages over where a library takes a kernel's place:
# the signed difference of two profiles is only as steady as each total
LIBRARY_REPS = 3


def swapped_calls_device_ms(br: dict, lib_br: dict) -> float:
    """Device ms of the library's calls that took a kernel's place: what the
    ``device_breakdown`` of the run with the library (``lib_br``) spent
    outside the kernel, less what the run with the kernel (``br``) spent
    outside it -- a signed sum over kernel names, so the run-to-run noise of
    the kernels both runs share cancels rather than adds up."""
    return ((lib_br["device_ms"] - lib_br["kernel_device_ms"])
            - (br["device_ms"] - br["kernel_device_ms"]))


def device_breakdown(fn, symbol: str, reps: int = 1) -> dict:
    """Device time of one call of ``fn`` by kernel, from torch.profiler,
    averaged over ``reps`` calls in one profile: the total, the time and
    share of the kernels whose name holds ``symbol``, and the largest
    kernels.  None where the profiler reports no device time on this
    machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))) / reps
        by_name[ev.key] = by_name.get(ev.key, 0.0) + us
    total = sum(by_name.values())
    if total <= 0:
        return {"device_ms": None, "kernel_device_ms": None,
                "kernel_share": None, "top": [], "by_name": {}}
    k_us = sum(v for k, v in by_name.items() if symbol in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": total / 1e3, "kernel_device_ms": k_us / 1e3,
            "kernel_share": k_us / total,
            "top": [{"kernel": k[:90], "ms": v / 1e3, "share": v / total}
                    for k, v in top],
            "by_name": {k: v / 1e3 for k, v in by_name.items()}}


RUNS = ((torch.bfloat16, 1), (torch.bfloat16, 32), (torch.float32, 8))


def resnet_inputs(device, seed: int):
    """Full-width ResNet-50 (stages 3-4-6-3, width 64, 224x224x3, 1000
    classes) in bf16 and float32 from seeded random weights, and images
    from synth_batch for each batch size of ``RUNS``."""
    cfg = get_config("resnet50")
    models = {torch.bfloat16: build_model(cfg).init(
        torch.Generator().manual_seed(seed), device=device),
        torch.float32: build_model(dataclasses.replace(
            cfg, dtype="float32")).init(
            torch.Generator().manual_seed(seed), device=device)}
    images = {}
    for _, b in RUNS:
        batch = synth_batch(cfg, ShapeConfig(f"infer_b{b}", 1, b, "prefill"),
                            DataConfig(seed=seed), 0)["images"]
        images[b] = torch.from_numpy(batch).to(device)
    return cfg, models, images


def phase_resnet50(device, seed: int, cfg, models, images) -> dict:
    """The main path: full-width ResNet-50 inference.  Counts are zeroed
    just before the three forwards (bf16 at B=1 and B=32, float32 at B=8)
    and read just after; then each forward's logits are held against the
    same forward with K2 swapped for its plain version, a reduced ResNet on
    the card against the CPU, and each forward is timed and profiled twice:
    as it runs, and with the library convolution in K2's place."""
    k2.reset_launch_counts()
    logits, per_forward, by_variant = {}, [], []
    for dtype, b in RUNS:
        before = k2.launch_counts()
        logits[(dtype, b)] = models[dtype](images[b])
        after = k2.launch_counts()
        by_variant.append({k: after[k] - before[k] for k in after})
        per_forward.append(sum(by_variant[-1].values()))
    torch.cuda.synchronize()
    launches = k2.launch_counts()

    if per_forward != [46, 46, 46]:
        raise AssertionError(f"K2 launches per forward {per_forward}, "
                             "expected 46 each")
    for (dtype, b), counts in zip(RUNS, by_variant):
        want = k2.TC if dtype == torch.bfloat16 else k2.F32
        if counts[want] != 46:
            raise AssertionError(f"{SUFFIX[dtype]} B={b} forward: K2 "
                                 f"launches by variant {counts}, expected "
                                 f"46 of {want}")
    checks = []
    with mock.patch.object(k2, "conv2d", k2.conv2d_plain):
        for dtype, b in RUNS:
            got = logits[(dtype, b)]
            want = models[dtype](images[b])
            torch.cuda.synchronize()
            if tuple(got.shape) != (b, cfg.vocab_size) or \
                    got.dtype != torch.float32:
                raise AssertionError(f"logits {tuple(got.shape)} {got.dtype}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite logits {dtype} B={b}")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            agree = float((got.argmax(1) == want.argmax(1)).float().mean())
            if err / scale > LOGIT_TOL[dtype]:
                raise AssertionError(
                    f"kernel-path logits {dtype} B={b} off the plain path by "
                    f"{err} / {scale} > {LOGIT_TOL[dtype]}")
            checks.append({"dtype": SUFFIX[dtype], "batch": b,
                           "max_abs_err": err, "scale": scale,
                           "rel_err": err / scale, "top1_agreement": agree})
    if sum(k2.launch_counts().values()) != sum(launches.values()):
        raise AssertionError("the plain-path forwards launched K2")

    # a small input against the CPU, whose plain path the tests hold to the
    # reference package: reduced ResNet, float32, the same weights
    small = dataclasses.replace(cfg.reduced(), dtype="float32")
    cpu_model = build_model(small).init(torch.Generator().manual_seed(seed),
                                        device="cpu")
    card_model = build_model(small).init(device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(synth_batch(small, ShapeConfig("b2", 1, 2, "prefill"),
                                     DataConfig(seed=seed), 0)["images"])
    want = cpu_model(x)
    got = card_model(x.to(device)).cpu()
    small_err = float((got - want).abs().max()) / float(want.abs().max())
    if small_err > LOGIT_TOL[torch.float32]:
        raise AssertionError(f"reduced ResNet card vs CPU: {small_err}")

    perf = {}
    for dtype, b in RUNS:
        model, x = models[dtype], images[b]
        iters = 50 if b == 1 else 20
        host = host_ms(lambda: model(x), iters)
        ms = host["median"]
        br = device_breakdown(lambda: model(x), K2_SYMBOL, LIBRARY_REPS)
        with mock.patch.object(k2, "conv2d", library_conv2d):
            lib = host_ms(lambda: model(x), iters)
            lib_br = device_breakdown(lambda: model(x), K2_SYMBOL,
                                      LIBRARY_REPS)
        enq = enqueue_ms(lambda: model(x))
        bound_ms = sum(conv_bound(xs, ws, xs[:3] + (ws[3],), dtype)["bound_ms"]
                       for xs, ws, _ in k2_calls(model, x))
        row = {"ms_per_batch": ms, "ms_per_batch_spread": host,
               "images_per_s": b / ms * 1e3,
               "enqueue_ms": enq["median"], "enqueue_ms_spread": enq,
               "idle_share": None, "device_ms": br["device_ms"],
               "k2_device_ms": br["kernel_device_ms"],
               "k2_share": br["kernel_share"], "top": br["top"],
               "k2_calls_bound_ms": bound_ms,
               "library_ms_per_batch": lib["median"],
               "library_ms_per_batch_spread": lib,
               "library_device_ms": lib_br["device_ms"],
               "library_calls_device_ms": None}
        if br["device_ms"] is not None and lib_br["device_ms"] is not None:
            row["idle_share"] = 1.0 - br["device_ms"] / ms
            # the library's convolution, layout and copy kernels (the
            # stride-2 convolutions share names with it)
            row["library_calls_device_ms"] = swapped_calls_device_ms(
                br, lib_br)
        perf[f"{SUFFIX[dtype]}_b{b}"] = row
    emit({"phase": "resnet50", "config": "resnet50 (stages 3-4-6-3, width "
          "64, 224x224x3, 1000 classes), weights from torch.Generator seed "
          f"{seed}, BN at identity, images synth_batch(seed={seed})",
          "k2_launches_per_forward": per_forward,
          "k2_launches_per_forward_by_variant": by_variant,
          "launches": launches,
          "logits_vs_plain_path": checks,
          "logit_tolerance_rel_to_scale": {SUFFIX[d]: LOGIT_TOL[d]
                                           for d in LOGIT_TOL},
          "reduced_card_vs_cpu_rel_err": small_err, "inference": perf,
          "timing_note": "ms_per_batch: median host clock around "
                         "forward + synchronize over 20-50 forwards (spread: "
                         "min, max), images already on the card; "
                         "enqueue_ms: median host clock until the forward "
                         "returns over 5, no synchronize inside; "
                         "device_ms / k2_device_ms / top: torch.profiler "
                         "kernel time of a forward (mean of 3 in one "
                         "profile); idle_share = 1 - "
                         "device_ms / ms_per_batch; k2_calls_bound_ms: the "
                         "bound summed over the forward's 46 K2 calls; "
                         "library_*: the same forward with F.conv2d (cuDNN, "
                         "channels-last) in K2's place, where "
                         "library_calls_device_ms, the device time of those "
                         "46 library calls inside the forward, is that "
                         "forward's device time outside K2 less the K2 "
                         "forward's (signed)"})
    return {"launches": launches, "perf": perf}


def conv_rows(per_dtype, infer) -> list:
    """K2's rows, one per variant on the main path (bf16: tensor cores,
    float32): times on the heaviest shape alone, and K2 and the library
    inside each forward of that dtype (bf16 B=1 and B=32, float32 B=8);
    then the bf16 SIMT variant at its first ragged shape."""
    rows = []
    for dtype in CONV_DTYPES:
        d = per_dtype[dtype]
        h = d["heavy"]
        name = k2.TC if dtype == torch.bfloat16 else k2.F32
        rows.append({
            "name": name, "route": "cuda",
            "source": CONV_SOURCE, "replaces": REPLACES["conv2d"],
            "launches": infer["launches"][name],
            "max_abs_err": h["max_abs_err"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "device_ms": h["device_ms"],
            "shape": f"x {h['x']}, w {h['w']}, SAME",
            "plan": h["plan"],
            "max_rel_err_all_shapes": d["max_rel_err"],
            "in_forward": [
                {"batch": b,
                 "k2_device_ms": infer["perf"][f"{SUFFIX[dt]}_b{b}"].get(
                     "k2_device_ms"),
                 "library_device_ms": infer["perf"][f"{SUFFIX[dt]}_b{b}"][
                     "library_calls_device_ms"],
                 "bound_ms": infer["perf"][f"{SUFFIX[dt]}_b{b}"][
                     "k2_calls_bound_ms"]}
                for dt, b in RUNS if dt == dtype]})
    simt = per_dtype[torch.bfloat16]["simt"]
    rows.append({
        "name": k2.SIMT, "route": "cuda", "source": CONV_SOURCE,
        "replaces": REPLACES["conv2d"], "launches": infer["launches"][k2.SIMT],
        "max_abs_err": simt["max_abs_err"], "ms": simt["ms"],
        "plain_ms": simt["plain_ms"], "bound_ms": simt["bound_ms"],
        "bound_by": simt["bound_by"], "library_ms": simt["library_ms"],
        "device_ms": simt["device_ms"],
        "shape": f"x {simt['x']}, w {simt['w']}, SAME (ragged, off the "
                 f"main path)", "plan": simt["plan"]})
    return rows


# --- dense-transformer serving: flash attention (K3) ---------------------------

FLASH_DTYPES = (torch.bfloat16, torch.float32)
# K3 vs flash_attention_plain on the same inputs: float32 |diff| <= 1e-5
# (sums of up to S terms in another order, FMA-contracted); bf16 the
# assert_allclose(atol=2e-2, rtol=2e-2) of tests/test_kernels.py -- K3
# rounds p to bf16 for the tensor-core P V product where the plain version
# keeps it in float32, and an output in [2, 8) has a bf16 ulp of 1/64..1/32
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (case, B, S, H, KV, hd, hv, causal)
FLASH_CASES = (
    ("test_kernels", 2, 128, 2, 2, 32, 32, True),
    ("test_kernels", 2, 256, 4, 2, 64, 64, True),
    ("test_kernels", 2, 256, 4, 1, 64, 64, True),
    ("test_kernels", 2, 384, 2, 2, 128, 128, True),
    ("non_causal", 2, 512, 4, 2, 64, 64, False),
    ("ragged", 2, 1000, 4, 2, 64, 64, True),
    ("ragged_non_causal", 1, 1000, 2, 2, 128, 128, False),
    ("hv_ne_hd", 2, 256, 4, 2, 64, 32, True),
    ("hv_ne_hd", 2, 320, 2, 1, 32, 128, True),
    ("stablelm_b1_s4096", 1, 4096, 32, 32, 64, 64, True),
    ("stablelm_b8_s1024", 8, 1024, 32, 32, 64, 64, True),
    ("qwen3_b1_s2048", 1, 2048, 40, 8, 128, 128, True),
) + tuple(
    # a sequence within one 128-row tile (the tensor-core kernel's TMA box
    # taller than S, one partly filled tile): a short prompt on the main path
    ("short", 2, s, 4, 2, d, d, causal)
    for d in (64, 128) for s in (1, 7, 100) for causal in (True, False))
# the case each dtype's row of the kernels line reports
FLASH_HEADLINE = "stablelm_b1_s4096"
# other softmax scales (the tensor-core kernel folds a positive scale into
# its exp2 and multiplies first otherwise), causal and not: (B, S, H, KV, d)
FLASH_SCALES = (0.3, -0.2, 0.0)
FLASH_SCALE_SHAPES = ((1, 300, 4, 2, 64), (1, 300, 4, 2, 128))
# K3's profiler symbols: every K3 kernel's name starts with one per dtype
K3_SYMBOL = {torch.bfloat16: "flash_bf16_", torch.float32: "flash_f32_"}
K3_TC_KERNEL = "flash_bf16_tc_kernel"
# the variant each dtype takes on the main path (every model shape)
K3_MAIN = {torch.bfloat16: k3.TC, torch.float32: k3.F32}


def flash_bound(b, s, h, kv, hd, hv, causal, dtype) -> dict:
    """Least time for one attention call: q, k, v read once and o written
    once; 2 * B * H * (visible pairs) * (hd + hv) operations at the dtype's
    peak (bf16: the tensor cores), visible pairs S(S+1)/2 causal, S^2 not."""
    e = torch.finfo(dtype).bits // 8
    nbytes = (b * s * h * hd + b * s * kv * (hd + hv) + b * s * h * hv) * e
    pairs = s * (s + 1) // 2 if causal else s * s
    return bound(nbytes, 2 * b * h * pairs * (hd + hv), dtype)


def library_flash_attention(q, k, v, *, causal=True, scale=None):
    """K3's signature on the library: one
    ``F.scaled_dot_product_attention`` on [B, H, S, d] views of the BSHD
    inputs, GQA by ``enable_gqa``.  The yardstick, alone and in K3's place
    inside a prefill; never part of the port."""
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, scale=scale, enable_gqa=True)
    return o.transpose(1, 2)


def flash_case(gen, device, case, dtype) -> dict:
    """K3 against its plain version on one shape; raises on disagreement.
    Then K3's, the plain version's and the library's time, the bound, and
    for the model shapes K3's device time."""
    name, b, s, h, kv, hd, hv, causal = case
    q = torch.randn((b, s, h, hd), generator=gen, device=device).to(dtype)
    k = torch.randn((b, s, kv, hd), generator=gen, device=device).to(dtype)
    v = torch.randn((b, s, kv, hv), generator=gen, device=device).to(dtype)
    plan = k3.plan_for(q, k, v)
    if name.startswith(("stablelm", "qwen3", "short")) and \
            plan.variant != K3_MAIN[dtype]:
        raise AssertionError(f"K3 {name} {dtype} planned {plan.variant}, "
                             f"not {K3_MAIN[dtype]}")
    o = k3.flash_attention(q, k, v, causal=causal)
    again = k3.flash_attention(q, k, v, causal=causal)
    op = k3.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not torch.equal(o, again):
        raise AssertionError(f"K3 {name} {dtype}: two runs differ")
    if tuple(o.shape) != (b, s, h, hv) or o.dtype != dtype:
        raise AssertionError(f"K3 returned {tuple(o.shape)} {o.dtype}")
    if not torch.isfinite(o.float()).all():
        raise AssertionError(f"K3 {name}: non-finite output")
    err = float((o.float() - op.float()).abs().max())
    if not flash_within(o, op, dtype):
        raise AssertionError(f"K3 {name} {(b, s, h, kv, hd, hv, causal)} "
                             f"{dtype}: max |diff| {err} over the limit")
    bd = flash_bound(b, s, h, kv, hd, hv, causal, dtype)
    big = s >= 2048
    row = {"case": name, "B": b, "S": s, "H": h, "KV": kv, "hd": hd,
           "hv": hv, "causal": causal, "dtype": SUFFIX[dtype],
           "plan": dataclasses.asdict(plan), "max_abs_err": err,
           "ms": time_ms(lambda: k3.flash_attention(q, k, v, causal=causal),
                         10 if big else 20),
           "plain_ms": time_ms(lambda: k3.flash_attention_plain(
               q, k, v, causal=causal), 2, warmup=1),
           "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
           "library_ms": None, "library_max_abs_err": None,
           "device_ms": None}
    if hd == hv:
        lib = library_flash_attention(q, k, v, causal=causal)
        row["library_max_abs_err"] = float((lib.float() - op.float())
                                           .abs().max())
        row["library_ms"] = time_ms(lambda: library_flash_attention(
            q, k, v, causal=causal), 10 if big else 20)
    if name.startswith(("stablelm", "qwen3")):
        us = device_us({"k3": (lambda: k3.flash_attention(q, k, v,
                                                          causal=causal),
                               K3_SYMBOL[dtype])}, reps=5)
        row["device_ms"] = None if us["k3"] is None else us["k3"] / 1e3
    return row


def flash_within(o, op, dtype) -> bool:
    """K3's output ``o`` within FLASH_TOL of the plain version's ``op``."""
    diff = (o.float() - op.float()).abs()
    tol = FLASH_TOL[dtype]
    limit = tol if dtype == torch.float32 else tol + tol * op.float().abs()
    return bool((diff <= limit).all())


def flash_scale_case(gen, device, shape, scale, causal, dtype) -> dict:
    """K3 against its plain version at an explicit softmax scale; raises on
    disagreement."""
    b, s, h, kv, d = shape
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device)
               .to(dtype) for n in (h, kv, kv))
    o = k3.flash_attention(q, k, v, causal=causal, scale=scale)
    op = k3.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    err = float((o.float() - op.float()).abs().max())
    if not flash_within(o, op, dtype):
        raise AssertionError(f"K3 {shape} scale {scale} causal {causal} "
                             f"{dtype}: max |diff| {err} over the limit")
    return {"shape": list(shape), "scale": scale, "causal": causal,
            "dtype": SUFFIX[dtype],
            "variant": k3.plan_for(q, k, v).variant, "max_abs_err": err}


def flash_view_case(gen, device) -> dict:
    """bf16 views the kernels cannot read in place (a base off 16 bytes, a
    dense view included) are copied and take the tensor-core kernel: bitwise
    the output of the same call on contiguous copies."""
    b, s, h, kv, d = 2, 300, 4, 2, 64
    flat = torch.randn(1 + b * s * (h + 2 * kv) * d, generator=gen,
                       device=device).to(torch.bfloat16)
    views = []
    for n, off in ((h, 1), (kv, 1 + b * s * h * d),
                   (kv, 1 + b * s * (h + kv) * d)):
        views.append(flat[off:off + b * s * n * d].view(b, s, n, d))
    if any(k3.kernel_ready(t) for t in views):
        raise AssertionError("the shifted views are kernel-ready")
    before = k3.launch_counts()
    o = k3.flash_attention(*views)
    ran = launches_since(before)
    want = k3.flash_attention(*(t.clone() for t in views))
    torch.cuda.synchronize()
    if ran != {k: int(k == k3.TC) for k in k3.LAUNCHES} or \
            not torch.equal(o, want):
        raise AssertionError(f"K3 on views off 16 bytes: launches {ran}, "
                             f"bitwise equal {torch.equal(o, want)}")
    return {"shape": [b, s, h, kv, d], "launches": ran,
            "bitwise_equal_to_contiguous": True}


def phase_flash_attention(device, seed: int) -> dict:
    """K3 against flash_attention_plain on the card, bf16 and float32: the
    test_kernels.py cases (B=2), a non-causal, two ragged-S and two hv != hd
    cases, the model shapes (stablelm B=1 S=4096 and B=8 S=1024, qwen3 B=1
    S=2048 H=40 KV=8 hd=128) and sequences within one tile (S 1, 7, 100 at
    hd 64 and 128, causal and not), each timed beside the plain version,
    SDPA and the bound.  Returns the rows keyed by (dtype, case)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = {}
    for dtype in FLASH_DTYPES:
        for case in FLASH_CASES:
            rows[(dtype, case)] = flash_case(gen, device, case, dtype)
    scales = [flash_scale_case(gen, device, shape, scale, causal, dtype)
              for dtype in FLASH_DTYPES for shape in FLASH_SCALE_SHAPES
              for scale in FLASH_SCALES for causal in (True, False)]
    views = flash_view_case(gen, device)
    variants = sorted({r["plan"]["variant"] for r in rows.values()})
    if variants != sorted(k3.FWD_VARIANTS):
        raise AssertionError(f"the flash_attention phase ran the variants "
                             f"{variants}, not all of "
                             f"{sorted(k3.FWD_VARIANTS)}")
    emit({"phase": "flash_attention",
          "tolerance": {"f32": "max |K3 - plain| <= 1e-5",
                        "bf16": "|K3 - plain| <= 2e-2 + 2e-2 |plain| "
                                "(tests/test_kernels.py atol = rtol)"},
          "cases": list(rows.values()), "scales": scales,
          "misaligned_views": views,
          "bitwise_note": "every case ran twice, bitwise equal",
          "timing_note": "ms / library_ms: CUDA events around back-to-back "
                         "calls after warm-up (launch and wrapper included, "
                         "inputs L2-warm where they fit); device_ms: the "
                         "kernel alone (torch.profiler), model shapes only; "
                         "library = F.scaled_dot_product_attention "
                         "(enable_gqa), timed where hv == hd; bound = "
                         "max(bytes of q, k, v, o / 3.35 TB/s, 2 B H "
                         "pairs (hd + hv) / peak: 989 TFLOP/s bf16, 67 f32)"})
    return rows


# --- dense-transformer serving: prefill, KV cache, decode ----------------------

# kernel-path vs plain-path prefill logits, max |diff| over max |logit|:
# float32 allows sums in another order through every layer; in bf16 an
# activation that rounds the other way feeds every later layer
LM_LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# (run, arch, depth or None for the full depth, dtype, B, S, decode steps)
LM_RUNS = (
    ("a_stablelm_b1_s4096", "stablelm_1_6b", None, torch.bfloat16, 1, 4096, 0),
    ("b_stablelm_b8_s1024", "stablelm_1_6b", None, torch.bfloat16, 8, 1024,
     16),
    ("c_qwen3_14b_l4_b1_s2048", "qwen3_14b", 4, torch.bfloat16, 1, 2048, 0),
    ("d_stablelm_f32_l4_b2_s1024", "stablelm_1_6b", 4, torch.float32, 2,
     1024, 0),
)


def lm_models(device, seed: int) -> dict:
    """One model per (arch, depth, dtype) of ``LM_RUNS``, at full width,
    weights drawn on the card from a CUDA generator seeded with ``seed``."""
    models = {}
    for _, arch, depth, dtype, _, _, _ in LM_RUNS:
        key = (arch, depth, dtype)
        if key not in models:
            cfg = dataclasses.replace(get_config(arch),
                                      dtype=str(dtype).split(".")[-1])
            if depth is not None:
                cfg = dataclasses.replace(cfg, num_layers=depth)
            models[key] = build_model(cfg).init(
                torch.Generator(device=device).manual_seed(seed),
                device=device)
    return models


def lm_prompts(model, b: int, s: int, seed: int, device) -> torch.Tensor:
    cfg = model.cfg
    batch = synth_batch(cfg, ShapeConfig(f"serve_b{b}_s{s}", s, b, "prefill"),
                        DataConfig(seed=seed), 0)
    return torch.from_numpy(batch["tokens"]).to(device)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) / \
        float(want.float().abs().max())


def grown_cache(model, cache, extra: int):
    """The prefill's cache copied into one with room for ``extra`` more
    positions (the reference's prefill cache is exactly prompt-long)."""
    b, s = cache["layers"]["k"].shape[1:3]
    big = model.init_cache(int(b), int(s) + extra)
    for kv in ("k", "v"):
        big["layers"][kv][:, :, :s] = cache["layers"][kv]
    big["len"] = cache["len"]
    return big


def greedy_decode(model, logits, cache, steps: int):
    """``steps`` greedy tokens after a prefill, into a copy of its cache with
    room; returns (first step's logits, generated tokens [B, steps])."""
    big = grown_cache(model, cache, steps)
    tok = logits[:, -1:].argmax(-1)
    first, out = None, []
    for _ in range(steps):
        step, big = model.decode_step(tok, big)
        first = step if first is None else first
        tok = step[:, -1:].argmax(-1)
        out.append(tok)
    return first, torch.cat(out, dim=1)


def launches_since(before: dict) -> dict:
    """K3's launches per variant since the counts were ``before``."""
    return {k: v - before[k] for k, v in k3.launch_counts().items()}


def phase_transformer(device, seed: int) -> dict:
    """The main path: dense-transformer serving.  Counts are zeroed just
    before the four runs' prefills and decode steps and read just after; then
    each prefill is held against the same prefill with K3 swapped for its
    plain version (logits, top-1, cache), the first decode step after each,
    a reduced model on the card against the CPU, and each run is timed and
    profiled twice: as it runs, and with SDPA in K3's place."""
    models = lm_models(device, seed)
    prompts, outs, per_prefill, decode_launches = {}, {}, [], 0
    for run, arch, depth, dtype, b, s, steps in LM_RUNS:
        prompts[run] = lm_prompts(models[(arch, depth, dtype)], b, s, seed,
                                  device)
    torch.cuda.synchronize()

    k3.reset_launch_counts()
    for run, arch, depth, dtype, b, s, steps in LM_RUNS:
        model = models[(arch, depth, dtype)]
        before = k3.launch_counts()
        logits, cache = model.prefill(prompts[run])
        per_prefill.append(launches_since(before))
        first, gen = None, None
        if steps:
            before = sum(k3.launch_counts().values())
            first, gen = greedy_decode(model, logits, cache, steps)
            decode_launches += sum(k3.launch_counts().values()) - before
        outs[run] = (logits, cache, first, gen)
    torch.cuda.synchronize()
    launches = k3.launch_counts()

    # every prefill's attention on its dtype's main variant, once a layer
    want_launches = [{v: (models[(a, d, t)].cfg.num_layers
                          if v == K3_MAIN[t] else 0) for v in k3.LAUNCHES}
                     for _, a, d, t, _, _, _ in LM_RUNS]
    if per_prefill != want_launches or decode_launches != 0:
        raise AssertionError(f"K3 launches per prefill {per_prefill} "
                             f"(expected {want_launches}), in decode "
                             f"{decode_launches} (expected 0)")
    checks = []
    for run, arch, depth, dtype, b, s, steps in LM_RUNS:
        model = models[(arch, depth, dtype)]
        logits, cache, first, gen = outs.pop(run)
        if (tuple(logits.shape) != (b, s, model.cfg.vocab_size)
                or logits.dtype != torch.float32):
            raise AssertionError(f"{run}: logits {tuple(logits.shape)} "
                                 f"{logits.dtype}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{run}: non-finite logits")
        with mock.patch.object(k3, "flash_attention",
                               k3.flash_attention_plain):
            want, want_cache = model.prefill(prompts[run])
            # the first step from the plain cache, on the kernel path's token
            want_first = (greedy_decode(model, logits, want_cache, 1)[0]
                          if steps else None)
        torch.cuda.synchronize()
        tol = LM_LOGIT_TOL[dtype]
        row = {"run": run, "dtype": SUFFIX[dtype], "batch": b, "seq": s,
               "logits_rel_err": rel_err(logits, want),
               "top1_agreement_last": float(
                   (logits[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                   .float().mean()),
               "cache_k_rel_err": rel_err(cache["layers"]["k"],
                                          want_cache["layers"]["k"]),
               "cache_v_rel_err": rel_err(cache["layers"]["v"],
                                          want_cache["layers"]["v"])}
        if steps:
            row["first_decode_logits_rel_err"] = rel_err(first, want_first)
            row["generated_tokens"] = [int(t) for t in gen[0]]
            if not torch.isfinite(first).all():
                raise AssertionError(f"{run}: non-finite decode logits")
        bad = {k: v for k, v in row.items() if k.endswith("rel_err")
               and v > tol}
        if bad:
            raise AssertionError(f"{run}: kernel path off the plain path "
                                 f"beyond {tol}: {bad}")
        checks.append(row)
        del logits, cache, want, want_cache
    if sum(k3.launch_counts().values()) != sum(launches.values()):
        raise AssertionError("the plain-path prefills launched K3")

    # a small input against the CPU, whose plain path the tests hold to the
    # reference package: a reduced stablelm with head_dim 32 (K3's smallest)
    small = dataclasses.replace(get_config("stablelm_1_6b").reduced(),
                                dtype="float32", head_dim=32)
    cpu_model = build_model(small).init(torch.Generator().manual_seed(seed),
                                        device="cpu")
    card_model = build_model(small).init(device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, small.vocab_size, (2, 100)).astype(np.int32))
    small_err = rel_err(card_model(toks.to(device)).cpu(), cpu_model(toks))
    if small_err > LM_LOGIT_TOL[torch.float32]:
        raise AssertionError(f"reduced transformer card vs CPU: {small_err}")

    perf = {}
    for run, arch, depth, dtype, b, s, steps in LM_RUNS:
        model, x = models[(arch, depth, dtype)], prompts[run]
        symbol = K3_SYMBOL[dtype]
        cfg = model.cfg
        host = host_ms(lambda: model.prefill(x), warmup=2)
        ms = host["median"]
        br = device_breakdown(lambda: model.prefill(x), symbol, LIBRARY_REPS)
        with mock.patch.object(k3, "flash_attention",
                               library_flash_attention):
            lib = host_ms(lambda: model.prefill(x), warmup=2)
            lib_br = device_breakdown(lambda: model.prefill(x), symbol,
                                      LIBRARY_REPS)
        bd = flash_bound(b, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.head_dim, True, dtype)
        row = {"ms_per_prefill": ms, "ms_per_prefill_spread": host,
               "prompt_tokens_per_s": b * s / ms * 1e3,
               "device_ms": br["device_ms"], "idle_share": None,
               "k3_device_ms": br["kernel_device_ms"],
               "k3_share": br["kernel_share"], "top": br["top"],
               "k3_calls_bound_ms": cfg.num_layers * bd["bound_ms"],
               "sdpa_ms_per_prefill": lib["median"],
               "sdpa_ms_per_prefill_spread": lib,
               "sdpa_device_ms": lib_br["device_ms"],
               "sdpa_calls_device_ms": None}
        if br["device_ms"] is not None and lib_br["device_ms"] is not None:
            row["idle_share"] = 1.0 - br["device_ms"] / ms
            # SDPA's kernels and its layout copies (as the resnet50 phase
            # measures cuDNN in K2's place)
            row["sdpa_calls_device_ms"] = swapped_calls_device_ms(br, lib_br)
        if steps:
            logits, cache = model.prefill(x)
            st = {}

            def start():
                st["tok"] = logits[:, -1:].argmax(-1)
                st["cache"] = grown_cache(model, cache, steps)

            def one_step():
                out, st["cache"] = model.decode_step(st["tok"], st["cache"])
                st["tok"] = out[:, -1:].argmax(-1)

            window = decode_window_ms(start, one_step, steps)
            latency = decode_latency_ms(start, one_step, steps)
            tok = st["tok"]
            row["ms_per_decode_step"] = window["median"]
            row["ms_per_decode_step_spread"] = window
            row["generated_tokens_per_s"] = b / window["median"] * 1e3
            row["decode_step_latency_ms"] = latency["median"]
            row["decode_step_latency_spread"] = latency
            # one step profiled (and one before it), into a fresh copy
            big = grown_cache(model, cache, 2)
            dec = device_breakdown(lambda: model.decode_step(tok, big),
                                   symbol)
            row["decode_device_ms"] = dec["device_ms"]
            row["decode_idle_share"] = (
                None if dec["device_ms"] is None
                else 1.0 - dec["device_ms"] / row["ms_per_decode_step"])
            row["decode_top"] = dec["top"]
            del logits, cache, big, st
        perf[run] = row
    emit({"phase": "transformer",
          "config": "stablelm-1.6b (24 L, d 2048, 32 heads of 64, d_ff 5632, "
                    "vocab 100,352) full width and depth; qwen3-14b full "
                    "width (d 5120, 40 heads / 8 kv of 128, qk_norm, d_ff "
                    "17,408, vocab 151,936), depth 40 -> 4; stablelm float32 "
                    f"depth 24 -> 4; weights from a CUDA generator seed {seed}, "
                    f"prompts synth_batch(seed={seed})",
          "k3_launches_per_prefill_by_variant": per_prefill,
          "k3_launches_in_decode": decode_launches, "launches": launches,
          "vs_plain_path": checks,
          "logit_tolerance_rel_to_scale": {SUFFIX[d]: LM_LOGIT_TOL[d]
                                           for d in LM_LOGIT_TOL},
          "reduced_card_vs_cpu_rel_err": small_err, "serving": perf,
          "timing_note": "ms_per_prefill: median host clock around "
                         "prefill + synchronize over 5 (spread: min, max), "
                         "prompts on the card; device_ms / "
                         "k3_device_ms / top: torch.profiler kernel time of "
                         "a prefill (mean of 3 in one profile); idle_share "
                         "= 1 - device_ms / ms_per_prefill; "
                         "k3_calls_bound_ms: the bound summed "
                         "over the prefill's K3 calls; sdpa_*: the same "
                         "prefill with F.scaled_dot_product_attention in "
                         "K3's place, sdpa_calls_device_ms = its device "
                         "time outside K3 less the K3 run's (signed); "
                         "ms_per_decode_step / generated_tokens_per_s: host "
                         "clock of a window of 16 greedy steps issued back "
                         "to back, one synchronize at its end, per step, "
                         "median over 5 windows; decode_step_latency_ms: "
                         "median host clock of each of 16 steps, each ending "
                         "in a synchronize; decode_device_ms / decode_top: "
                         "one step profiled"})
    return {"launches": launches, "perf": perf}


def flash_rows(rows, lm, training) -> list:
    """K3's rows: times at the stablelm B=1 S=4096 shape alone, every other
    model shape beside it, and K3 and SDPA inside the prefills.  Launches:
    the prefill path's (``transformer``) and the training path's (the
    forward that also writes the log-sum-exp: (a) in bf16, (b) in
    float32), each counted from zero around its own run."""
    out = []
    train_path = {torch.bfloat16: "a_full", torch.float32: "b_card_vs_cpu"}
    for dtype in FLASH_DTYPES:
        head = next(r for (d, c), r in rows.items()
                    if d == dtype and c[0] == FLASH_HEADLINE)
        name = K3_MAIN[dtype]
        runs = [r for r, _, _, dt, _, _, _ in LM_RUNS if dt == dtype]
        trained = training[train_path[dtype]]["launches"][name]
        out.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": REPLACES["flash_attention"],
            "launches": lm["launches"][name] + trained,
            "launches_by_path": {"prefill": lm["launches"][name],
                                 "training": trained},
            "max_abs_err": max(r["max_abs_err"] for (d, _), r in rows.items()
                               if d == dtype
                               and r["plan"]["variant"] == name),
            "plan": head["plan"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "device_ms": head["device_ms"],
            "shape": "B=1, S=4096, H=KV=32, hd=hv=64, causal",
            "model_shapes": [{k: r[k] for k in (
                "case", "B", "S", "H", "KV", "hd", "ms", "device_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")} for (d, c), r in rows.items()
                if d == dtype and c[0].startswith(("stablelm", "qwen3"))],
            "in_prefill": {run: {
                "k3_device_ms": lm["perf"][run]["k3_device_ms"],
                "sdpa_device_ms": lm["perf"][run]["sdpa_calls_device_ms"],
                "bound_ms": lm["perf"][run]["k3_calls_bound_ms"]}
                for run in runs}})
    return out


# --- mamba2 serving: the SSD chunk scan (K4) ------------------------------------

SSD_DTYPES = (torch.bfloat16, torch.float32)
# K4 vs ssd_scan_plain on the same inputs: float32 output (y and the final
# state) within 1e-5 of the scale max |plain| -- sums in another order,
# FMA-contracted; bf16 output within one bf16 ulp of the scale -- a float32
# value that lies near a rounding boundary may round the other way
SSD_TOL = 1e-5
# (case, b, S, nh, hp, ds, chunk): tests/test_kernels.py's three cases
# (b = 2), two small shapes of the shared_cb variant (ds 64, Q 128; its
# largest state and smallest chunk, ds 256, Q 64), then mamba2-130m's
# heads at its two prefill shapes
SSD_CASES = (
    ("test_kernels", 2, 128, 2, 16, 16, 32),
    ("test_kernels", 2, 256, 3, 16, 32, 64),
    ("test_kernels", 2, 128, 4, 32, 16, 128),
    ("shared_cb_small", 2, 512, 3, 64, 64, 128),
    ("shared_cb_edge", 2, 256, 2, 64, 256, 64),
    ("mamba2_b1_s4096", 1, 4096, 24, 64, 128, 256),
    ("mamba2_b8_s1024", 8, 1024, 24, 64, 128, 256),
)
SSD_HEADLINE = "mamba2_b1_s4096"
SSD_SYMBOL = "ssd_"       # every K4 __global__ function's name starts so
# the variant each case must plan, by the case name's start
SSD_VARIANT = {"test_kernels": k4.GENERAL, "shared_cb": k4.SHARED_CB,
               "mamba2": k4.SHARED_CB}
# the shared_cb variant's kernels: ptxas must report no spills for them
SSD_TILE_KERNELS = ("ssd_cb_bf16_kernel", "ssd_cb_f32_kernel",
                    "ssd_state_tile_kernel", "ssd_output_tile_kernel")


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (int(np.floor(np.log2(x))) - 7)


def ssd_bound(b, s, nh, hp, ds, q, in_dtype, out_dtype) -> dict:
    """Least time for one scan: x, dt, A, B, C read once, y and the final
    state written once; the operations the scan needs, at the float32 rate
    (both input types compute in float32): C B^T over the lower triangle
    once per (b, chunk), ds Q (Q + 1) (ngroups == 1: all heads share it),
    and per (b, h, chunk) the masked product (C B^T . L) @ (x dt) over the
    lower triangle, hp Q (Q + 1), plus 4 Q hp ds for y_off and the state
    contribution.  ``units_bound_ms``: the same work at the rates of the
    units the shared_cb variant runs it on -- C B^T of bf16 inputs on the
    bf16 tensor cores (989 TFLOP/s), every float32-operand product as
    3xTF32 on the TF32 tensor cores (495 / 3 TFLOP/s), or 495 / 2 where
    one operand is bf16 (y_off, the state contribution of bf16 inputs).
    ``tpu_kernel_operations`` is the TPU kernel's own count, 2 Q^2 ds + 2
    Q^2 hp + 4 Q hp ds per (b, h, chunk): C B^T per head and full Q x Q
    products."""
    ei = torch.finfo(in_dtype).bits // 8
    eo = torch.finfo(out_dtype).bits // 8
    nc = s // q
    nbytes = ((b * s * nh * hp + 2 * b * s * ds) * ei + b * s * nh * 4
              + nh * 4 + b * s * nh * hp * eo + b * nh * hp * ds * 4)
    cb_ops = b * nc * ds * q * (q + 1)
    masked_ops = b * nh * nc * hp * q * (q + 1)
    off_state_ops = b * nh * nc * 4 * q * hp * ds
    out = bound(nbytes, cb_ops + masked_ops + off_state_ops, torch.float32)
    bf16 = in_dtype == torch.bfloat16
    units_s = (cb_ops / (PEAK_FLOPS[torch.bfloat16] if bf16
                         else TF32_FLOPS / 3)
               + masked_ops / (TF32_FLOPS / 3)
               + off_state_ops / (TF32_FLOPS / (2 if bf16 else 3)))
    out["units_bound_ms"] = max(nbytes / PEAK_BYTES_PER_S, units_s) * 1e3
    out["tpu_kernel_operations"] = b * nh * nc * (
        2 * q * q * ds + 2 * q * q * hp + 4 * q * hp * ds)
    return out


def ssd_grid(b, s, nh, hp, ds, q, dtype) -> dict:
    """K4's plan at these sizes, held against what the kernel library
    launches: the variant, each launch's grid, threads, dynamic shared
    memory and blocks per SM; raises where the plan and the library
    disagree."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = k4.plan(b, s, nh, hp, ds, q, dtype, sms)
    shape = k4.launch_shape(b, s, nh, hp, ds, q, dtype)
    got = {k: tuple(v["grid"]) for k, v in shape["launches"].items()}
    if shape["variant"] != p.variant or got != p.grids:
        raise AssertionError(f"K4 plan {p} disagrees with the library's "
                             f"launches {shape}")
    return {"variant": p.variant, "sms": sms,
            "launches": {k: dict(v, blocks=int(np.prod(v["grid"])),
                                 blocks_per_sm=p.blocks_per_sm[k])
                         for k, v in shape["launches"].items()},
            "scratch": {k: list(v) for k, v in p.scratch.items()}}


def plain_cum(dt, A, q) -> torch.Tensor:
    """The plain version's cum of every chunk, [b, nh, nc, Q]: dt * A in
    float32, cumsum in float64, rounded to float32 once."""
    b, s, nh = dt.shape
    dA = (dt * A).reshape(b, s // q, q, nh).permute(0, 3, 1, 2)
    return torch.cumsum(dA.double(), dim=-1).float()


def ssd_case(gen, device, case, dtype) -> list:
    """K4 against its plain version on one shape, with float32 output (the
    model's path) and, for bf16 inputs, bf16 output (the reference kernel's
    default); raises on disagreement, on a run that differs bitwise from a
    second run, on a cum that differs from the plain version's, and on a
    variant other than the one the case must plan.  The float32-output row
    is timed beside the plain version and the bound; the model shapes also
    get K4's device time, kernel by kernel."""
    name, b, s, nh, hp, ds, q = case
    x = torch.randn((b, s, nh, hp), generator=gen, device=device).to(dtype)
    dt = torch.rand((b, s, nh), generator=gen, device=device) * 0.19 + 0.01
    A = -(torch.rand((nh,), generator=gen, device=device) * 1.5 + 0.5)
    Bm = torch.randn((b, s, 1, ds), generator=gen, device=device).to(dtype)
    Cm = torch.randn((b, s, 1, ds), generator=gen, device=device).to(dtype)
    grid = ssd_grid(b, s, nh, hp, ds, q, dtype)
    want = next(v for k, v in SSD_VARIANT.items() if name.startswith(k))
    if grid["variant"] != want:
        raise AssertionError(f"K4 {name} {dtype} planned {grid['variant']}, "
                             f"not {want}")
    rows = []
    for out in dict.fromkeys((torch.float32, dtype)):
        y, st, scratch = k4.ssd_scan_with_scratch(x, dt, A, Bm, Cm, chunk=q,
                                                  out_dtype=out)
        y2, st2 = k4.ssd_scan(x, dt, A, Bm, Cm, chunk=q, out_dtype=out)
        yp, sp = k4.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=q, out_dtype=out)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError(f"K4 {name} {dtype} -> {out}: two runs "
                                 f"differ")
        if not torch.equal(scratch["cum"], plain_cum(dt, A, q)):
            raise AssertionError(f"K4 {name} {dtype}: cum differs from the "
                                 f"plain version's float64 cumsum")
        if tuple(y.shape) != (b, s, nh, hp) or y.dtype != out:
            raise AssertionError(f"K4 returned {tuple(y.shape)} {y.dtype}")
        if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
            raise AssertionError(f"K4 {name}: non-finite output")
        scale = float(yp.float().abs().max())
        err = float((y.float() - yp.float()).abs().max())
        s_err = float((st - sp).abs().max()) / float(sp.abs().max())
        limit = SSD_TOL * scale if out == torch.float32 else bf16_ulp(scale)
        if err > limit or s_err > SSD_TOL:
            raise AssertionError(
                f"K4 {name} {(b, s, nh, hp, ds, q)} {dtype} -> {out}: max "
                f"|y diff| {err} (limit {limit}), state {s_err} of scale")
        row = {"case": name, "b": b, "S": s, "nh": nh, "hp": hp, "ds": ds,
               "Q": q, "dtype": SUFFIX[dtype], "out": SUFFIX[out],
               "variant": grid["variant"], "max_abs_err": err,
               "y_rel_err": err / scale, "limit": limit,
               "state_rel_err": s_err, "twice_bitwise": True,
               "cum_equal_plain": True}
        if out == torch.float32:
            bd = ssd_bound(b, s, nh, hp, ds, q, dtype, out)
            row.update({
                "ms": time_ms(lambda: k4.ssd_scan(
                    x, dt, A, Bm, Cm, chunk=q, out_dtype=out), 20),
                "plain_ms": time_ms(lambda: k4.ssd_scan_plain(
                    x, dt, A, Bm, Cm, chunk=q, out_dtype=out), 3, warmup=1),
                "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                "units_bound_ms": bd["units_bound_ms"],
                "bytes": bd["bytes"], "operations": bd["operations"],
                "tpu_kernel_operations": bd["tpu_kernel_operations"],
                "library_ms": None, "device_ms": None, "kernel_split": None,
                "grid": grid})
            if name.startswith("mamba2"):
                br = device_breakdown(lambda: k4.ssd_scan(
                    x, dt, A, Bm, Cm, chunk=q, out_dtype=out), SSD_SYMBOL,
                    reps=5)
                row["device_ms"] = br["kernel_device_ms"]
                row["kernel_split"] = {
                    k[k.find(SSD_SYMBOL):][:80]: v
                    for k, v in br["by_name"].items() if SSD_SYMBOL in k}
        rows.append(row)
    return rows


def ssd_view_case(gen, device) -> dict:
    """B and C as column slices of one tensor (in place, as the model
    passes them) and x, B, C views whose base lies off 16 bytes (copied
    before the shared_cb kernels read them): bitwise the output of the same
    call on contiguous copies, one launch each."""
    b, s, nh, hp, ds, q = 2, 512, 3, 64, 64, 128
    dt = torch.rand((b, s, nh), generator=gen, device=device) * 0.19 + 0.01
    A = -(torch.rand((nh,), generator=gen, device=device) * 1.5 + 0.5)
    flat = torch.randn(8 + b * s * (nh * hp + 2 * ds), generator=gen,
                       device=device).to(torch.bfloat16)
    out = {}
    for off in (0, 1):
        xbc = flat[off:off + b * s * (nh * hp + 2 * ds)].view(
            b, s, nh * hp + 2 * ds)
        x = xbc[..., :nh * hp].view(b, s, nh, hp)
        Bm = xbc[..., nh * hp:nh * hp + ds].view(b, s, 1, ds)
        Cm = xbc[..., nh * hp + ds:].view(b, s, 1, ds)
        ready = [k4.kernel_ready(t) for t in (x, Bm, Cm)]
        if ready != [off == 0] * 3:
            raise AssertionError(f"views at offset {off}: kernel_ready "
                                 f"{ready}")
        before = sum(k4.launch_counts().values())
        y, st = k4.ssd_scan(x, dt, A, Bm, Cm, chunk=q)
        ran = sum(k4.launch_counts().values()) - before
        yc, stc = k4.ssd_scan(*(t.contiguous() for t in (x, dt, A, Bm, Cm)),
                              chunk=q)
        torch.cuda.synchronize()
        if ran != 1 or not (torch.equal(y, yc) and torch.equal(st, stc)):
            raise AssertionError(f"K4 on views at offset {off}: launches "
                                 f"{ran}, bitwise {torch.equal(y, yc)}")
        out[f"offset_{off}"] = {"kernel_ready": ready[0], "launches": ran,
                                "bitwise_equal_to_contiguous": True}
    return out


def phase_ssd_scan(device, seed: int) -> dict:
    """K4 against ssd_scan_plain on the card, bf16 and float32 inputs: the
    test_kernels.py cases (b = 2, the general variant), a small shared_cb
    shape and mamba2-130m's prefill shapes (nh 24, hp 64, ds 128, Q 256 at
    B=1 S=4096 and B=8 S=1024, shared_cb), each timed beside the plain
    version and the bound; strided and misaligned views.  Returns the
    float32-output rows keyed by (dtype, case)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cases, rows = [], {}
    for dtype in SSD_DTYPES:
        for case in SSD_CASES:
            out = ssd_case(gen, device, case, dtype)
            cases += out
            rows[(dtype, case)] = out[0]
    views = ssd_view_case(gen, device)
    emit({"phase": "ssd_scan",
          "tolerance": {"f32_out": "max |K4 - plain| <= 1e-5 max |plain|, "
                                   "y and final state",
                        "bf16_out": "max |K4 - plain| <= one bf16 ulp of "
                                    "max |plain|"},
          "cases": cases, "views": views,
          "checks_note": "every case ran twice, bitwise equal; cum (the "
                         "scratch) equal to the plain version's float64 "
                         "cumsum rounded once; the variant as planned, the "
                         "plan's grids as the library launches them",
          "timing_note": "ms: CUDA events around back-to-back calls after "
                         "warm-up (launch and wrapper included, inputs "
                         "L2-warm where they fit), float32 output; "
                         "device_ms: K4's kernels per call "
                         "(torch.profiler), model shapes only, "
                         "kernel_split by kernel; library: none, no "
                         "PyTorch call computes the SSD scan; bound = "
                         "max(bytes of x, dt, A, B, C, y, state / 3.35 "
                         "TB/s, the scan's least operations -- C B^T once "
                         "per (b, chunk) and the products over the lower "
                         "triangle -- / 67 TFLOP/s float32, kept so for "
                         "rows comparable across PRs); units_bound = the "
                         "same work at the rates of the units shared_cb "
                         "runs it on: C B^T of bf16 inputs at 989 TFLOP/s, "
                         "3xTF32 products at 495 / 3 TFLOP/s, 495 / 2 where "
                         "one operand is bf16"})
    return rows


# --- mamba2 serving: chunked prefill on K4, recurrent decode -------------------

# (run, depth or None for the full depth, dtype, B, S, decode steps)
MAMBA_RUNS = (
    ("a_mamba2_b1_s4096", None, torch.bfloat16, 1, 4096, 0),
    ("b_mamba2_b8_s1024", None, torch.bfloat16, 8, 1024, 16),
    ("c_mamba2_f32_l4_b2_s1024", 4, torch.float32, 2, 1024, 0),
)


def mamba_models(device, seed: int) -> dict:
    """One mamba2-130m per (depth, dtype) of ``MAMBA_RUNS``, at full width,
    weights drawn on the card from a CUDA generator seeded with ``seed``."""
    models = {}
    for _, depth, dtype, _, _, _ in MAMBA_RUNS:
        if (depth, dtype) not in models:
            cfg = dataclasses.replace(get_config("mamba2_130m"),
                                      dtype=str(dtype).split(".")[-1])
            if depth is not None:
                cfg = dataclasses.replace(cfg, num_layers=depth)
            models[(depth, dtype)] = build_model(cfg).init(
                torch.Generator(device=device).manual_seed(seed),
                device=device)
    return models


def clone_cache(cache):
    return {"len": cache["len"],
            "ssm": {k: v.clone() for k, v in cache["ssm"].items()}}


def ssm_decode(model, logits, cache, steps: int):
    """``steps`` greedy tokens straight from a copy of the prefill's cache
    (the SSM cache does not grow); returns (first step's logits, tokens)."""
    cache = clone_cache(cache)
    tok = logits[:, -1:].argmax(-1)
    first, out = None, []
    for _ in range(steps):
        step, cache = model.decode_step(tok, cache)
        first = step if first is None else first
        tok = step[:, -1:].argmax(-1)
        out.append(tok)
    return first, torch.cat(out, dim=1)


def phase_mamba2(device, seed: int) -> dict:
    """The main path: mamba2-130m serving.  Counts are zeroed just before
    the three runs' prefills and decode steps and read just after; then
    each prefill is held against the same prefill with K4 swapped for its
    plain version (logits, top-1, conv and state cache), the first decode
    step after each, a reduced model on the card against the CPU, and each
    run is timed and profiled."""
    models = mamba_models(device, seed)
    prompts, outs, per_prefill, decode_launches = {}, {}, [], 0
    for run, depth, dtype, b, s, _ in MAMBA_RUNS:
        prompts[run] = lm_prompts(models[(depth, dtype)], b, s, seed, device)
    torch.cuda.synchronize()

    k4.reset_launch_counts()
    for run, depth, dtype, b, s, steps in MAMBA_RUNS:
        model = models[(depth, dtype)]
        before = sum(k4.launch_counts().values())
        logits, cache = model.prefill(prompts[run])
        per_prefill.append(sum(k4.launch_counts().values()) - before)
        first, gen = None, None
        if steps:
            before = sum(k4.launch_counts().values())
            first, gen = ssm_decode(model, logits, cache, steps)
            decode_launches += sum(k4.launch_counts().values()) - before
        outs[run] = (logits, cache, first, gen)
    torch.cuda.synchronize()
    launches = k4.launch_counts()

    want_launches = [models[(d, t)].cfg.num_layers
                     for _, d, t, _, _, _ in MAMBA_RUNS]
    if per_prefill != want_launches or decode_launches != 0:
        raise AssertionError(f"K4 launches per prefill {per_prefill} "
                             f"(expected {want_launches}), in decode "
                             f"{decode_launches} (expected 0)")
    checks = []
    for run, depth, dtype, b, s, steps in MAMBA_RUNS:
        model = models[(depth, dtype)]
        logits, cache, first, gen = outs.pop(run)
        if (tuple(logits.shape) != (b, s, model.cfg.vocab_size)
                or logits.dtype != torch.float32):
            raise AssertionError(f"{run}: logits {tuple(logits.shape)} "
                                 f"{logits.dtype}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{run}: non-finite logits")
        with mock.patch.object(k4, "ssd_scan", k4.ssd_scan_plain):
            want, want_cache = model.prefill(prompts[run])
            # the first step from the plain cache, on the kernel path's token
            want_first = (ssm_decode(model, logits, want_cache, 1)[0]
                          if steps else None)
        torch.cuda.synchronize()
        tol = LM_LOGIT_TOL[dtype]
        row = {"run": run, "dtype": SUFFIX[dtype], "batch": b, "seq": s,
               "logits_rel_err": rel_err(logits, want),
               "top1_agreement_last": float(
                   (logits[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                   .float().mean()),
               "cache_conv_rel_err": rel_err(cache["ssm"]["conv"],
                                             want_cache["ssm"]["conv"]),
               "cache_state_rel_err": rel_err(cache["ssm"]["state"],
                                              want_cache["ssm"]["state"])}
        if steps:
            row["first_decode_logits_rel_err"] = rel_err(first, want_first)
            row["generated_tokens"] = [int(t) for t in gen[0]]
            if not torch.isfinite(first).all():
                raise AssertionError(f"{run}: non-finite decode logits")
        bad = {k: v for k, v in row.items() if k.endswith("rel_err")
               and v > tol}
        if bad or row["top1_agreement_last"] != 1.0:
            raise AssertionError(f"{run}: kernel path off the plain path "
                                 f"beyond {tol} or top-1 split: {bad}, "
                                 f"{row['top1_agreement_last']}")
        checks.append(row)
        del logits, cache, want, want_cache
    if sum(k4.launch_counts().values()) != sum(launches.values()):
        raise AssertionError("the plain-path prefills launched K4")

    # a small input against the CPU, whose plain path the tests hold to the
    # reference package: the reduced mamba2 (hp 16, ds 16, chunk 16)
    small = dataclasses.replace(get_config("mamba2_130m").reduced(),
                                dtype="float32")
    cpu_model = build_model(small).init(torch.Generator().manual_seed(seed),
                                        device="cpu")
    card_model = build_model(small).init(device=device)
    card_model.load_state_dict(cpu_model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, small.vocab_size, (2, 96)).astype(np.int32))
    small_err = rel_err(card_model(toks.to(device)).cpu(), cpu_model(toks))
    if small_err > LM_LOGIT_TOL[torch.float32]:
        raise AssertionError(f"reduced mamba2 card vs CPU: {small_err}")

    perf = {}
    for run, depth, dtype, b, s, steps in MAMBA_RUNS:
        model, x = models[(depth, dtype)], prompts[run]
        cfg = model.cfg
        host = host_ms(lambda: model.prefill(x), warmup=2)
        ms = host["median"]
        enq = enqueue_ms(lambda: model.prefill(x))
        br = device_breakdown(lambda: model.prefill(x), SSD_SYMBOL)
        bd = ssd_bound(b, s, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                       min(cfg.ssm_chunk, s), dtype, torch.float32)
        row = {"ms_per_prefill": ms, "ms_per_prefill_spread": host,
               "prompt_tokens_per_s": b * s / ms * 1e3,
               "enqueue_ms": enq["median"], "enqueue_ms_spread": enq,
               "device_ms": br["device_ms"], "idle_share": None,
               "k4_device_ms": br["kernel_device_ms"],
               "k4_share": br["kernel_share"], "top": br["top"],
               "k4_split": {k[k.find(SSD_SYMBOL):][:80]: v
                            for k, v in br["by_name"].items()
                            if SSD_SYMBOL in k},
               "k4_calls_bound_ms": cfg.num_layers * bd["bound_ms"],
               "k4_calls_units_bound_ms":
                   cfg.num_layers * bd["units_bound_ms"]}
        if br["device_ms"] is not None:
            row["idle_share"] = 1.0 - br["device_ms"] / ms
        if steps:
            logits, cache = model.prefill(x)
            st = {}

            def start():
                # decode updates the cache in place: each window from a copy
                st["tok"] = logits[:, -1:].argmax(-1)
                st["cache"] = clone_cache(cache)

            def one_step():
                out, st["cache"] = model.decode_step(st["tok"], st["cache"])
                st["tok"] = out[:, -1:].argmax(-1)

            window = decode_window_ms(start, one_step, steps)
            latency = decode_latency_ms(start, one_step, steps)
            tok, cache = st["tok"], st["cache"]
            row["ms_per_decode_step"] = window["median"]
            row["ms_per_decode_step_spread"] = window
            row["generated_tokens_per_s"] = b / window["median"] * 1e3
            row["decode_step_latency_ms"] = latency["median"]
            row["decode_step_latency_spread"] = latency
            dec = device_breakdown(lambda: model.decode_step(tok, cache),
                                   SSD_SYMBOL)
            row["decode_device_ms"] = dec["device_ms"]
            row["decode_idle_share"] = (
                None if dec["device_ms"] is None
                else 1.0 - dec["device_ms"] / row["ms_per_decode_step"])
            row["decode_top"] = dec["top"]
            del logits, cache
        perf[run] = row
    emit({"phase": "mamba2",
          "config": "mamba2-130m (24 L, d 768, d_inner 1536, 24 heads of "
                    "64, ds 128, chunk 256, conv 4, vocab 50,280, tied) "
                    "full width and depth in bf16; float32 depth 24 -> 4; "
                    f"weights from a CUDA generator seed {seed}, prompts "
                    f"synth_batch(seed={seed})",
          "k4_launches_per_prefill": per_prefill,
          "k4_launches_in_decode": decode_launches, "launches": launches,
          "vs_plain_path": checks,
          "logit_tolerance_rel_to_scale": {SUFFIX[d]: LM_LOGIT_TOL[d]
                                           for d in LM_LOGIT_TOL},
          "reduced_card_vs_cpu_rel_err": small_err, "serving": perf,
          "timing_note": "ms_per_prefill: median host clock around "
                         "prefill + synchronize over 5 (spread: min, max), "
                         "prompts on the card; device_ms / "
                         "k4_device_ms / top / k4_split: torch.profiler "
                         "kernel time of one prefill (K4 = its kernels, "
                         "k4_split by kernel); idle_share "
                         "= 1 - device_ms / ms_per_prefill; enqueue_ms: "
                         "median host clock until prefill returns over 5, "
                         "no synchronize; "
                         "k4_calls_bound_ms / k4_calls_units_bound_ms: "
                         "the bounds summed over the prefill's K4 calls; ms_per_decode_step / "
                         "generated_tokens_per_s: host clock of a window of "
                         "16 greedy steps from the prefill cache issued back "
                         "to back, one synchronize at its end, per step, "
                         "median over 5 windows; decode_step_latency_ms: "
                         "median host clock of each of 16 steps, each ending "
                         "in a synchronize; decode_device_ms / decode_top: "
                         "one step profiled"})
    return {"launches": launches, "perf": perf}


def ssd_rows(rows, mb) -> list:
    """K4's rows: times at the mamba2 B=1 S=4096 shape alone (float32
    output, the model's path), the other model shape beside it, and K4
    inside the prefills."""
    out = []
    for dtype in SSD_DTYPES:
        sfx = SUFFIX[dtype]
        head = next(r for (d, c), r in rows.items()
                    if d == dtype and c[0] == SSD_HEADLINE)
        name = f"ssd_scan_{sfx}"
        runs = [r for r, _, dt, _, _, _ in MAMBA_RUNS if dt == dtype]
        out.append({
            "name": name, "route": "cuda", "source": SSD_SOURCE,
            "replaces": REPLACES["ssd_scan"],
            "launches": mb["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for (d, _), r in rows.items()
                               if d == dtype),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "units_bound_ms": head["units_bound_ms"],
            "library_ms": None, "device_ms": head["device_ms"],
            "shape": "b=1, S=4096, nh=24, hp=64, ds=128, Q=256, "
                     "float32 output",
            "variant": head["variant"], "grid": head["grid"],
            "model_shapes": [{k: r[k] for k in (
                "case", "b", "S", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "units_bound_ms", "max_abs_err", "kernel_split")}
                for (d, c), r in rows.items()
                if d == dtype and c[0].startswith("mamba2")],
            "in_prefill": {run: {
                "k4_device_ms": mb["perf"][run]["k4_device_ms"],
                "bound_ms": mb["perf"][run]["k4_calls_bound_ms"],
                "units_bound_ms": mb["perf"][run]["k4_calls_units_bound_ms"]}
                for run in runs}})
    return out


# --- training: the dense transformer on K3 and its backward --------------------

TRAIN_ARCH = "stablelm-1.6b"
TRAIN_STEPS = 4
TRAIN_SEQ = 4096
# the step the profiler records in (a) (steps 1 and 2 are timed bare)
TRAIN_PROFILED_STEP = 3
# (b): card against the port's CPU path, float32, depth 2, full width; the
# tolerances of tests/test_torch_train.py (loss 1e-5 relative, every
# gradient 1e-4 of its scale)
CARD_CPU_SEQ = 512
CARD_CPU_LOSS_TOL = 1e-5
CARD_CPU_GRAD_TOL = 1e-4
# (c): resume, bf16, depth 2, full width
RESUME_STEPS, RESUME_EVERY, RESUME_DEPTH = 4, 2, 2
# (d): K3's backward against flash_attention_bwd_plain on the card, each
# gradient within tol * max |plain|: bf16 2e-2 (the kernels round P and dS
# to bf16 for the tensor-core products, the plain version keeps float32),
# float32 1e-4 (sums in other orders)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# (case, B, S, H, KV, d, causal, dtypes): the two model shapes, a ragged S
# and a non-causal GQA call (which the model shapes do not reach), each in
# both dtypes
BOTH_DTYPES = (torch.bfloat16, torch.float32)
BWD_CASES = (("stablelm_b1_s4096", 1, 4096, 32, 32, 64, True, BOTH_DTYPES),
             ("qwen3_b1_s2048", 1, 2048, 40, 8, 128, True, BOTH_DTYPES),
             ("ragged_b2_s1000", 2, 1000, 4, 4, 64, True, BOTH_DTYPES),
             ("noncausal_b1_s512_gqa", 1, 512, 8, 2, 128, False,
              BOTH_DTYPES))
BWD_HEADLINE = "stablelm_b1_s4096"
BWD_SYMBOL = "flash_bwd_"     # every backward kernel's name starts so
BWD_MAIN = {torch.bfloat16: k3.BWD_BF16, torch.float32: k3.BWD_F32}
# the backward's tensor-core kernels, bf16 (wgmma) and float32 (3xTF32 on
# mma.sync), each at hd 64 and 128: ptxas must report no spills for them
BWD_TC_KERNELS = ("flash_bwd_dq_bf16_tc_kernel",
                  "flash_bwd_dkdv_bf16_tc_kernel",
                  "flash_bwd_dq_f32_tc_kernel",
                  "flash_bwd_dkdv_f32_tc_kernel")


def flash_bwd_bound(b, s, h, kv, d, causal, dtype) -> dict:
    """Least time for one backward call: q, k, v, o, do and the float32
    log-sum-exp read once, dq, dk, dv written once; five products over the
    visible pairs (S again, dP, dV, dQ, dK): 2 B H pairs 5 d operations,
    2.5 times the forward's, at the dtype's peak.  float32 also gets
    ``units_bound_ms``: the same work at the rate of the units the kernels
    run it on, 3xTF32 on the TF32 tensor cores (495 / 3 TFLOP/s)."""
    e = torch.finfo(dtype).bits // 8
    # q, o, do, dq: [B, S, H, d]; k, v, dk, dv: [B, S, KV, d]; lse float32
    nbytes = 4 * b * s * (h + kv) * d * e + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 2 * b * h * pairs * 5 * d
    out = bound(nbytes, ops, dtype)
    if dtype == torch.float32:
        out["units_bound_ms"] = max(nbytes / PEAK_BYTES_PER_S,
                                    ops / (TF32_FLOPS / 3)) * 1e3
    return out


class StepClock:
    """Wraps ``models.api.make_train_step`` while active: every step ends
    in a synchronize and its host milliseconds are kept; step
    ``TRAIN_PROFILED_STEP`` runs under ``torch.profiler``."""

    def __init__(self):
        self.ms, self.prof = [], None
        self._patch = None

    def __enter__(self):
        make = train_mod.api.make_train_step

        def timed_make(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(state, batch):
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(self.ms) == TRAIN_PROFILED_STEP:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        out = step(state, batch)
                        torch.cuda.synchronize()
                    self.prof = prof
                else:
                    out = step(state, batch)
                    torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed

        self._patch = mock.patch.object(train_mod.api, "make_train_step",
                                        timed_make)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def step_device_split(prof, top: int = 12) -> dict:
    """Device ms of the profiled step by kind: K3 forward, K3 backward,
    cuBLAS (GEMM kernels), the rest (elementwise, reductions, copies); and
    the ``top`` kernels by device ms with their counts."""
    from torch.autograd import DeviceType
    split = {"k3_forward": 0.0, "k3_backward": 0.0, "cublas": 0.0,
             "elementwise_and_other": 0.0}
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
        kernels.append({"kernel": ev.key[:120], "ms": us / 1e3,
                        "count": int(ev.count)})
        name = ev.key.lower()
        if BWD_SYMBOL in name:
            kind = "k3_backward"
        elif "flash_bf16_" in name or "flash_f32_" in name:
            kind = "k3_forward"
        elif any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass",
                                     "cublas", "sm90_")):
            kind = "cublas"
        else:
            kind = "elementwise_and_other"
        split[kind] += us / 1e3
    kernels.sort(key=lambda r: -r["ms"])
    return split, kernels[:top]


def train_model_flops(module, cfg, b: int, s: int) -> dict:
    """6 N T for the parameters that multiply (all but the input
    embedding table, a lookup) plus causal attention: the forward's 2 B H
    pairs (hd + hv) a layer, three times (forward and a backward of two
    such products each)."""
    n = sum(p.numel() for name, p in module.named_parameters()
            if name != "embed.embed_w" or module.head is None)
    pairs = s * (s + 1) // 2
    attn = 3 * 2 * b * cfg.num_heads * pairs * 2 * cfg.head_dim \
        * cfg.num_layers
    return {"matmul_params": n, "flops": 6 * n * b * s + attn,
            "attention_flops": attn}


def train_full(device, seed: int) -> dict:
    """(a) stablelm-1.6b at full width and depth, bf16, B=1, S=4096, 4 steps
    through ``launch.train.train``; the counts are zeroed just before and
    read just after."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    k3.reset_launch_counts()
    with StepClock() as clock:
        losses, state = train_mod.train(
            TRAIN_ARCH, steps=TRAIN_STEPS, reduced=False, seq_len=TRAIN_SEQ,
            batch=1, seed=seed, install_signals=False, log_every=1,
            device=device)
    launches = k3.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    cfg = state.params.cfg
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    want = {k: 0 for k in k3.LAUNCHES}
    want[k3.TC] = want[k3.BWD_BF16] = cfg.num_layers * TRAIN_STEPS
    if cfg.remat != "none" or launches != want:
        raise AssertionError(f"K3 launches in training {launches}, expected "
                             f"{want} (remat {cfg.remat})")
    timed = clock.ms[1:TRAIN_PROFILED_STEP]
    ms = statistics.median(timed)
    split, top = step_device_split(clock.prof)
    device_ms = sum(split.values())
    # the optimiser's share: one more AdamW update of the trained state
    # (the parameters stand in for gradients), CUDA events
    params = list(state.params.parameters())
    grads = [p.detach() for p in params]
    opt = optim.make_optimizer(cfg.optimizer, total_steps=TRAIN_STEPS)
    opt_state = [state.opt]

    def update():
        opt_state[0] = opt.apply(params, grads, opt_state[0])[1]

    optimizer_ms = time_ms(update, 3, warmup=1)
    flops = train_model_flops(state.params, cfg, 1, TRAIN_SEQ)
    out = {"arch": TRAIN_ARCH, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "optimizer": cfg.optimizer, "remat": cfg.remat, "B": 1,
           "S": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
           "step_ms_all": clock.ms, "ms_per_step": ms,
           "ms_per_step_spread": spread(timed),
           "tokens_per_s": TRAIN_SEQ / (ms / 1e3),
           "profiled_step_ms": clock.ms[TRAIN_PROFILED_STEP],
           "device_ms_by_kind": split, "device_ms": device_ms,
           "top_kernels": top, "optimizer_update_ms": optimizer_ms,
           "idle_share": 1.0 - device_ms / ms,
           "peak_memory_bytes": peak,
           "model_flops": flops,
           "model_flops_utilization": flops["flops"] / (ms / 1e3) / 989e12,
           "launches": launches,
           "note": "ms_per_step: host clock around a step ending in a "
                   "synchronize, median of steps 1-2 (step 0 warms up, step "
                   "3 runs under the profiler); device_ms: the profiled "
                   "step's kernels by kind; idle_share = 1 - device_ms / "
                   "ms_per_step; utilization = model flops / step time / "
                   "989 TFLOP/s; optimizer_update_ms: one AdamW update of "
                   "all parameters after the run (CUDA events, 3 runs)"}
    del state
    torch.cuda.empty_cache()
    return out


def _grads(module, batch):
    module.requires_grad_(True)
    loss, _ = tt.loss_fn(module, batch["tokens"], batch["labels"])
    return loss.detach(), torch.autograd.grad(loss, list(module.parameters()))


def train_card_vs_cpu(device, seed: int) -> dict:
    """(b) stablelm float32 at depth 2 and full width, B=1, S=512: the loss
    and every parameter gradient on the card (K3 float32 forward and
    backward kernels, cuBLAS in full float32) against the port's CPU path
    (plain versions) from the same weights and tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("stablelm_1_6b"), num_layers=2,
                              dtype="float32")
    cpu = tt.Transformer(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")
    card = tt.Transformer(cfg, generator=torch.Generator(device=device)
                          .manual_seed(seed), device=device)
    card.load_state_dict(cpu.state_dict())
    shape = ShapeConfig("train_cli", CARD_CPU_SEQ, 1, "train")
    batch = synth_batch(cfg, shape, DataConfig(seed=seed + 1), 0)
    k3.reset_launch_counts()
    loss_g, grads_g = _grads(card, batch)
    torch.cuda.synchronize()
    launches = k3.launch_counts()
    t0 = time.perf_counter()
    loss_c, grads_c = _grads(cpu, batch)
    cpu_s = time.perf_counter() - t0
    rel_loss = abs(float(loss_g) / float(loss_c) - 1)
    worst, errs = 0.0, {}
    for (name, _), g, c in zip(cpu.named_parameters(), grads_g, grads_c):
        err = float((g.cpu() - c).abs().max() / c.abs().max())
        errs[name] = err
        worst = max(worst, err)
    if rel_loss > CARD_CPU_LOSS_TOL or worst > CARD_CPU_GRAD_TOL:
        raise AssertionError(f"card vs CPU training: loss rel {rel_loss}, "
                             f"worst gradient {worst} ({errs})")
    want = {k: 0 for k in k3.LAUNCHES}
    want[k3.F32] = want[k3.BWD_F32] = cfg.num_layers
    if launches != want:
        raise AssertionError(f"K3 launches on the card {launches}, expected "
                             f"{want}")
    return {"layers": 2, "dtype": "float32", "B": 1, "S": CARD_CPU_SEQ,
            "loss_card": float(loss_g), "loss_cpu": float(loss_c),
            "loss_rel_diff": rel_loss, "worst_grad_rel_diff": worst,
            "grad_rel_diff": errs, "launches": launches,
            "cpu_seconds": cpu_s,
            "tolerance": {"loss": CARD_CPU_LOSS_TOL,
                          "grad_of_scale": CARD_CPU_GRAD_TOL}}


class TimedSave:
    """Wraps ``checkpoint.store.save`` while active: seconds and bytes of
    every write."""

    def __init__(self):
        self.writes = []
        self._patch = None

    def __enter__(self):
        save = ckpt_store.save

        def timed(ckpt_dir, step, tree, extra=None):
            t0 = time.perf_counter()
            out = save(ckpt_dir, step, tree, extra)
            self.writes.append({
                "step": step, "seconds": time.perf_counter() - t0,
                "bytes": int(sum(ckpt_store._to_numpy(v)[0].nbytes
                                 for v in tree.values()))})
            return out

        self._patch = mock.patch.object(ckpt_store, "save", timed)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def train_resume(device, seed: int) -> dict:
    """(c) stablelm bf16 at depth 2 and full width, S=4096: 4 steps with a
    checkpoint every 2; the step-4 checkpoint removed (a crash after step
    2's); restored and run to 4.  The 2 losses and the final parameters
    must be bitwise the uninterrupted run's."""
    ckdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)

    def cut(name):
        return dataclasses.replace(get_config(name), num_layers=RESUME_DEPTH)

    kw = dict(steps=RESUME_STEPS, reduced=False, seq_len=TRAIN_SEQ, batch=1,
              ckpt_dir=ckdir, ckpt_every=RESUME_EVERY, seed=seed,
              install_signals=False, log_every=100, device=device)
    try:
        with mock.patch.object(train_mod, "get_config", cut), \
                TimedSave() as saves:
            full, state = train_mod.train(TRAIN_ARCH, **kw)
            final = [p.detach().clone() for p in state.params.parameters()]
            del state
            torch.cuda.empty_cache()
            written = sorted(os.listdir(ckdir))
            shutil.rmtree(os.path.join(ckdir, f"step_{RESUME_STEPS}"))
            t0 = time.perf_counter()
            resumed, state = train_mod.train(TRAIN_ARCH, restore=True, **kw)
            resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    same = all(torch.equal(a, b)
               for a, b in zip(final, state.params.parameters()))
    if resumed != full[RESUME_EVERY:] or not same or \
            not all(np.isfinite(full)):
        raise AssertionError(f"resume != fresh: losses {full} then "
                             f"{resumed}, parameters bitwise {same}")
    del state, final
    torch.cuda.empty_cache()
    return {"layers": RESUME_DEPTH, "dtype": "bfloat16", "S": TRAIN_SEQ,
            "losses_fresh": full, "losses_resumed": resumed,
            "bitwise_losses_and_parameters": True,
            "checkpoints_written": written, "writes": saves.writes,
            "resumed_run_seconds": resume_s}


def bwd_case(gen, device, case, dtype) -> dict:
    """(d) K3's backward against flash_attention_bwd_plain on one shape,
    from the forward kernel's own o and log-sum-exp; twice, bitwise; the
    call, the dQ kernel alone and the dK / dV kernel alone timed beside the
    plain version, SDPA's backward and the bound."""
    name, b, s, h, kv, d, causal = case[:7]
    q = torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device=device).to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device=device).to(dtype)
    do = torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
    o, lse = k3.flash_attention_fwd(q, k, v, causal=causal)
    # the forward's log-sum-exp (what the backward recomputes P from)
    # against the plain forward's, within 1e-5 of its scale
    lse_plain = k3._plain_forward(q, k, v, causal, None)[1]
    lse_err = float((lse - lse_plain).abs().max())
    if lse_err > 1e-5 * float(lse_plain.abs().max()) or \
            not torch.equal(o, k3.flash_attention(q, k, v, causal=causal)):
        raise AssertionError(f"K3 forward with the LSE {name} {dtype}: "
                             f"lse max |diff| {lse_err}, or o differs from "
                             f"the prefill kernel's")
    del lse_plain
    plan = k3.plan_bwd(b, s, h, kv, d, dtype, causal,
                       torch.cuda.get_device_properties(device)
                       .multi_processor_count)
    if plan.variant != BWD_MAIN[dtype]:
        raise AssertionError(f"K3 backward {name} {dtype} planned "
                             f"{plan.variant}")
    scale = d ** -0.5

    def run():
        return k3.flash_attention_bwd(do, q, k, v, o, lse, causal=causal)

    g1, g2 = run(), run()
    gp = k3.flash_attention_bwd_plain(do, q, k, v, o, lse, causal=causal)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(g1, g2)):
        raise AssertionError(f"K3 backward {name} {dtype}: two runs differ")
    errs, rels = [], []
    for g, p, gname in zip(g1, gp, ("dq", "dk", "dv")):
        if g.shape != p.shape or g.dtype != dtype or \
                not torch.isfinite(g.float()).all():
            raise AssertionError(f"K3 backward {name} {gname}: {g.shape} "
                                 f"{g.dtype}, or not finite")
        err = float((g.float() - p.float()).abs().max())
        rel = err / float(p.float().abs().max())
        if rel > BWD_TOL[dtype]:
            raise AssertionError(f"K3 backward {name} {dtype} {gname}: "
                                 f"max |diff| {err} = {rel} of scale")
        errs.append(err)
        rels.append(rel)
    del gp
    # each kernel alone: the dK / dV kernel reads the scratch the last
    # full call wrote
    scratch = k3.bwd_launch(do, q, k, v, o, lse, causal, scale,
                            k3.BWD_BOTH)[3]
    bd = flash_bwd_bound(b, s, h, kv, d, causal, dtype)
    qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    lib_o = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=True)
    do_t = do.transpose(1, 2)
    summary = {key: val for key, val in dataclasses.asdict(plan).items()
               if not key.startswith("schedule")}
    if plan.schedule_dq:
        summary["items_a_block"] = {
            kern: [min(map(len, sched)), max(map(len, sched))]
            for kern, sched in (("dq", plan.schedule_dq),
                                ("dkdv", plan.schedule_dkdv))}
    row = {"case": name, "B": b, "S": s, "H": h, "KV": kv, "hd": d,
           "causal": causal, "dtype": SUFFIX[dtype], "plan": summary,
           "max_abs_err": max(errs), "rel_err_dq_dk_dv": rels,
           "lse_max_abs_err": lse_err,
           "ms": time_ms(run, 10),
           "dq_ms": time_ms(lambda: k3.bwd_launch(
               do, q, k, v, o, lse, causal, scale, k3.BWD_DQ), 10),
           "dkdv_ms": time_ms(lambda: k3.bwd_launch(
               do, q, k, v, o, lse, causal, scale, k3.BWD_DKDV, scratch), 10),
           "plain_ms": time_ms(lambda: k3.flash_attention_bwd_plain(
               do, q, k, v, o, lse, causal=causal), 1, warmup=1),
           "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
           "units_bound_ms": bd.get("units_bound_ms"),
           "library_ms": time_ms(lambda: torch.autograd.grad(
               lib_o, (qs, ks, vs), do_t, retain_graph=True), 10)}
    us = device_us({"bwd": (run, BWD_SYMBOL)}, reps=5)
    row["device_ms"] = None if us["bwd"] is None else us["bwd"] / 1e3
    return row


def phase_training(device, seed: int) -> dict:
    """The training path: (a) the full stablelm-1.6b run (the main path,
    counts zeroed just before and read just after), (b) card against the
    CPU in float32, (c) resume == fresh bitwise, (d) K3's backward alone
    against its plain version at the model shapes."""
    t0 = time.perf_counter()
    out = {"a_full": train_full(device, seed)}
    out["b_card_vs_cpu"] = train_card_vs_cpu(device, seed)
    out["c_resume"] = train_resume(device, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    out["d_k3_backward"] = [bwd_case(gen, device, case, dtype)
                            for dtype in BOTH_DTYPES
                            for case in BWD_CASES if dtype in case[7]]
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "training", **out,
          "tolerance": {"d_bf16": "max |kernel - plain| <= 2e-2 max |plain| "
                                  "per gradient",
                        "d_f32": "<= 1e-4 max |plain| per gradient"},
          "timing_note": "d: ms / library_ms CUDA events around back-to-back "
                         "calls after warm-up (library = SDPA's backward, "
                         "torch.autograd.grad of F.scaled_dot_product_"
                         "attention at the same shape, timed only); dq_ms / "
                         "dkdv_ms: the same around each kernel alone "
                         "(k3.bwd_launch with one part; the dK / dV kernel "
                         "reads the scratch of a full call); "
                         "device_ms: the backward's two kernels "
                         "(torch.profiler); bound = max(bytes of q, k, v, o, "
                         "do, lse, dq, dk, dv / 3.35 TB/s, 2 B H pairs 5 d / "
                         "peak: 989 TFLOP/s bf16, 67 f32); units_bound "
                         "(float32): the same operations at 495 / 3 TFLOP/s, "
                         "3xTF32 on the tensor cores"})
    return out


def bwd_rows(training, ptxas) -> list:
    """K3 backward's rows: the stablelm B=1 S=4096 shape, the qwen3 shape
    beside it; launches from the training path ((a) bf16, (b) float32)."""
    rows = []
    paths = {torch.bfloat16: ("a_full", "training (a): stablelm-1.6b, 4 "
                              "steps"),
             torch.float32: ("b_card_vs_cpu", "training (b): stablelm "
                             "float32 depth 2, one step on the card")}
    for dtype in (torch.bfloat16, torch.float32):
        name = BWD_MAIN[dtype]
        cases = [r for r in training["d_k3_backward"]
                 if r["dtype"] == SUFFIX[dtype]]
        head = next(r for r in cases if r["case"] == BWD_HEADLINE)
        path, what = paths[dtype]
        rows.append({
            "name": name, "route": "cuda", "source": FLASH_BWD_SOURCE,
            "replaces": REPLACES["flash_attention"],
            "also_replaces": "src/repro/models/layers.py:96 (jax.vjp of the "
                             "XLA attention the reference trains through)",
            "launches": training[path]["launches"][name],
            "launches_from": what,
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "plan": head["plan"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "units_bound_ms": head["units_bound_ms"],
            "device_ms": head["device_ms"], "dq_ms": head["dq_ms"],
            "dkdv_ms": head["dkdv_ms"],
            "shape": "B=1, S=4096, H=KV=32, hd=hv=64, causal",
            "model_shapes": [{k: r[k] for k in (
                "case", "B", "S", "H", "KV", "hd", "causal", "ms",
                "dq_ms", "dkdv_ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "units_bound_ms", "library_ms", "max_abs_err",
                "rel_err_dq_dk_dv")} for r in cases],
            "ptxas": [r for r in ptxas if "flash_bwd_" in r["kernel"]
                      and ("bf16" if dtype == torch.bfloat16 else "f32")
                      in r["kernel"]]})
    return rows


def kernels_line(numbers, launches, ptxas, select_timing) -> list:
    """K1's rows: the fused tile (K1 + K1a + K1b in one launch, the main
    path), then K1 and K1a alone (the general variant; K1 also the overflow
    fallback).  ``launches``: the campaign and selection phases' counts,
    summed; ``select_timing``: the selection phase's N=125,440 timings by
    (dtype, W), its lone query's W=1 first."""
    rows = []
    for dtype in DTYPES:
        sfx = SUFFIX[dtype]
        main, wide = numbers[(sfx, 4096)], numbers[(sfx, 65536)]
        whole = [select_timing[(sfx, w)] for w in SELECT_W]
        name = f"sweep_reduce_{sfx}"
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES["sweep_reduce"],
            "also_replaces": ["src/repro/core/costmodel.py:486",
                              "src/repro/core/costmodel.py:544"],
            "launches": launches[name], "max_abs_err": 0.0,
            "ms": main["fused_ms"], "plain_ms": main["fused_plain_ms"],
            "bound_ms": main["fused"]["bound_ms"],
            "bound_by": main["fused"]["bound_by"], "library_ms": None,
            "device_ms": main["fused_device_ms"],
            "tile_ms": main["fused_tile_ms"],
            "shape": f"W={main['W']}, N=4096, K={MAX_SURVIVORS}",
            "ptxas": [r for r in ptxas if "k1_sweep_reduce_kernelI"
                      + ("d" if dtype == torch.float64 else "f")
                      in r["kernel"]],
            "old_chain": {"device_chain_ms": main["device_chain_ms"],
                          "general_tile_ms": main["general_tile_ms"]},
            "n65536": {"ms": wide["fused_ms"],
                       "device_ms": wide["fused_device_ms"],
                       "tile_ms": wide["fused_tile_ms"],
                       "plain_ms": wide["fused_plain_ms"],
                       "bound_ms": wide["fused"]["bound_ms"],
                       "bound_by": wide["fused"]["bound_by"],
                       "old_chain": {
                           "device_chain_ms": wide["device_chain_ms"],
                           "general_tile_ms": wide["general_tile_ms"]}},
            "n125440": [{"W": t["W"], "ms": t["fused_ms"],
                         "device_ms": t["fused_device_ms"],
                         "tile_ms": t["fused_tile_ms"],
                         "plain_ms": t["fused_plain_ms"],
                         "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"], "plan": t["plan"]}
                        for t in whole]})
        for kname, key in (("dse_sweep", "sweep"), ("screen_rows", "screen")):
            name = f"{kname}_{sfx}"
            err = main["err"][f"{key}_max_abs_err"]
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[kname], "launches": launches[name],
                "max_abs_err": err,
                "ms": main[f"{key}_ms"], "plain_ms": main[f"{key}_plain_ms"],
                "bound_ms": main[key]["bound_ms"],
                "bound_by": main[key]["bound_by"], "library_ms": None,
                "device_ms": main[f"{key}_device_ms"],
                "shape": f"W={main['W']}, N=4096",
                "n65536": {"ms": wide[f"{key}_ms"],
                           "device_ms": wide[f"{key}_device_ms"],
                           "plain_ms": wide[f"{key}_plain_ms"],
                           "bound_ms": wide[key]["bound_ms"],
                           "bound_by": wide[key]["bound_by"]}})
            if key == "sweep":
                rows[-1]["n125440"] = [
                    {"W": t["W"], "ms": t["sweep_ms"],
                     "device_ms": t["sweep_device_ms"],
                     "bound_ms": t["sweep_bound_ms"],
                     "bound_by": t["sweep_bound_by"]} for t in whole]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--large-freq-points", type=int, default=25_600,
                    help="DVFS lattice density of the large campaign "
                         "(392 rows x this many points)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = phase_device()
    built = phase_build()
    # first after the build: in runs where it followed the ResNet phase's
    # profiles, the profiler read no device time for K3 alone
    flash = phase_flash_attention(device, args.seed)
    ssd = phase_ssd_scan(device, args.seed)
    # before the later phases' profiles (see above), and while the card's
    # memory is free: the full-width run holds ~40 GB
    training = phase_training(device, args.seed)
    workloads = make_workloads(args.seed)
    ptxas = built[kern.SOURCE]["kernels"]
    numbers = phase_kernels(workloads, device, ptxas)
    main_path = phase_campaign_default(workloads, device)
    phase_campaign_resume(workloads, device, main_path["fresh64"])
    large = phase_campaign_large(workloads, device, args.large_freq_points,
                                 numbers)
    models = phase_predictors(workloads, device, args.seed)
    phase_campaign_fast(workloads, device, models, main_path["exact"])
    adaptive = phase_adaptive(workloads, device, main_path["exact"])
    selection = phase_selection(workloads, device, main_path["campaign64"],
                                main_path["fresh64"], models, args.seed)
    fabric = phase_fabric(workloads, device, main_path, adaptive)
    campaign_launches = {k: v + large[k] + adaptive["launches"][k]
                         + selection["launches"][k] + fabric["launches"][k]
                         for k, v in main_path["launches"].items()}
    cfg, models, images = resnet_inputs(device, args.seed)
    per_dtype = phase_conv2d(device, args.seed, models[torch.bfloat16],
                             images[32])
    infer = phase_resnet50(device, args.seed, cfg, models, images)
    del models, images
    lm = phase_transformer(device, args.seed)
    mb = phase_mamba2(device, args.seed)
    phase_token_serving(device, args.seed)
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels_line(numbers, campaign_launches, ptxas,
                                  selection["timing"])
          + conv_rows(per_dtype, infer) + flash_rows(flash, lm, training)
          + bwd_rows(training, built[k3.BWD_SOURCE]["kernels"])
          + ssd_rows(ssd, mb)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
