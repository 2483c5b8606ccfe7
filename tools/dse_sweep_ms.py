#!/usr/bin/env python3
"""Time of the PyTorch port's per-tile campaign chain (K1) and of the default
campaign on the fused tier, from a checkout.

    python3 tools/dse_sweep_ms.py [--root DIR] [--iters 200] [--runs 3]
                                  [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Six workloads named after
real (arch, shape) cells with a synthetic census drawn from ``--seed`` (as
``chip_smoke.py`` draws them), the constraint ``max_power_w=40_000``, on the
first CUDA card:

* per tile of ``default_campaign_space(chunk_size=N)``, N 4096 and 65536,
  float64 and float32: ``tile_ms``, CUDA events around ``--iters``
  back-to-back calls of ``repro_torch.kernels.ops.dse_sweep`` (what the
  campaign calls a tile: the launches, the copies to the host and the
  synchronisation); ``device_chain_ms``, the same around the device work
  alone (the fused kernel where the checkout has it, else K1 -> K1a -> the
  compaction); ``device_ms``, every kernel of one ``ops.dse_sweep`` call
  summed (``torch.profiler``, mean of 20 calls; null where the profiler
  reads no device time);
* ``Campaign.run`` over ``default_campaign_space()`` on the ``"cuda"``
  tier in float64 and float32, ``--runs`` times each, as it runs
  (``thread``: a worker thread makes the next tile's arrays) and with the
  tiles made inline on the calling thread (``inline``: the runner's
  ``_TilePrefetcher`` replaced, so that the worker's hold on the GIL does
  not land in the spans): wall seconds, ms per tile and the ms per tile of
  each span (``pad``, ``launch``, ``compact``, ``merge``), each run and
  the median.

Prints one JSON object with the card's name and power limit as
``nvidia-smi`` gives them.  Needs a CUDA card; exits 2 without one.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

CELLS = [("qwen3_14b", "train_4k"), ("qwen3_14b", "decode_32k"),
         ("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "prefill_32k"),
         ("mamba2_130m", "train_4k"), ("zamba2_1_2b", "train_4k")]
BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}


def make_workloads(dse, np, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for arch, shape in CELLS:
        scale = float(10.0 ** rng.uniform(-1.5, 0.5))
        out.append(dse.Workload(
            arch, shape, {k: v * scale for k, v in BASE.items()}, 256,
            float(rng.uniform(0.1, 2.0))))
    return out


def events_ms(torch, fn, iters: int) -> float:
    for _ in range(5):
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


def device_ms(torch, fn, reps: int = 20):
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


class InlineTiles:
    """The runner's tile iterator without its worker thread."""

    def __init__(self, it, depth: int = 1):
        self._it = iter(it)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self):
        pass


def campaign_runs(torch, Campaign, CampaignConfig, Telemetry, workloads,
                  space, dtype, device, cons, runs: int) -> dict:
    out = []
    for _ in range(runs):
        tel = Telemetry()
        camp = Campaign(workloads, CampaignConfig(
            space=space, evaluator="cuda", dtype=dtype, device=device,
            constraint=cons), telemetry=tel)
        torch.cuda.synchronize()
        res = camp.run()
        torch.cuda.synchronize()
        dur = {}
        for r in tel.tracer.records:
            dur[r.name] = dur.get(r.name, 0.0) + r.dur
        tiles = max(res.tiles_done, 1)
        out.append({"wall_s": res.wall_s,
                    "tile_ms": 1e3 * res.sweep_wall_s / tiles,
                    **{f"{k}_ms_per_tile": 1e3 * dur.get(k, 0.0) / tiles
                       for k in ("pad", "launch", "compact", "merge")}})
    return {"runs": out,
            "median": {k: statistics.median(r[k] for r in out)
                       for k in out[0]}}


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.core import costmodel, dse
    from repro_torch.dse_campaign import (Campaign, CampaignConfig,
                                          TileEvaluator,
                                          default_campaign_space, runner)
    from repro_torch.kernels import dse_sweep as kern
    from repro_torch.kernels import ops
    from repro_torch.telemetry import Telemetry

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    workloads = make_workloads(dse, np, args.seed)
    cons = dse.Constraint(max_power_w=40_000)
    fused = hasattr(kern, "sweep_reduce_packed")
    host_kw = {}
    if "host_buffer" in inspect.signature(ops.dse_sweep).parameters:
        host_kw["host_buffer"] = kern.ResultBuffer()
    out = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "chain": "fused" if fused else "K1 -> K1a -> compaction",
           "tile": {}, "campaign": {}}
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        for n in (4096, 65536):
            space = default_campaign_space(chunk_size=n)
            eng = TileEvaluator(workloads, CampaignConfig(
                space=space, evaluator="cuda", dtype=dtype, device=device,
                constraint=cons))
            lo = 5 * n if n == 4096 else 0
            batch = space.slice(lo, lo + n, with_candidates=False)
            cand = costmodel.pack_cand_cols(eng.padded_tile_arrays(batch),
                                            dtype).to(device)
            wl = torch.as_tensor(eng.wl_cols).to(device=device,
                                                 dtype=dtype).contiguous()

            def tile():
                ops.dse_sweep(cand, wl, constraint=cons, max_survivors=2048,
                              **host_kw)

            if fused:
                def chain():
                    kern.sweep_reduce_packed(cand, wl, max_power_w=40_000)
            else:
                def chain():
                    e, l, f = kern.dse_sweep(cand, wl, max_power_w=40_000)
                    keep = kern.screen_rows(e, l, f)[0]
                    costmodel._compact_rows_device(keep, e, l, 2048)

            out["tile"][f"{sfx}_n{n}"] = {
                "tile_ms": events_ms(torch, tile, args.iters),
                "device_chain_ms": events_ms(torch, chain, args.iters),
                "device_ms": device_ms(torch, tile)}
    space = default_campaign_space()
    threaded = runner._TilePrefetcher
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        out["campaign"][sfx] = {}
        for mode, tiles in (("thread", threaded), ("inline", InlineTiles)):
            runner._TilePrefetcher = tiles
            try:
                out["campaign"][sfx][mode] = campaign_runs(
                    torch, Campaign, CampaignConfig, Telemetry, workloads,
                    space, dtype, device, cons, args.runs)
            finally:
                runner._TilePrefetcher = threaded
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
