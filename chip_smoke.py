#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and `nvcc`:

    python3 chip_smoke.py [--seed 0] [--large-freq-points 25600]

It builds the hand-written kernels from `src/repro_torch/kernels/csrc/`,
holds each against its plain PyTorch version on the card, and drives the
port's main path — the fused campaign sweep — through `Campaign.run`.
Every phase prints one JSON object on a line of its own; any failed phase
raises, so the exit code is non-zero and the last line is missing.  Without
a CUDA device the script exits non-zero before printing anything.

Lines, in order:
  {"phase": "device", ...}           card, power limit, torch / CUDA versions
  {"phase": "build", ...}            seconds nvcc took, ptxas register report
  {"phase": "kernels", ...}          per-case comparison kernel vs plain
  {"phase": "campaign_default", ...} 125,440-candidate campaign, three tiers
  {"phase": "campaign_resume", ...}  checkpoint / resume == fresh
  {"phase": "campaign_large", ...}   ~10M-candidate campaign, float32
  {"kernels": [...]}                 one entry per kernel: times, bound, launches
  <name>, <power limit>              as nvidia-smi prints them
  {"ok": true, "device": {...}}      the last line

It imports nothing of `jax` or of the reference package `repro`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import costmodel, dse  # noqa: E402
from repro_torch.dse_campaign import (Campaign, CampaignConfig,  # noqa: E402
                                      DEFAULT_VARIANTS, SpaceSpec,
                                      TileEvaluator, canonical_frontier,
                                      default_campaign_space,
                                      frontiers_identical)
from repro_torch.hw import CHIPS, get_chip  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dse_sweep as kern  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/dse_sweep.cu"
# file:line of what each kernel replaces in the reference package
REPLACES = {"dse_sweep": "src/repro/kernels/dse_sweep.py:52",
            "screen_rows": "src/repro/core/costmodel.py:486"}

# Published peaks of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of device
# memory; 67 TFLOP/s float32 outside the tensor cores; float64 vector rate
# is half of that.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
# arithmetic operations per (workload, lane) element, counted off the kernel
# source (adds, multiplies, divides, compares, min/max each as one)
SWEEP_OPS_PER_ELEMENT = 122
SCREEN_OPS_PER_ELEMENT = 80

BASE = {"flops": 3.2e14, "hbm_bytes": 4.5e13, "collective_bytes": 5e11,
        "wire_bytes": 7e11}
CELLS = [("qwen3_14b", "train_4k"), ("qwen3_14b", "decode_32k"),
         ("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "prefill_32k"),
         ("mamba2_130m", "train_4k"), ("zamba2_1_2b", "train_4k")]
DTYPES = (torch.float64, torch.float32)
SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


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
    """Mean device microseconds of the two hand-written kernels as
    ``torch.profiler`` sees them (kernel execution only, no launch overhead),
    keyed like ``fns``; values are None where the profiler reports no device
    time on this machine.  An extra reading beside the event timings: the
    comparison and the campaign gates do not depend on it."""
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
        out[key] = total / count if count and total > 0 else None
    return out


def sweep_bound(w: int, n: int, dtype) -> dict:
    s = torch.finfo(dtype).bits // 8
    nbytes = (18 * n + 6 * w) * s + 2 * w * n * s + w * n
    return bound(nbytes, SWEEP_OPS_PER_ELEMENT * w * n, dtype)


def screen_bound(w: int, n: int, dtype) -> dict:
    s = torch.finfo(dtype).bits // 8
    nbytes = 2 * w * n * s + w * n + w * n + 2 * w * 8 + 2 * w * s
    return bound(nbytes, SCREEN_OPS_PER_ELEMENT * w * n, dtype)


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


def phase_build() -> None:
    t0 = time.perf_counter()
    path = build.build(kern.SOURCE, force=True)
    kern._library()
    usage = [ln.strip() for ln in build.build_logs[kern.SOURCE].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds[kern.SOURCE],
          "flags": " ".join(build.NVCC_FLAGS),
          "library": os.path.relpath(path, ROOT), "ptxas": usage})


def tile_inputs(engine: TileEvaluator, lo: int, hi: int, dtype, device):
    """Packed (cand_cols, wl_cols) on the card for space[lo:hi), padded to
    the engine's chunk exactly as the campaign pads it."""
    batch = engine.space.slice(lo, hi, with_candidates=False)
    arrays = engine.padded_tile_arrays(batch)
    cand = costmodel.pack_cand_cols(arrays, dtype).to(device)
    wl = torch.as_tensor(engine.wl_cols).to(device=device, dtype=dtype)
    return cand, wl.contiguous()


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


def phase_kernels(workloads, device) -> dict:
    """Each kernel against its plain version at the main-path shape
    (W=6, N=4096) and at W=6, N=65536, plus an all-infeasible tile and a
    partial tile; then the timings.  Returns per-kernel numbers."""
    cons = dse.Constraint(max_power_w=40_000)
    none_ok = dse.Constraint(max_power_w=1e-3, min_hbm_fit=False)
    cases, all_tiles, numbers = [], [], {}
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
            cases.append(compare_case(f"full_n{n}", cand, wl, cons, dtype))
            cases.append(compare_case(f"all_infeasible_n{n}", cand, wl,
                                      none_ok, dtype))
            if cases[-1]["feasible"] != 0 or cases[-1]["survivors"] != 0:
                raise AssertionError("all-infeasible tile has feasible lanes")
            # the space's last tile is partial: padding lanes carry valid=0
            last_lo = (space.n_tiles() - 1) * n
            pc, pw = tile_inputs(eng, last_lo, len(space), dtype, device)
            n_valid = len(space) - last_lo
            if not 0 < n_valid < n:
                raise AssertionError("expected a partial last tile")
            cases.append(compare_case(f"partial_n{n}_valid{n_valid}", pc, pw,
                                      cons, dtype))
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
                    tot["feasible"] += c["feasible"]
                    tot["survivors"] += c["survivors"]
                    tot["sweep_max_ulp"] = max(tot["sweep_max_ulp"],
                                               c["sweep_max_ulp"])
                all_tiles.append({"case": f"all_{space.n_tiles()}_tiles_n{n}",
                                  "dtype": sfx, **tot, "screen_equal": True})

            # timings on the full tile
            kw = dict(max_power_w=cons.max_power_w)
            e, l, f = kern.dse_sweep(cand, wl, **kw)
            iters = 200 if n == 4096 else 50
            w = int(wl.shape[0])
            t = {
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
                costmodel._compact_rows_device(kk, ee, ll, 2048)

            t["device_chain_ms"] = time_ms(chain, iters)
            us = device_us({
                "sweep": (lambda: kern.dse_sweep(cand, wl, **kw),
                          "dse_sweep_kernel"),
                "screen": (lambda: kern.screen_rows(e, l, f),
                           "screen_rows_kernel")})
            t["sweep_device_ms"] = None if us["sweep"] is None \
                else us["sweep"] / 1e3
            t["screen_device_ms"] = None if us["screen"] is None \
                else us["screen"] / 1e3
            numbers[(sfx, n)] = {**t, "W": w,
                                 "sweep": sweep_bound(w, n, dtype),
                                 "screen": screen_bound(w, n, dtype),
                                 "err": cases[-3]}
    emit({"phase": "kernels", "cases": cases + all_tiles,
          "timing": [{"dtype": k[0], "N": k[1],
                      **{m: v for m, v in val.items() if m.endswith("_ms")}}
                     for k, val in numbers.items()],
          "timing_note": "*_ms: CUDA events around back-to-back wrapper "
                         "calls after warm-up (launch overhead included, "
                         "inputs L2-resident); *_device_ms: kernel execution "
                         "alone as torch.profiler reports it"})
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
    shares = {}
    if trace:
        dur = {}
        for r in tel.tracer.records:
            dur[r.name] = dur.get(r.name, 0.0) + r.dur
        total = dur.get("tile_eval", 0.0)
        shares = {k: dur.get(k, 0.0) / total
                  for k in ("pad", "launch", "compact", "merge")}
    return camp, result, shares


def summarize(result, shares) -> dict:
    return {"wall_s": result.wall_s,
            "evaluations_per_s": result.candidates_evaluated / result.wall_s,
            "tile_ms": 1e3 * result.sweep_wall_s / max(result.tiles_done, 1),
            "span_share_of_tile": shares}


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
    c64, r64, s64 = run_campaign(workloads, space, "cuda", torch.float64,
                                 device, cons)
    c32, r32, s32 = run_campaign(workloads, space, "cuda", torch.float32,
                                 device, cons)
    launches = kern.launch_counts()

    for name, count in launches.items():
        if count != n_tiles:
            raise AssertionError(f"{name}: {count} launches on the main "
                                 f"path, expected {n_tiles} (one per tile)")
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
          "exact_torch_float64": summarize(exact, {}),
          "cuda_float64": summarize(r64, s64),
          "cuda_float32": summarize(r32, s32)})
    return {"launches": launches, "fresh64": r64}


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


def phase_campaign_large(workloads, device, freq_points, numbers) -> None:
    """A space a user of a million-point campaign would call real, float32
    fused tier; frontier members re-checked against the scalar simulator."""
    cons = dse.Constraint(max_power_w=40_000)
    space = SpaceSpec(chips=tuple(CHIPS),
                      chip_counts=(4, 8, 16, 32, 64, 128, 256, 512, 1024),
                      freq_points=freq_points, mesh_dims=3,
                      variants=DEFAULT_VARIANTS, chunk_size=65_536)
    _, res, shares = run_campaign(workloads, space, "cuda", torch.float32,
                                  device, cons)
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
    chain_ms = numbers[("f32", 65536)]["device_chain_ms"]
    busy_s = res.n_tiles * chain_ms / 1e3
    emit({"phase": "campaign_large", "candidates": len(space),
          "rows": space.n_rows, "freq_points": freq_points,
          "workloads": len(workloads), "tiles": res.n_tiles,
          "dtype": "float32", **summarize(res, shares),
          "frontier_sizes": sizes,
          "frontier_max_rel_err_vs_scalar_simulator": worst,
          "device_busy_s": busy_s,
          "device_idle_share": 1.0 - busy_s / res.wall_s,
          "device_idle_note": "busy = tiles x the sweep+screen+compaction "
                              "chain timed by CUDA events at this tile shape "
                              "in the kernels phase; the rest of the wall is "
                              "host work and copies"})


def kernels_line(numbers, launches) -> dict:
    rows = []
    for dtype in DTYPES:
        sfx = SUFFIX[dtype]
        main, wide = numbers[(sfx, 4096)], numbers[(sfx, 65536)]
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
    return {"kernels": rows}


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
    phase_build()
    workloads = make_workloads(args.seed)
    numbers = phase_kernels(workloads, device)
    main_path = phase_campaign_default(workloads, device)
    phase_campaign_resume(workloads, device, main_path["fresh64"])
    phase_campaign_large(workloads, device, args.large_freq_points, numbers)
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit(kernels_line(numbers, main_path["launches"]))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
