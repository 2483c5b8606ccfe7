#!/usr/bin/env python3
"""Check and time the PyTorch port's SSD-scan backward (K4 backward) alone.

    python3 tools/ssd_scan_bwd_ms.py [--root DIR] [--iters 10] [--seed 0]
                                     [--shapes test,mamba2_b1,...]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  For each shape and input
dtype (bf16, float32) on seeded random inputs on the first CUDA card (dt
in U(0.01, 0.2), A in -U(0.5, 2), a float32 dy and final-state cotangent):
runs K4's forward with its scratch, then ``ssd_scan_bwd`` twice, and holds
both runs bitwise equal and each gradient within its gate of
``ssd_scan_bwd_plain`` on the same inputs (max |kernel - plain| <= 1e-4
max |plain| for float32 inputs, 2e-2 for bf16); then prints one JSON
object: the library's build seconds and ptxas report, and per case the
errors, the milliseconds of one call (CUDA events around ``--iters``
back-to-back calls after a warm-up) and the device milliseconds of each
kernel (``torch.profiler``, mean of 3 calls), beside the card's name and
power limit (``nvidia-smi``).  Exits 1 on a disagreement, 2 without a CUDA
card.
"""

import argparse
import json
import os
import subprocess
import sys

# (name, b, S, nh, hp, ds, chunk)
SHAPES = {"test": (2, 48, 3, 8, 16, 16),
          "general": (2, 300, 2, 72, 40, 100),
          "shared_cb_small": (2, 512, 3, 64, 64, 128),
          "mamba2_b1": (1, 4096, 24, 64, 128, 256),
          "mamba2_b8": (8, 4096, 24, 64, 128, 256),
          "zamba2_b1": (1, 4096, 64, 64, 64, 256)}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def kernel_split(fn, torch, reps: int = 3) -> dict:
    """Device ms of each K4-backward kernel per call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        if "ssd_bwd_" not in ev.key:
            continue
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
        name = ev.key[ev.key.find("ssd_bwd_"):][:60]
        out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out


def plan_and_shape(k4, torch, shape, dtype):
    """``plan_bwd`` and ``bwd_launch_shape`` of the checkout under test on
    this card (a checkout whose backward has one variant plans without the
    card's SM count or the dtype)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        return (k4.plan_bwd(*shape, dtype, sms),
                k4.bwd_launch_shape(*shape, dtype, sms))
    except TypeError:
        return k4.plan_bwd(*shape, dtype), k4.bwd_launch_shape(*shape)


def plan_smem(plan) -> dict:
    """The dynamic shared memory the plan expects, per launch."""
    return getattr(plan, "smem", None) or {"dcum": plan.dcum_smem}


def time_ms(fn, torch, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as k4

    k4._bwd_library()
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "build_seconds": build.build_seconds.get(k4.BWD_SOURCE),
           "ptxas": build.build_logs.get(k4.BWD_SOURCE, "").splitlines(),
           "cases": []}
    print(json.dumps({k: v for k, v in out.items() if k != "cases"}),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    bad = False
    for name in args.shapes.split(","):
        b, s, nh, hp, ds, q = SHAPES[name]
        for dtype in ("bfloat16", "float32"):
            dt_ = getattr(torch, dtype)
            plan, shape = plan_and_shape(k4, torch, (b, s, nh, hp, ds, q),
                                         dt_)
            launched = shape["launches"]
            if {k: v["grid"] for k, v in launched.items()} != plan.grids \
                    or any(launched[k]["smem"] != v
                           for k, v in plan_smem(plan).items()):
                raise AssertionError(f"{name}: plan {plan} != library "
                                     f"{shape}")
            x = torch.randn((b, s, nh, hp), generator=g,
                            device="cuda").to(dt_)
            dt = torch.rand((b, s, nh), generator=g, device="cuda") * 0.19 \
                + 0.01
            A = -(torch.rand((nh,), generator=g, device="cuda") * 1.5 + 0.5)
            B, C = (torch.randn((b, s, 1, ds), generator=g, device="cuda")
                    .to(dt_) for _ in range(2))
            dy = torch.randn((b, s, nh, hp), generator=g, device="cuda")
            df = torch.randn((b, nh, hp, ds), generator=g, device="cuda")
            _, _, scr = k4.ssd_scan_with_scratch(x, dt, A, B, C, chunk=q,
                                                 out_dtype=torch.float32)

            def call():
                return k4.ssd_scan_bwd(dy, df, x, dt, A, B, C, chunk=q,
                                       states=scr["states"], cum=scr["cum"])

            g1, g2 = call(), call()
            gp = k4.ssd_scan_bwd_plain(dy, df, x, dt, A, B, C, chunk=q)
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(g1, g2))
            rels = {}
            for gn, u, w in zip(("dx", "ddt", "dA", "dB", "dC"), g1, gp):
                scale = float(w.float().abs().max())
                rels[gn] = float((u.float() - w.float()).abs().max()) / scale
            ok = same and all(r <= TOL[dtype] for r in rels.values()) and \
                all(torch.isfinite(u.float()).all() for u in g1)
            bad |= not ok
            row = {"case": name, "shape": [b, s, nh, hp, ds, q],
                   "dtype": dtype,
                   "variant": getattr(plan, "variant", "general"),
                   "groups": getattr(plan, "groups", 1), "rel_err": rels,
                   "twice_bitwise": same,
                   "ok": ok, "ms": time_ms(call, torch, args.iters),
                   "split": kernel_split(call, torch)}
            out["cases"].append(row)
            print(json.dumps(row), flush=True)
            del g1, g2, gp, scr
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
