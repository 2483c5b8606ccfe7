#!/usr/bin/env python3
"""Time of the PyTorch port's SSD chunk-scan kernel (K4) alone, from a checkout.

    python3 tools/ssd_scan_ms.py [--root DIR] [--iters 50] [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Calls
``repro_torch.kernels.ssd_scan.ssd_scan`` with float32 output (the model's
path) at mamba2-130m's prefill shapes of ``chip_smoke.py`` -- 24 heads of
64, state 128, chunk 256, at B=1 S=4096 and B=8 S=1024 -- with bf16 and
float32 inputs, on seeded random inputs on the first CUDA card (dt in
U(0.01, 0.2), A in -U(0.5, 2)), and prints one JSON object: per shape the
milliseconds of one call (CUDA events around ``--iters`` back-to-back
calls after a warm-up, inputs L2-warm where they fit) and the device
milliseconds of each kernel of one call (``torch.profiler``, mean of 5
calls; empty where the profiler reads no device time), with the card's
name.  Needs a CUDA card; exits 2 without one.
"""

import argparse
import json
import os
import sys

# (name, dtype, b, S, nh, hp, ds, chunk)
SHAPES = (("mamba2_b1_s4096", "bfloat16", 1, 4096, 24, 64, 128, 256),
          ("mamba2_b8_s1024", "bfloat16", 8, 1024, 24, 64, 128, 256),
          ("mamba2_b1_s4096_f32", "float32", 1, 4096, 24, 64, 128, 256),
          ("mamba2_b8_s1024_f32", "float32", 8, 1024, 24, 64, 128, 256))


def kernel_split(fn, torch, reps: int = 5) -> dict:
    """Device ms of each kernel per call of ``fn``, by kernel name."""
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
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
        name = ev.key[ev.key.find("ssd_"):] if "ssd_" in ev.key else ev.key
        out[name[:80]] = out.get(name[:80], 0.0) + us / reps / 1e3
    return out


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import ssd_scan as k4

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "ms": {}, "split": {}}
    for name, dtype, b, s, nh, hp, ds, q in SHAPES:
        dt_ = getattr(torch, dtype)
        x = torch.randn((b, s, nh, hp), generator=g, device="cuda").to(dt_)
        dt = torch.rand((b, s, nh), generator=g, device="cuda") * 0.19 + 0.01
        A = -(torch.rand((nh,), generator=g, device="cuda") * 1.5 + 0.5)
        B, C = (torch.randn((b, s, 1, ds), generator=g, device="cuda")
                .to(dt_) for _ in range(2))

        def call():
            k4.ssd_scan(x, dt, A, B, C, chunk=q, out_dtype=torch.float32)

        for _ in range(5):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            call()
        end.record()
        torch.cuda.synchronize()
        out["ms"][name] = start.elapsed_time(end) / args.iters
        out["split"][name] = kernel_split(call, torch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
