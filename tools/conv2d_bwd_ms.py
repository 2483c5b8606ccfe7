#!/usr/bin/env python3
"""Check and time the PyTorch port's convolution gradient (K2 backward) alone.

    python3 tools/conv2d_bwd_ms.py [--root DIR] [--batch 32] [--iters 10]
                                   [--seed 0] [--shapes test,resnet50]
                                   [--tiles [--repeat 3]]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  For each shape and dtype
(bf16, float32) on seeded random inputs on the first CUDA card (x ~ N(0, 1),
He-scaled w, dy ~ N(0, 1)): runs ``conv2d_wgrad`` and ``conv2d_dgrad`` twice
each, and holds both runs bitwise equal and each gradient within K2's gate
of its plain version on the same inputs (max |kernel - plain| <= 1e-5 max
|plain| in float32, 1e-2 in bf16); then prints one JSON object per case:
the plans, the errors, the milliseconds of one call of each (CUDA events
around ``--iters`` back-to-back calls after a warm-up), the plain versions'
and cuDNN's (``torch.nn.grad.conv2d_weight`` / ``conv2d_input`` on
channels-last views, TF32 off) for the same gradient, and the bound (bytes
of the inputs and the output over 3.35 TB/s, or the products' operations
over 989 TFLOP/s bf16 / 67 TFLOP/s float32, whichever is larger).  The
first line holds the build seconds and ptxas report of
``csrc/conv2d_bwd.cu``, the last the card's name and power limit
(``nvidia-smi``).  Shapes ``resnet50``: ResNet-50's 16 distinct stride-1
convolutions at ``--batch`` (224x224 images) with the count of each in one
forward; ``test``: small and ragged ones (odd sizes, Cin or Cout not a
multiple of 8, a 5x3 kernel, B=2).  ``device_ms`` beside each ``ms``:
the same calls queued behind a sleep kernel, so that the card runs them
back to back (the host's launch time hidden), timed by CUDA events.

``--tiles``: for each ResNet-50 shape in bf16, also the weight gradient
under every tensor-core tile ``(bm, bn, taps)`` of ``k2.WGRAD_TILES`` that
the shape takes (``plan_wgrad(..., tile)``), each held to the same gate
against the plain version and timed (``device_ms``: the median of
``--repeat`` readings taken in turns), on one line a shape.
Exits 1 on a disagreement, 2 without a CUDA card.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys

# (H = W, Cin, Cout, k, count in one ResNet-50 forward)
RESNET50 = ((56, 64, 64, 1, 1), (56, 256, 64, 1, 2), (56, 64, 64, 3, 3),
            (56, 64, 256, 1, 4), (56, 256, 128, 1, 1), (28, 512, 128, 1, 3),
            (28, 128, 128, 3, 3), (28, 128, 512, 1, 4), (28, 512, 256, 1, 1),
            (14, 1024, 256, 1, 5), (14, 256, 256, 3, 5), (14, 256, 1024, 1, 6),
            (14, 1024, 512, 1, 1), (7, 2048, 512, 1, 2), (7, 512, 512, 3, 2),
            (7, 512, 2048, 1, 3))
# (B, H, W, Cin, Cout, kh, kw, padding)
TEST = ((2, 9, 11, 16, 24, 3, 3, ((1, 1), (1, 1))),
        (2, 13, 7, 8, 40, 1, 1, ((0, 0), (0, 0))),
        (3, 10, 12, 20, 12, 5, 3, ((2, 1), (1, 0))),
        (2, 6, 6, 136, 264, 3, 3, ((1, 1), (1, 1))))
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
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


_SLEEP_CYCLES_PER_MS = []


def queued_ms(torch, fn, calls: int = 10, sleep_ms: float = 20.0):
    """Device ms of one ``fn()``: ``calls`` calls queued behind a sleep
    kernel of ``sleep_ms``, timed by CUDA events around them; None where the
    host took longer than the sleep to queue them."""
    import time
    if not _SLEEP_CYCLES_PER_MS:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / max(s.elapsed_time(e), 1e-3))
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * _SLEEP_CYCLES_PER_MS[0]))
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls if host_ms < sleep_ms else None


def bound(pixels, b, h, w, cin, cout, kh, kw, dtype_name, itemsize):
    """The least time of one gradient: the larger of its bytes (two inputs
    read once, the output written once) and its operations at peak."""
    ops = 2 * pixels * kh * kw * cin * cout
    nbytes = itemsize * (b * h * w * cin + pixels * cout + kh * kw * cin * cout)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": ops}


def case(torch, k2, gen, dev, shape, dtype, iters):
    b, h, w, cin, cout, kh, kw, pads = shape
    (pt, pb), (pl, pr) = pads
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    x = torch.randn((b, h, w, cin), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((kh, kw, cin, cout), generator=gen, device=dev)
          * (2.0 / (kh * kw * cin)) ** 0.5).to(dtype)
    dy = torch.randn((b, ho, wo, cout), generator=gen, device=dev).to(dtype)
    name = str(dtype).split(".")[-1]
    out = {"shape": [b, h, w, cin, cout, kh, kw], "padding": pads,
           "dtype": name,
           "wgrad_plan": str(k2.wgrad_plan_for(x, dy, kh, kw, pads)),
           "dgrad_plan": str(k2.plan_for(dy, k2.rotate(wt),
                                         k2.dgrad_padding(kh, kw, pads)))}
    ok = True
    for what, run, plain in (
            ("wgrad", lambda: k2.conv2d_wgrad(x, dy, kh, kw, padding=pads),
             lambda: k2.conv2d_wgrad_plain(x, dy, kh, kw, padding=pads)),
            ("dgrad", lambda: k2.conv2d_dgrad(dy, wt, padding=pads),
             lambda: k2.conv2d_dgrad_plain(dy, wt, padding=pads))):
        got, again = run(), run()
        torch.cuda.synchronize()
        want = plain().float()
        err = float((got.float() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        bitwise = torch.equal(got, again)
        finite = bool(torch.isfinite(got).all())
        good = err <= TOL[name] and bitwise and finite
        ok &= good
        out[what] = {"max_abs_err_of_scale": err, "bitwise_twice": bitwise,
                     "within": good, "ms": time_ms(torch, run, iters),
                     "device_ms": queued_ms(torch, run),
                     "plain_ms": time_ms(torch, plain, 2, warmup=1)}
    # cuDNN's gradient of the same convolution, channels-last, TF32 off
    xc = x.permute(0, 3, 1, 2)
    wc = wt.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    dyc = dy.permute(0, 3, 1, 2)
    if (pt, pl) == (pb, pr):
        lib_w = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
            xc, tuple(wc.shape), dyc, padding=(pt, pl))
        out["wgrad"]["library_ms"] = time_ms(torch, lib_w, iters)
        out["wgrad"]["library_device_ms"] = queued_ms(torch, lib_w)
        out["dgrad"]["library_ms"] = time_ms(torch, lambda: (
            torch.nn.grad.conv2d_input(tuple(xc.shape), wc, dyc,
                                       padding=(pt, pl))), iters)
    pixels = b * ho * wo
    out["bound"] = bound(pixels, b, h, w, cin, cout, kh, kw, name,
                         x.element_size())
    return ok, out


def tile_sweep(torch, k2, gen, dev, shape, repeat):
    """The bf16 weight gradient of one shape under every tensor-core tile it
    takes: error against the plain version, bitwise twice, and device ms,
    the median of ``repeat`` readings taken in turns over the tiles."""
    b, h, w, cin, cout, kh, kw, pads = shape
    (pt, pb), (pl, pr) = pads
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    x = torch.randn((b, h, w, cin), generator=gen, device=dev).to(
        torch.bfloat16)
    dy = torch.randn((b, ho, wo, cout), generator=gen, device=dev).to(
        torch.bfloat16)
    want = k2.conv2d_wgrad_plain(x, dy, kh, kw, padding=pads).float()
    scale = float(want.abs().max())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"shape": [b, h, w, cin, cout, kh, kw], "tiles": []}
    ok = True
    runs = []
    for tile in k2.WGRAD_TILES:
        if kh * kw % tile[2]:
            continue
        p = k2.plan_wgrad(b, h, w, cin, cout, kh, kw, pads, torch.bfloat16,
                          sms, True, tile)
        run = functools.partial(k2.wgrad_launch, x, dy, kh, kw, pads, p)
        got, again = run(), run()
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max()) / scale
        good = err <= TOL["bfloat16"] and torch.equal(got, again)
        ok &= good
        runs.append(run)
        out["tiles"].append({"tile": list(tile), "split": p.split,
                             "stages": p.stages, "rel_err": err,
                             "within": good, "readings": []})
    for _ in range(repeat):
        for run, row in zip(runs, out["tiles"]):
            row["readings"].append(queued_ms(torch, run))
    for row in out["tiles"]:
        row["device_ms"] = statistics.median(row["readings"])
    chosen = k2.plan_wgrad(b, h, w, cin, cout, kh, kw, pads, torch.bfloat16,
                           sms)
    out["chosen"] = [chosen.bm, chosen.bn, chosen.taps]
    return ok, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="test,resnet50")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as k2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    k2._bwd_library()
    k2._library()
    print(json.dumps({"build_seconds": build.build_seconds,
                      "ptxas": build.build_logs.get(k2.BWD_SOURCE, "")}),
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shapes = []
    kinds = args.shapes.split(",")
    if "test" in kinds:
        shapes += [("test", s, 0) for s in TEST]
    if "resnet50" in kinds:
        for h, cin, cout, k, n in RESNET50:
            p = k // 2
            shapes.append(("resnet50", (args.batch, h, h, cin, cout, k, k,
                                        ((p, p), (p, p))), n))
    ok = True
    if args.tiles:
        for h, cin, cout, k, n in RESNET50:
            p = k // 2
            good, out = tile_sweep(torch, k2, gen, dev, (
                args.batch, h, h, cin, cout, k, k, ((p, p), (p, p))),
                args.repeat)
            out["count_per_forward"] = n
            ok &= good
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    for kind, shape, count in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            good, out = case(torch, k2, gen, dev, shape, dtype, args.iters)
            out["kind"], out["count_per_forward"] = kind, count
            ok &= good
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[:1], "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
