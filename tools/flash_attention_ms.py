#!/usr/bin/env python3
"""Time of the PyTorch port's attention kernel (K3) alone, from a checkout.

    python3 tools/flash_attention_ms.py [--root DIR] [--iters 50]
        [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Calls
``repro_torch.kernels.flash_attention.flash_attention`` (causal) on the
model shapes of ``chip_smoke.py`` -- stablelm-1.6b B=1 S=4096 and B=8
S=1024 (32 heads of 64), qwen3-14b B=1 S=2048 (40 heads, 8 kv, of 128) in
bf16, stablelm B=1 S=4096 in float32 -- on seeded random inputs on the
first CUDA card, and prints one JSON object: per shape the milliseconds
of one call (CUDA events around ``--iters`` back-to-back calls after a
warm-up, inputs L2-warm where they fit), with the card's name.  Needs a
CUDA card; exits 2 without one.
"""

import argparse
import json
import os
import sys

# (name, dtype, B, S, H, KV, d)
SHAPES = (("stablelm_b1_s4096", "bfloat16", 1, 4096, 32, 32, 64),
          ("stablelm_b8_s1024", "bfloat16", 8, 1024, 32, 32, 64),
          ("qwen3_b1_s2048", "bfloat16", 1, 2048, 40, 8, 128),
          ("stablelm_b1_s4096_f32", "float32", 1, 4096, 32, 32, 64))


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
    from repro_torch.kernels import flash_attention as k3

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "ms": {}}
    for name, dtype, b, s, h, kv, d in SHAPES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda")
                   .to(dt) for n in (h, kv, kv))
        for _ in range(5):
            k3.flash_attention(q, k, v, causal=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            k3.flash_attention(q, k, v, causal=True)
        end.record()
        torch.cuda.synchronize()
        out["ms"][name] = start.elapsed_time(end) / args.iters
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
