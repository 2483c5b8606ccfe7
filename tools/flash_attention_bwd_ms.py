#!/usr/bin/env python3
"""Time of the PyTorch port's attention backward (K3's backward) alone, from
a checkout.

    python3 tools/flash_attention_bwd_ms.py [--root DIR] [--iters 20]
        [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Calls
``repro_torch.kernels.flash_attention.flash_attention_bwd`` on the shapes
of ``chip_smoke.py``'s training (d) -- stablelm-1.6b B=1 S=4096 (32 heads
of 64) and qwen3-14b B=1 S=2048 (40 heads, 8 kv, of 128), causal; a
ragged B=2 S=1000 (4 heads of 64, causal) and a non-causal B=1 S=512 (8
heads, 2 kv, of 128); each in bf16 and float32 -- on seeded random inputs and
the forward kernel's own output and log-sum-exp, on the first CUDA card.
Prints one JSON object: per shape the milliseconds of one call (CUDA
events around ``--iters`` back-to-back calls after a warm-up, inputs
L2-warm where they fit), of the dQ and the dK / dV kernel alone where the
checkout can launch them apart (``bwd_launch``), and of SDPA's backward on
the same inputs (``torch.autograd.grad`` through
``F.scaled_dot_product_attention``, timed only), with the card's name.
Needs a CUDA card; exits 2 without one.
"""

import argparse
import json
import os
import sys

# (name, dtype, B, S, H, KV, d, causal)
SHAPES = (("stablelm_b1_s4096", "bfloat16", 1, 4096, 32, 32, 64, True),
          ("qwen3_b1_s2048", "bfloat16", 1, 2048, 40, 8, 128, True),
          ("ragged_b2_s1000", "bfloat16", 2, 1000, 4, 4, 64, True),
          ("noncausal_b1_s512_gqa", "bfloat16", 1, 512, 8, 2, 128, False),
          ("stablelm_b1_s4096_f32", "float32", 1, 4096, 32, 32, 64, True),
          ("qwen3_b1_s2048_f32", "float32", 1, 2048, 40, 8, 128, True),
          ("ragged_b2_s1000_f32", "float32", 2, 1000, 4, 4, 64, True),
          ("noncausal_b1_s512_gqa_f32", "float32", 1, 512, 8, 2, 128,
           False))


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import flash_attention as k3

    def time_ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "ms": {}}
    for name, dtype, b, s, h, kv, d, causal in SHAPES:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn((b, s, n, d), generator=g, device="cuda")
                       .to(dt) for n in (h, kv, kv, h))
        o, lse = k3.flash_attention_fwd(q, k, v, causal=causal)
        row = {"call": time_ms(lambda: k3.flash_attention_bwd(
            do, q, k, v, o, lse, causal=causal))}
        if hasattr(k3, "bwd_launch"):
            scale = d ** -0.5
            scratch = k3.bwd_launch(do, q, k, v, o, lse, causal, scale,
                                    k3.BWD_BOTH)[3]
            row["dq"] = time_ms(lambda: k3.bwd_launch(
                do, q, k, v, o, lse, causal, scale, k3.BWD_DQ))
            row["dkdv"] = time_ms(lambda: k3.bwd_launch(
                do, q, k, v, o, lse, causal, scale, k3.BWD_DKDV, scratch))
        qs, ks, vs = (t.transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        lib_o = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=True)
        do_t = do.transpose(1, 2)
        row["sdpa"] = time_ms(lambda: torch.autograd.grad(
            lib_o, (qs, ks, vs), do_t, retain_graph=True))
        out["ms"][name] = row
        del q, k, v, do, o, lse, qs, ks, vs, lib_o
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
