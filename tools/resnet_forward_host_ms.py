#!/usr/bin/env python3
"""Host time of one ResNet-50 forward of the PyTorch port, from a checkout.

    python3 tools/resnet_forward_host_ms.py [--root DIR] [--batch 1]
        [--dtype bfloat16] [--iters 20] [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Builds the full-width
ResNet-50 from seeded random weights on the first CUDA card and prints one JSON object: ``enqueue_ms`` (host clock until the forward
returns, each call starting on an idle device), ``ms_per_batch`` (host
clock around forward + synchronize), both means over ``--iters`` calls
after a warm-up, with the card's name.  Needs a CUDA card; exits 2
without one.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("resnet50"), dtype=args.dtype)
    model = build_model(cfg).init(torch.Generator().manual_seed(args.seed),
                                  device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn((args.batch, cfg.image_size, cfg.image_size, 3),
                    generator=g, device="cuda")
    with torch.no_grad():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        enq = host = 0.0
        for _ in range(args.iters):
            t0 = time.perf_counter()
            model(x)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enq += t1 - t0
            host += t2 - t0
    print(json.dumps({"root": os.path.abspath(args.root),
                      "batch": args.batch, "dtype": args.dtype,
                      "iters": args.iters,
                      "enqueue_ms": enq * 1e3 / args.iters,
                      "ms_per_batch": host * 1e3 / args.iters,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
