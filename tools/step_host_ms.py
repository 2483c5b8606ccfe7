#!/usr/bin/env python3
"""Host ms of the dense transformer's prefill and train step, from a checkout.

    python3 tools/step_host_ms.py [--root DIR] [--seq 4096] [--iters 10]
        [--train-iters 4] [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Builds stablelm-1.6b at
full width and depth in bfloat16 from seeded random weights on the first
CUDA card, then times, on the host clock around the call and a
synchronize: ``Model.prefill`` at B=1, S=``--seq`` (the shape of
``chip_smoke.py``'s transformer (a)), and one ``make_train_step`` step with
the config's optimizer at the same shape (training (a)).  Prints one JSON
object: each median and every reading, K3's launches per prefill and per
step, and the card's name and power limit.  Needs a CUDA card; exits 2
without one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def timed(fn, iters: int, warmup: int) -> list:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--train-iters", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config("stablelm-1.6b"), dtype="bfloat16")
    model = api.build_model(cfg)
    module = model.init(torch.Generator(device="cuda").manual_seed(args.seed),
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.seq), generator=g,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}

    def prefill():
        with torch.no_grad():
            model.prefill(module, batch)

    k3.reset_launch_counts()
    prefill()
    prefill_launches = sum(k3.launch_counts().values())
    prefill_ms = timed(prefill, args.iters, warmup=2)

    optimizer = optim.make_optimizer(cfg.optimizer)
    state = [api.init_train_state(module, optimizer)]
    step = api.make_train_step(model, optimizer)
    train_batch = {"tokens": tokens, "labels": tokens}

    def train():
        state[0] = step(state[0], train_batch)[0]

    k3.reset_launch_counts()
    train()
    train_launches = sum(k3.launch_counts().values())
    train_ms = timed(train, args.train_iters, warmup=1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({
        "root": os.path.abspath(args.root), "arch": cfg.name,
        "dtype": cfg.dtype, "B": 1, "S": args.seq,
        "prefill_ms": statistics.median(prefill_ms),
        "prefill_ms_all": prefill_ms,
        "train_step_ms": statistics.median(train_ms),
        "train_step_ms_all": train_ms,
        "k3_launches_prefill": prefill_launches,
        "k3_launches_train_step": train_launches,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi.stdout.strip().splitlines()[:1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
