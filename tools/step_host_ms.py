#!/usr/bin/env python3
"""Host ms of the dense transformer's prefill and train step and of the
mamba2 train step, from a checkout.

    python3 tools/step_host_ms.py [--root DIR] [--seq 4096] [--iters 10]
        [--train-iters 4] [--mamba-batch 8] [--seed 0]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Builds stablelm-1.6b at
full width and depth in bfloat16 from seeded random weights on the first
CUDA card, then times, on the host clock around the call and a
synchronize: ``Model.prefill`` at B=1, S=``--seq`` (the shape of
``chip_smoke.py``'s transformer (a)), and one ``make_train_step`` step with
the config's optimizer at the same shape (training (a)).  Then the same for
mamba2-130m's train step at B=``--mamba-batch``, S=``--seq`` (training
(e): bfloat16, AdamW, remat "dots"), and one more step under
``torch.profiler``: the device ms of all its kernels, of K4's backward
(kernels named ``ssd_bwd_``) and of K4's forward, and the idle share 1 -
device ms / the median host ms.  Prints one JSON object: each median and
every reading, the launches per prefill and per step, and the card's name
and power limit.  Needs a CUDA card; exits 2 without one.
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


def mamba_step(args, torch) -> dict:
    """mamba2-130m's train step at training (e)'s shape: host ms of
    ``--train-iters`` steps after a warm-up one, then the device ms of one
    profiled step by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models import api

    cfg = get_config("mamba2-130m")
    model = api.build_model(cfg)
    module = model.init(torch.Generator(device="cuda").manual_seed(args.seed),
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.mamba_batch, args.seq),
                           generator=g, device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    optimizer = optim.make_optimizer(cfg.optimizer)
    state = [api.init_train_state(module, optimizer)]
    step = api.make_train_step(model, optimizer)

    def train():
        state[0] = step(state[0], batch)[0]

    k4.reset_launch_counts()
    train()
    launches = {k: v for k, v in k4.launch_counts().items() if v}
    ms = timed(train, args.train_iters, warmup=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train()
        torch.cuda.synchronize()
    by = {"k4_backward": 0.0, "k4_forward": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
        kind = ("k4_backward" if "ssd_bwd_" in ev.key else
                "k4_forward" if "ssd_" in ev.key else "other")
        by[kind] += us / 1e3
    device_ms = sum(by.values())
    host = statistics.median(ms)
    return {"arch": cfg.name, "dtype": cfg.dtype, "remat": cfg.remat,
            "optimizer": cfg.optimizer, "B": args.mamba_batch, "S": args.seq,
            "train_step_ms": host, "train_step_ms_all": ms,
            "device_ms": device_ms, "device_ms_by_kind": by,
            "idle_share": 1.0 - device_ms / host,
            "k4_launches_train_step": launches}


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--train-iters", type=int, default=4)
    ap.add_argument("--mamba-batch", type=int, default=8)
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
    del state, step, module, model
    torch.cuda.empty_cache()
    mamba = mamba_step(args, torch)
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
        "mamba2": mamba,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi.stdout.strip().splitlines()[:1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
