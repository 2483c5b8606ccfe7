"""End-to-end trainer with fault tolerance (the reference's
``launch/train.py``).

  python -m repro_torch.launch.train --arch stablelm-1.6b --steps 200 \\
      --reduced --ckpt-dir build/ckpt [--restore]

Wires together, as the reference: config -> model -> optimizer -> data
iterator -> train step -> asynchronous checkpoints (with the data cursor)
-> straggler telemetry -> preemption handling -> ``recoverable_step``.  The
dense family trains (every layer's attention on K3 and its hand-written
backward), and so do the SSM family (``--arch mamba2_130m``: every layer's
scan on K4 and its hand-written backward) and the hybrid family (``--arch
zamba2_1_2b``: every layer's scan on K4, the shared block's attention at
each site on K3, each with its hand-written backward) and the audio family
(``--arch whisper_small``: the encoder's, the decoder's and the cross
attention on K3 and its hand-written backward, the frames from the data
iterator; the decoder gets ``--seq-len`` positions, as the reference's
``init(key, max_seq=seq_len)``) and the VLM family (``--arch
paligemma_3b``: every layer's attention, the patches' bidirectional prefix
included, on K3 and its hand-written backward; ``--seq-len`` counts the
patches, the data iterator gives ``seq_len - num_patches`` text tokens and
the patch embeddings) and the MoE family (``--arch deepseek_v2_236b`` /
``deepseek_v3_671b``: MLA's attention on K3 at head dims (192, 128) and its
backward, the routed and shared experts, v3's MTP head, with the configs'
Adafactor and remat "full"; ``--depth`` cuts the layers, as the whole
model does not fit one card) and the CNN family (``--arch resnet50``:
every stride-1 convolution on K2 and its hand-written data- and
weight-gradient kernels, the stride-2 ones on the library convolution,
batch norm with the batch's statistics; ``--batch`` images of the
config's size with their labels from the data iterator, ``--seq-len``
unread); the command line
runs on the card, and ``train(..., device="cpu")`` runs the plain versions
on the host.  A mesh of more than one device is not ported (ROADMAP.md
Queue 1 item 12e, with ``models/dist.py`` and ``models/sharding.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.runtime.fault_tolerance import (PreemptionHandler,
                                                 StragglerDetector,
                                                 recoverable_step)


def _sync(device: torch.device) -> None:
    """Wait for the step's work on the card (the whole step: the update is
    enqueued after the loss)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(arch: str, steps: int = 100, reduced: bool = True,
          seq_len: int = 128, batch: int = 8, ckpt_dir: Optional[str] = None,
          restore: bool = False, ckpt_every: int = 50, mesh_shape=None,
          log_every: int = 10, lr: float = 3e-4, seed: int = 0,
          install_signals: bool = True, straggler_k: float = 5.0,
          device: DeviceLike = DEFAULT_DEVICE,
          depth: Optional[int] = None):
    """Trains ``arch`` (reduced unless ``reduced`` is False) for steps up to
    ``steps`` on synthetic batches; weights from ``torch.Generator`` seeded
    with ``seed`` on ``device``, data from ``seed + 1``.  With ``ckpt_dir``
    a checkpoint every ``ckpt_every`` steps, and ``restore`` resumes from the
    latest one there (the port's or the reference's).  ``depth`` cuts the
    config to that many layers (the MoE family keeps ``first_k_dense`` dense
    layers where ``depth`` leaves room for a MoE layer after them, else
    one dense layer fewer than ``depth``).  Returns (the losses of the
    steps run, the final ``TrainState``)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if depth is not None:
        cfg = cut_depth(cfg, depth)
    shape = ShapeConfig("train_cli", seq_len, batch, "train")
    model = api.build_model(cfg)
    optimizer = optim.make_optimizer(cfg.optimizer, lr=lr, total_steps=steps)
    if mesh_shape and int(np.prod(mesh_shape)) > 1:
        raise NotImplementedError(
            f"mesh {tuple(mesh_shape)}: training on more than one device "
            "is not ported yet: see ROADMAP.md Queue 1 item 12e "
            "(models/dist.py, models/sharding.py, launch/mesh.py)")

    module = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev, max_seq=seq_len)
    state = api.init_train_state(module, optimizer)

    start_step = 0
    data_cfg = DataConfig(seed=seed + 1)
    ckpt: Optional[store.AsyncCheckpointer] = None
    if ckpt_dir:
        ckpt = store.AsyncCheckpointer(ckpt_dir)
        if restore and store.latest_step(ckpt_dir) is not None:
            start_step, state, _ = api.restore_train_state(
                ckpt_dir, state, model, optimizer)
            print(f"[train] restored step {start_step}")

    step_fn = api.make_train_step(model, optimizer)
    data = DataIterator(cfg, shape, data_cfg, start_step=start_step)
    straggler = StragglerDetector(k=straggler_k)
    preempt = PreemptionHandler(install=install_signals)

    losses = []
    try:
        for step in range(start_step, steps):
            batch_np = next(data)
            t0 = time.perf_counter()
            state, metrics = recoverable_step(step_fn, state, batch_np)
            _sync(dev)
            dt = time.perf_counter() - t0
            if straggler.observe(dt):
                print(f"[train] step {step}: STRAGGLER ({dt:.3f}s vs "
                      f"median {straggler.summary()['median_s']:.3f}s)")
            losses.append(float(metrics["loss"]))
            if step % log_every == 0:
                print(f"[train] step {step} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save_async(step + 1, api.state_tree(state),
                                extra=data.state())
            if preempt.requested:
                print("[train] preemption requested: checkpointing and "
                      "exiting")
                if ckpt:
                    ckpt.save_async(step + 1, api.state_tree(state),
                                    extra=data.state())
                break
    finally:
        data.close()
        if ckpt:
            ckpt.wait()
    return losses, state


def cut_depth(cfg, depth: int):
    """``cfg`` with ``depth`` layers; with experts at least one MoE layer
    (``first_k_dense`` at most ``depth - 1``)."""
    kw = {"num_layers": depth}
    if cfg.num_experts:
        kw["first_k_dense"] = min(cfg.first_k_dense, depth - 1)
    return dataclasses.replace(cfg, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", help="e.g. 2x4")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--depth", type=int, help="cut the config to this many "
                    "layers")
    args = ap.parse_args()
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh \
        else None
    losses, _ = train(args.arch, steps=args.steps, reduced=args.reduced,
                      seq_len=args.seq_len, batch=args.batch,
                      ckpt_dir=args.ckpt_dir, restore=args.restore,
                      ckpt_every=args.ckpt_every, mesh_shape=mesh_shape,
                      lr=args.lr,
                      **({} if args.depth is None else {"depth": args.depth}))
    print(f"[train] done: first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()
