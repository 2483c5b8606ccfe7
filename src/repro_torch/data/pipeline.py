"""Deterministic synthetic batches, drawn with numpy.

A copy of the reference package's ``DataConfig`` / ``_batch_rng`` /
``synth_batch``: one ``(seed, step, host)`` gives the same batch, bit for
bit, in both packages, so the port and the reference see the same images
and tokens.  ``DataIterator`` is the reference's background-prefetching
iterator with a checkpointable cursor: restarted at ``start_step`` it yields
the batches an uninterrupted run would have from there.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.3
    prefetch: int = 2
    host_index: int = 0
    host_count: int = 1


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # independent stream per (seed, step, host): restart-safe, host-disjoint
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_index]))


def synth_batch(arch: ArchConfig, shape: ShapeConfig, cfg: DataConfig,
                step: int) -> Dict[str, np.ndarray]:
    rng = _batch_rng(cfg, step)
    local_batch = shape.global_batch // cfg.host_count
    if arch.family == "cnn":
        r = arch.image_size
        return {"images": rng.normal(size=(local_batch, r, r, 3)).astype(np.float32),
                "labels": rng.integers(0, arch.vocab_size, local_batch).astype(np.int32)}
    text = shape.seq_len - (arch.num_patches if arch.family == "vlm" else 0)
    toks = rng.zipf(cfg.zipf_a, size=(local_batch, text + 1)) % arch.vocab_size
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if arch.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            size=(local_batch, arch.num_patches, arch.d_model)).astype(np.float32) * 0.02
    if arch.family == "audio":
        batch["frames"] = rng.normal(
            size=(local_batch, arch.num_frames, arch.d_model)).astype(np.float32) * 0.02
    return batch


class DataIterator:
    """Background-prefetching iterator with an explicit, checkpointable
    cursor: a daemon thread fills a queue of ``cfg.prefetch`` batches."""

    def __init__(self, arch: ArchConfig, shape: ShapeConfig,
                 cfg: Optional[DataConfig] = None, start_step: int = 0):
        self.arch, self.shape = arch, shape
        self.cfg = cfg or DataConfig()
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        s = self.step
        while not self._stop.is_set():
            batch = synth_batch(self.arch, self.shape, self.cfg, s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s, batch = self._q.get()
        self.step = s + 1
        return batch

    def state(self) -> Dict:
        return {"seed": self.cfg.seed, "step": self.step}

    def close(self):
        self._stop.set()
