"""Deterministic synthetic batches, drawn with numpy.

A copy of the reference package's ``DataConfig`` / ``_batch_rng`` /
``synth_batch``: one ``(seed, step, host)`` gives the same batch, bit for
bit, in both packages, so the port and the reference see the same images
and tokens.  The background-prefetching iterator is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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
