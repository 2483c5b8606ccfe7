"""Atomic, asynchronous checkpoints (the reference's ``checkpoint/store.py``).

Layout, as the reference's:

  <dir>/step_<N>.tmp/...   -> atomic rename -> <dir>/step_<N>/
      manifest.json        (step, leaf paths, dtypes, data state)
      arr_<i>.npy          one file per leaf; bf16 stored as uint16 with
                           its dtype named in ``"dtypes"``

A tree is a flat mapping of ``/``-joined paths to tensors, arrays or
numbers (``models.api.state_tree`` makes one of a ``TrainState``); the
manifest lists the paths in ``"paths"`` where the reference pickles a JAX
treedef (``"treedef_pkl"``).  ``restore`` returns the nested dict the paths
spell.  It also reads a checkpoint the reference wrote: it never unpickles
the treedef (that needs JAX) and takes the leaf order from
``reference_paths`` instead (``models.api.reference_state_paths``
spells it for a ``TrainState(params, OptState(step, m, v))``).

``AsyncCheckpointer.save_async`` copies every leaf to host memory before it
returns (the port updates parameters in place) and writes in a daemon
thread; a failure mid-write never corrupts the latest checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def _fsync_dir(d: str) -> None:
    """fsync a directory so the rename publishing a checkpoint survives power
    loss (the rename lives in the parent's directory entries, which plain
    file fsyncs never touch).  Best-effort on filesystems that refuse it."""
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to disk and its dtype's name (bf16 as
    its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":     # numpy can't round-trip ml_dtypes
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Mapping[str, Any],
         extra: Optional[Dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "n_leaves": len(tree), "paths": list(tree),
                "extra": extra or {}, "dtypes": []}
    for i, leaf in enumerate(tree.values()):
        arr, dtype = _to_numpy(leaf)
        manifest["dtypes"].append(dtype)
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic publish
    _fsync_dir(ckpt_dir)                        # ... durable, not just atomic
    _gc(ckpt_dir, keep=3)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        (int(d.split("_")[1]), d) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for _, d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Snapshot-then-write-in-background; at most one write in flight."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree: Mapping[str, Any],
                   extra: Optional[Dict] = None):
        host_tree = {k: _host_copy(v) for k, v in tree.items()}
        self.wait()
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_tree, extra),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _manifest(ckpt_dir: str, step: Optional[int]) -> Tuple[int, Dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        return step, json.load(f)


def is_reference_checkpoint(ckpt_dir: str, step: Optional[int] = None
                            ) -> bool:
    """Whether the checkpoint was written by the reference package (its
    manifest has a pickled treedef and no leaf paths)."""
    return "paths" not in _manifest(ckpt_dir, step)[1]


def _unflatten(flat: Mapping[str, Any]) -> Dict:
    """The nested dict that ``/``-joined paths spell."""
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        *keys, last = path.split("/")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _load(path: str, dtype: Optional[str]) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: Optional[int] = None,
            reference_paths: Optional[Sequence[str]] = None
            ) -> Tuple[int, Dict, Dict]:
    """(step, nested tree of CPU tensors, data state) of ``step`` (default:
    the latest).  A reference checkpoint needs ``reference_paths``, its
    leaves' paths in the reference's flattening order."""
    step, manifest = _manifest(ckpt_dir, step)
    paths: List[str] = manifest.get("paths")
    if paths is None:
        if reference_paths is None:
            raise ValueError(
                f"step {step} in {ckpt_dir} was written by the reference "
                "package (a pickled JAX treedef); pass reference_paths, its "
                "leaves' paths in order")
        paths = list(reference_paths)
        if len(paths) != manifest["n_leaves"]:
            raise ValueError(f"the reference checkpoint has "
                             f"{manifest['n_leaves']} leaves; "
                             f"reference_paths names {len(paths)}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    dtypes = manifest.get("dtypes", [])
    flat = {p: _load(os.path.join(d, f"arr_{i}.npy"),
                     dtypes[i] if i < len(dtypes) else None)
            for i, p in enumerate(paths)}
    return step, _unflatten(flat), manifest.get("extra", {})
