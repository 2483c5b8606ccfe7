"""Build and load the CUDA kernels: ``nvcc`` into a shared library, ``ctypes``.

One ``nvcc`` per source, from the ``.cu`` files shipped in ``csrc/`` and
the headers they include from there, and nothing else, at first use, into
``build/repro_torch/`` at the root of the checkout (a git-ignored
directory).  The library has a plain C interface — no
PyTorch headers — so a build takes seconds.  The file name carries a hash of
the source, its local headers and the flags, so an edited kernel or header
is never served from a stale library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source on top of NVCC_FLAGS.  -fmad=false for dse_sweep.cu:
# its kernels are held bitwise to eager tensor code, which never contracts
# a*b+c (see the note at the top of that file); conv2d.cu,
# flash_attention.cu and flash_attention_bwd.cu are held to a tolerance and
# keep FMA contraction, and none takes --use_fast_math (the attention
# kernels' exp2f / expf / log2f stay the accurate ones).  All three include
# csrc/hopper.cuh.
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {"dse_sweep.cu": ("-fmad=false",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build of each source printed (ptxas register / spill report)
# and how long it took; empty when the library was already on disk
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def default_build_dir() -> Path:
    """``build/repro_torch`` at the checkout root (``src/``'s parent)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    candidates: List[Optional[str]] = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("no nvcc found (looked at $CUDA_HOME/bin, the PATH "
                       "and /usr/local/cuda/bin); the CUDA kernels cannot "
                       "be built on this machine")


def flags(source: str) -> Tuple[str, ...]:
    """The ``nvcc`` flags ``csrc/<source>`` is built with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_headers(source: str) -> List[str]:
    """The ``csrc/`` headers ``csrc/<source>`` includes with ``#include
    "..."``, directly or through another such header, in first-seen order."""
    seen: List[str] = []
    todo = [source]
    while todo:
        text = (CSRC_DIR / todo.pop(0)).read_text()
        for name in _INCLUDE.findall(text):
            if name not in seen:
                seen.append(name)
                todo.append(name)
    return seen


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` lives (content-addressed: the
    source, every local header it includes and the flags)."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for name in local_headers(source):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(flags(source)).encode())
    return default_build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(source: str, force: bool = False) -> Path:
    """Compile ``csrc/<source>`` if its library is not on disk yet; returns
    the library path.  Raises with the compiler's output on failure."""
    out = library_path(source)
    if out.exists() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *flags(source), "-o", str(tmp),
           str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[source] = time.perf_counter() - t0
    build_logs[source] = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (exit "
                           f"{proc.returncode}):\n{build_logs[source]}")
    os.replace(tmp, out)        # atomic: a concurrent build sees all or none
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _libs.get(source)
    if lib is None:
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(build(source)))
                _libs[source] = lib
    return lib
