"""The census of the port's own step (HxA's part (b), ``analyze_step``).

The port's step runs eagerly, op by op, so its census is read as it runs:
``analyze_step`` runs the step under a ``TorchDispatchMode`` that sees every
aten op below autograd (the backward's too) and books it by HxA's
conventions, made concrete for aten ops:
  * matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` ...):
    ``torch.utils.flop_counter``'s own formulas (2 M N K), so the two
    counts agree exactly;
  * elementwise ops, transcendentals and casts: 1 flop / output element;
  * reductions: 1 flop / input element;
  * HBM bytes: operand + result bytes of every op that materialises a
    result; views and metadata ops (the schema marks the output an alias
    of an input) and bare allocations are free, as HxA's non-materialising
    opcodes are.  A broadcast operand (stride 0) counts the bytes it spans.
The hand-written kernels are ctypes calls no dispatch mode sees: each
wrapper opens ``kernel_call(work)`` around its work, which books the
kernel's own entry and hides the ops inside (allocations, the plain version
on the CPU), so the census of a step is the same on the card, on the meta
device and on the CPU.  Without an active census it costs the wrapper one
object and a list test: ``work`` is not called.  The mode keeps sizes only,
never a reference to a tensor.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils import _pytree as _pytree
from torch.utils import flop_counter as _flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

# 1 flop per input element
_REDUCE_OPS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "var",
    "std", "var_mean", "std_mean", "norm", "linalg_vector_norm", "cumsum",
    "cumprod", "argmax", "argmin", "any", "all", "count_nonzero", "nansum"))
# no arithmetic; the result is written, nothing is read
_FILL_OPS = frozenset((
    "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "fill", "fill_", "zero_", "arange",
    "scalar_tensor", "normal_", "uniform_", "randn", "rand", "randint",
    "eye"))
# no arithmetic; operands are read and the result written (a same-dtype
# ``_to_copy`` / ``copy_`` too: a change of dtype is a cast)
_MOVE_OPS = frozenset((
    "copy_", "clone", "_to_copy", "cat", "stack", "index", "index_select",
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "index_put", "index_put_", "index_add", "index_add_", "index_copy",
    "index_copy_", "embedding", "embedding_dense_backward",
    "constant_pad_nd", "slice_scatter", "select_scatter",
    "as_strided_scatter", "repeat", "repeat_interleave", "_unsafe_index",
    "flip", "roll", "masked_scatter", "lift_fresh_copy", "_reshape_copy",
    "expand_copy", "permute_copy", "t_copy", "view_copy",
    "split_with_sizes_copy"))
# free: allocations and views the schema does not annotate
_FREE_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "resize_", "set_", "detach_", "lift_fresh"))

_KINDS: Dict[object, str] = {}


def _op_kind(func) -> str:
    """How an aten op is booked: ``"free"``, ``"fill"``, ``"move"``,
    ``"reduce"``, ``"matmul"`` or ``"elementwise"`` (memoised per overload)."""
    kind = _KINDS.get(func)
    if kind is None:
        name = func.overloadpacket.__name__
        rets = func._schema.returns
        tensors = [r for r in rets if "Tensor" in str(r.type)]
        if not tensors or name in _FREE_OPS or all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in tensors):
            kind = "free"
        elif func.overloadpacket in _flop_counter.flop_registry:
            kind = "matmul"
        elif name in _REDUCE_OPS:
            kind = "reduce"
        elif name in _FILL_OPS:
            kind = "fill"
        elif name in _MOVE_OPS:
            kind = "move"
        else:
            kind = "elementwise"
        _KINDS[func] = kind
    return kind


def _spanned(t: torch.Tensor) -> Tuple[int, int]:
    """(elements, bytes) a tensor spans: the extents of its dimensions whose
    stride is not 0 (a broadcast reads its source once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n, n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


class _StepCensus(TorchDispatchMode):
    """The dispatch mode of ``analyze_step``: integer totals by op name."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.hbm_bytes = 0
        self.op_counts: Dict[str, int] = {}
        self.hbm_by_opcode: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.hidden = 0          # > 0 inside a kernel_call

    def _book(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        self.op_counts[name] = self.op_counts.get(name, 0) + 1
        self.hbm_by_opcode[name] = self.hbm_by_opcode.get(name, 0) + nbytes

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        flops, nbytes = int(flops), int(nbytes)
        self._book(name, flops, nbytes)
        entry = self.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        entry["launches"] += 1
        entry["flops"] += flops
        entry["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        kind = _op_kind(func)
        if kind == "free":
            return
        name = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        written = sum(_spanned(t)[1] for t in outs)
        if kind == "fill":
            self._book(name, 0, written)
            return
        if kind == "move" and name.endswith("_"):
            ins = ins[1:]        # an in-place copy does not read its target
        read = sum(_spanned(t)[1] for t in ins)
        flops = 0
        if kind == "matmul":
            flops = int(_flop_counter.flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            self.matmul_flops += flops
        elif kind == "reduce":
            flops = _spanned(ins[0])[0] if ins else 0
        elif kind == "elementwise" or (
                kind == "move" and name in ("_to_copy", "copy_") and ins
                and outs and ins[0].dtype != outs[0].dtype):
            flops = sum(t.numel() for t in outs)       # a cast: 1 / element
        self._book(name, flops, read + written)

    def result(self, entry: str) -> dict:
        def ordered(d):
            return {k: float(v) for k, v in sorted(d.items(),
                                                   key=lambda kv: (-kv[1],
                                                                   kv[0]))}
        return {
            "entry": entry,
            "flops": float(self.flops),
            "hbm_bytes": float(self.hbm_bytes),
            "collective_bytes": 0.0,
            "wire_bytes": 0.0,
            "op_counts": ordered(self.op_counts),
            "hbm_by_opcode": ordered(self.hbm_by_opcode),
            "collectives": {},
            "loops": [],
            "n_computations": len(self.op_counts),
            "matmul_flops": float(self.matmul_flops),
            "kernels": {k: {kk: float(vv) for kk, vv in v.items()}
                        for k, v in sorted(self.kernels.items())},
        }


# the censuses running now, innermost last (one at a time in practice)
_ACTIVE: List[_StepCensus] = []


class kernel_call:
    """``with kernel_call(work): <the kernel's work>`` in a hand-written
    kernel's wrapper, ``work()`` giving ``(name, flops, nbytes)``: ``name`` as
    in the kernel's ``launch_counts()``, the work the function defines and
    the bytes of its inputs and outputs, each read or written once.  Under an
    active ``analyze_step`` it books that entry and hides the aten ops
    inside (the wrapper's allocations, copies, and on the CPU the plain
    version).  Without an active census ``work`` is never called."""

    __slots__ = ("work", "census")

    def __init__(self, work):
        self.work = work
        self.census = None

    def __enter__(self):
        if _ACTIVE:
            census = self.census = _ACTIVE[-1]
            if not census.hidden:
                census.add_kernel(*self.work())
            census.hidden += 1
        return self

    def __exit__(self, *exc):
        if self.census is not None:
            self.census.hidden -= 1
        return False


def analyze_step(fn, *args, **kwargs) -> dict:
    """The census of one call ``fn(*args, **kwargs)``, counted as it runs
    (any device: the card, the CPU, or the meta device, where nothing is
    computed or allocated), with the keys of ``analyze_hlo_text``:
    ``flops``, ``hbm_bytes``, ``collective_bytes`` and ``wire_bytes`` (0 at
    one device), ``op_counts`` and ``hbm_by_opcode`` by aten op name and
    kernel name (all of them, most frequent first), ``collectives`` ({}),
    ``loops`` ([]: layers are a Python loop, every trip is counted as it
    runs), ``n_computations`` (distinct op and kernel names), ``entry``
    (``fn``'s name); plus ``matmul_flops`` (the aten matmuls alone,
    ``FlopCounterMode``'s count) and ``kernels`` (per hand-written kernel:
    ``launches``, ``flops``, ``bytes``).  Conventions: the comment above.
    ``fn``'s result is dropped."""
    census = _StepCensus()
    _ACTIVE.append(census)
    try:
        with census:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(census)
    return census.result(getattr(fn, "__qualname__", repr(fn)))
