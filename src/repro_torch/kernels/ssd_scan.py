"""The SSD chunk-scan kernel (K4) and its backward: launch plans,
wrappers, plain versions, launch counts, the autograd ``Function``.

Hand-written CUDA kernels (``csrc/ssd_scan.cu``) compute the Mamba2 SSD
scan of the reference's ``ops.ssd_scan`` for ``ngroups == 1``: ``x`` [b, S,
nh, hp], ``dt`` [b, S, nh] (float32), ``A`` [nh] (float32), ``B``, ``C`` [b,
S, 1, ds] -> ``y`` [b, S, nh, hp] and the final state [b, nh, hp, ds]
(float32); they replace the reference's TPU kernel ``_ssd_kernel``.  The
sequence is cut into chunks of ``Q = min(chunk, S)`` steps (``S % Q == 0``,
as the reference asserts).  ``x``, ``B`` and ``C`` are float32 or bfloat16
(one type for the three), read in place through their strides (``B`` and
``C`` may be column slices of one tensor, as in the model); ``y`` is
written in ``out_dtype`` (default ``x.dtype``, as the reference kernel
returns).  Unlike the reference kernel it also returns the final state,
which the model's prefill keeps for decoding.

Two variants, chosen by shape before any launch (``plan``); one call runs
three or four ``__global__`` functions and counts as one launch:

* ``shared_cb`` -- ``hp == 64``, ``ds % 64 == 0``, ``ds <= 256``, ``Q % 64
  == 0``, ``Q <= 256`` (every mamba2-130m shape): C B^T once per (b, chunk)
  for all heads into a scratch, on bf16 tensor cores for bf16 inputs; the
  chunk states; the pass over chunks; the outputs, 64 rows a block, as one
  product over ``ds + `` the row tile's end.  The float32-operand products
  run on the tensor cores at float32 accuracy as 3xTF32 (each float32
  operand split into two TF32 parts, never rounded once).  Operands whose
  base or strides lie off 16 bytes are copied first.
* ``general`` -- every other shape: chunk states, pass, outputs, C B^T
  rebuilt per head, all on the CUDA cores in float32.

Beside them stands ``ssd_scan_plain``: the reference kernel's arithmetic in
float32 tensor code, a loop over chunks vectorised over (b, h).  The
wrapper takes it ONLY for tensors that lie on the CPU; for CUDA tensors it
launches a kernel variant or raises -- there is no fallback.  ``LAUNCHES``
counts launches per input dtype (``"ssd_scan_f32"``, ``"ssd_scan_bf16"``),
incremented exactly where the kernel is launched.  The library is built and
loaded inside the first launching call, never at import time.  Tensors on
the meta device (the workload census, ``core.census.analyze_step``) take a
shape-only route: the plan, empty meta outputs, nothing launched or
counted.  Under an active census each call books its entry
(``census_work``) through ``census.kernel_call``.

Both versions accumulate ``cumsum(dt * A)`` in float64 and round it to
float32 once per element, so that they take the decay exponents from the
same float values (torch's CPU cumsum of float32 already accumulates in
float64; its CUDA cumsum scans in float32 in another order).

The backward (``ssd_scan_bwd``; ``csrc/ssd_scan_bwd.cu``) is the VJP of the
scan, written from the chunked algebra: the reference has no backward
kernel and trains through ``jax.vjp`` of ``ssd_chunked``.  Given dy (and
the final state's cotangent, or none) and the forward's inputs and scratch
(the state entering every chunk, ``cum``), it returns dx, ddt, dA, dB, dC,
each in its input's dtype.  Two variants, chosen by shape (``plan_bwd``),
seven launches each (``BWD_LAUNCH_NAMES``), counted as one call under
``"ssd_scan_bwd_f32"`` / ``"ssd_scan_bwd_bf16"``:

* ``tc`` -- the sizes ``shared_cb`` takes (every mamba2-130m and
  zamba2-1.2b shape): every product on the tensor cores at float32
  accuracy (3xTF32; 2xTF32 where one operand holds bf16 values; C B^T of
  bf16 inputs on the bf16 tensor cores), dy read by three launches; at
  small batch the launch that sums dB and dC over heads splits the heads
  into groups whose float32 partials a later launch adds in group order.
* ``general`` -- every other shape: 64 x 64 tiles masked at the edges, in
  float32 on the CUDA cores.

Neither takes a float atomic: the sums over heads (dB, dC) and over (b,
S) (dA) run in a fixed order, so two runs are bitwise equal.
``ssd_scan_bwd_plain`` holds the same formulas as float32 tensor code,
chunk by chunk.  ``SSDScan`` is the autograd node: K4 with its scratch
saved, then K4's backward; ``kernels.ops.ssd_scan`` routes through it
wherever autograd records.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import census

SOURCE = "ssd_scan.cu"
BWD_SOURCE = "ssd_scan_bwd.cu"

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

GENERAL = "general"
SHARED_CB = "shared_cb"
# the variant ids of the C interface
_VARIANT_ID = {GENERAL: 0, SHARED_CB: 1}
# the launches of each variant, in order
LAUNCH_NAMES = {GENERAL: ("chunk_state", "state_pass", "output"),
                SHARED_CB: ("cb", "chunk_state", "state_pass", "output")}

# SMs of an H100 SXM: the plan's default card
H100_SMS = 132
_TILE = 64          # rows / columns of a block tile in both variants
_PASS_THREADS = 256

# the backward's variants, their ids in the C interface and their launches
# in issue order; the scratch tensors of either, in the C interface's order
BWD_TC = "tc"
_BWD_VARIANT_ID = {GENERAL: 0, BWD_TC: 1}
BWD_LAUNCH_NAMES = {
    GENERAL: ("dcb", "state_grad", "state_pass", "dx", "dbc", "dcum", "da"),
    BWD_TC: ("dcb", "state_grad", "state_pass", "dxbc", "dcum", "bc_sum",
             "da")}
BWD_SCRATCH = ("cb", "dcb", "dstate", "rowpart", "colpart", "dcum_loc",
               "ddt_x", "rsum", "dA_part", "yoff", "bcpart")
BWD_MAX_Q = 8192    # the dcum kernel holds one chunk's dcum in shared memory
_BWD_TC_THREADS = 128
_BWD_TC_BLOCKS_PER_SM = 2   # the dxbc pass fills the card to this
_BWD_TC_SLICE = 32          # K slice of a tc product
# the tc kernels' ring: 3 stages of two operand slices of 64 x (32 + 4)
# floats
_BWD_TC_RING = 3 * 2 * _TILE * (_BWD_TC_SLICE + 4) * 4

FWD_KEYS = tuple(f"ssd_scan_{s}" for s in _SUFFIX.values())
BWD_KEYS = tuple(f"ssd_scan_bwd_{s}" for s in _SUFFIX.values())
# calls per kind and input dtype since the last ``reset_launch_counts``
LAUNCHES: Dict[str, int] = {k: 0 for k in FWD_KEYS + BWD_KEYS}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one K4 call runs: the variant, the grid (x, y, z) of each of its
    launches in order (``LAUNCH_NAMES``), the scratch tensors the wrapper
    allocates (name -> shape, all float32), and the blocks of each launch
    per SM of the card it was planned for.  Plans are cached: read them,
    do not change them."""
    variant: str
    grids: Dict[str, Tuple[int, int, int]]
    scratch: Dict[str, Tuple[int, ...]]
    blocks_per_sm: Dict[str, float]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def census_work(b: int, s: int, nh: int, hp: int, ds: int, q: int,
                in_dtype: torch.dtype, out_dtype: torch.dtype
                ) -> Tuple[int, int]:
    """(flops, bytes) of one call, as the census books it: the dots of the
    SSD chunked algorithm -- per (b, chunk) C B^T, 2 Q^2 ds (shared by the
    heads, ``ngroups == 1``), and per head the masked (C B^T * L) (x dt),
    2 Q^2 hp, the prior state's output C state^T, 2 Q ds hp, and the chunk
    state (x dt decay)^T B, 2 Q hp ds; x, dt, A, B, C read and y and the
    final state written once -- never the decay blocks or the scratch."""
    nc = s // q
    flops = b * nc * (2 * q * q * ds
                      + nh * (2 * q * q * hp + 4 * q * ds * hp))
    nbytes = (in_dtype.itemsize * b * s * (nh * hp + 2 * ds)
              + 4 * (b * s * nh + nh) + out_dtype.itemsize * b * s * nh * hp
              + 4 * b * nh * hp * ds)
    return flops, nbytes


def _shared_cb_fits(hp: int, ds: int, q: int) -> bool:
    """Whether the ``shared_cb`` variant takes these head, state and chunk
    sizes."""
    return hp == _TILE and ds % _TILE == 0 and ds <= 256 \
        and q % _TILE == 0 and q <= 256


@functools.lru_cache(maxsize=4096)
def plan(b: int, s: int, nh: int, hp: int, ds: int, q: int,
         dtype: torch.dtype, sms: int = H100_SMS) -> Plan:
    """The launch plan of one scan of x [b, s, nh, hp] in chunks of ``q``
    with state size ``ds`` and inputs in ``dtype`` on a card of ``sms``
    SMs.  A pure function of its arguments: builds and loads nothing."""
    if dtype not in _SUFFIX:
        raise TypeError(f"no K4 variant for {dtype}")
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    nc, bh = s // q, b * nh
    scratch = {"states": (b, nh, nc, hp, ds), "cum": (b, nh, nc, q)}
    if _shared_cb_fits(hp, ds, q):
        variant, nq = SHARED_CB, q // _TILE
        scratch["cb"] = (b, nc, q, q)
        grids = {"cb": (nq * (nq + 1) // 2, b * nc, 1),
                 "chunk_state": (nc, bh, ds // _TILE),
                 # four state elements a thread (hp ds % 4 == 0)
                 "state_pass": (_cdiv(hp * ds, 4 * _PASS_THREADS), bh, 1),
                 "output": (nc, bh, nq)}
    else:
        variant = GENERAL
        grids = {"chunk_state": (nc, bh, 1),
                 "state_pass": (_cdiv(hp * ds, _PASS_THREADS), bh, 1),
                 "output": (_cdiv(q, _TILE), nc, bh)}
    per_sm = {k: g[0] * g[1] * g[2] / sms for k, g in grids.items()}
    return Plan(variant, grids, scratch, per_sm)


_bound = None


def _library():
    """The loaded kernel library with ``argtypes`` set (pointers and the
    stream as ``c_void_p``: without them ctypes would pass 32-bit ints and
    cut the pointers)."""
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in FWD_KEYS:
            fn = getattr(lib, name)
            fn.argtypes = ([vp] * 10 + [ci] * 7
                           + [ctypes.POINTER(ctypes.c_longlong), ci, ci, vp])
            fn.restype = ci
        lib.ssd_scan_error_string.argtypes = [ci]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_launch_shape.argtypes = [ci] * 8 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.ssd_scan_launch_shape.restype = None
        _bound = lib
    return _bound


def launch_shape(b: int, s: int, nh: int, hp: int, ds: int, q: int,
                 dtype: torch.dtype) -> Dict[str, object]:
    """What the kernel library launches for ``plan``'s variant at these
    sizes (builds and loads it): per launch its grid, threads per block and
    dynamic shared memory (bytes), and the most shared memory a block may
    take."""
    variant = plan(b, s, nh, hp, ds, q, dtype).variant
    out = (ctypes.c_int * 21)()
    _library().ssd_scan_launch_shape(b, s, nh, hp, ds, q,
                                     _VARIANT_ID[variant],
                                     int(dtype == torch.bfloat16), out)
    v = list(out)
    slots = ("cb", "chunk_state", "state_pass", "output")
    launches = {name: {"grid": tuple(v[5 * i: 5 * i + 3]),
                       "threads": v[5 * i + 3], "smem": v[5 * i + 4]}
                for i, name in enumerate(slots)
                if name in LAUNCH_NAMES[variant]}
    return {"variant": variant, "launches": launches, "max_smem": v[20]}


def _validate(x, dt, A, B, C, chunk: int
              ) -> Tuple[int, int, int, int, int, int]:
    """Raises on what neither version takes; returns (b, S, nh, hp, ds, Q)."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or C.dim() != 4:
        raise ValueError(f"expected x [b, S, nh, hp], dt [b, S, nh], A [nh], "
                         f"B, C [b, S, ngroups, ds]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, nh, hp = (int(d) for d in x.shape)
    ng, ds = int(B.shape[2]), int(B.shape[3])
    if ng != 1 or int(C.shape[2]) != 1:
        raise ValueError(f"the SSD scan kernel takes ngroups == 1 (B, C "
                         f"shared by all heads); got ngroups {ng}")
    if (tuple(dt.shape) != (b, s, nh) or tuple(A.shape) != (nh,)
            or tuple(B.shape[:2]) != (b, s) or tuple(C.shape) != tuple(
                B.shape)):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if min(b, s, nh, hp, ds) < 1 or chunk < 1:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, ds {ds}, chunk "
                         f"{chunk}")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    if x.dtype not in _SUFFIX or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must all be float32 or bfloat16; got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("x, dt, A, B, C must lie on one device")
    return b, s, nh, hp, ds, q


def _out_dtype(x: torch.Tensor, out_dtype: Optional[torch.dtype]
               ) -> torch.dtype:
    out = x.dtype if out_dtype is None else out_dtype
    if out not in _SUFFIX:
        raise TypeError(f"out_dtype must be float32 or bfloat16; got {out}")
    return out


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the reference kernel's
    arithmetic in float32: for each chunk in order, ``cum = cumsum(dt A)``,
    ``L = exp(cum_i - cum_j)`` below the diagonal (0 above it, where the
    exponent is set to -inf before ``exp``), ``y = (C B^T * L) @ (x dt) +
    (C exp(cum)) @ state^T`` and ``state = state exp(cum[-1]) + ((x dt)
    exp(cum[-1] - cum))^T @ B``; all (b, h) together.  Returns ``(y`` in
    ``out_dtype`` (default ``x.dtype``), the final state [b, nh, hp, ds]
    float32``)``."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    out = _out_dtype(x, out_dtype)
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B[:, :, 0].float(), C[:, :, 0].float()
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, nh, hp, ds), dtype=torch.float32,
                        device=x.device)
    y = torch.empty((b, s, nh, hp), dtype=torch.float32, device=x.device)
    for t0 in range(0, s, q):
        xc = xf[:, t0:t0 + q].transpose(1, 2)           # [b, nh, Q, hp]
        dtc = dtf[:, t0:t0 + q].transpose(1, 2)         # [b, nh, Q]
        Bc, Cc = Bf[:, None, t0:t0 + q], Cf[:, None, t0:t0 + q]  # [b,1,Q,ds]
        cum = torch.cumsum((dtc * A[:, None]).double(), dim=-1).float()
        diff = cum[..., :, None] - cum[..., None, :]
        L = torch.exp(diff.masked_fill(~tril, float("-inf")))
        xdt = xc * dtc[..., None]
        CB = Cc @ Bc.transpose(-1, -2)                  # [b, 1, Q, Q]
        y_diag = (CB * L) @ xdt
        decay_in = torch.exp(cum)
        y_off = (Cc * decay_in[..., None]) @ state.transpose(-1, -2)
        y[:, t0:t0 + q] = (y_diag + y_off).transpose(1, 2)
        decay_end = torch.exp(cum[..., -1:] - cum)
        contrib = (xdt * decay_end[..., None]).transpose(-1, -2) @ Bc
        state = state * torch.exp(cum[..., -1])[..., None, None] + contrib
    return y.to(out), state


def kernel_ready(t: torch.Tensor) -> bool:
    """Whether the ``shared_cb`` kernels read ``t`` in place: the last
    dimension dense, the base and every other stride on whole 16 bytes (its
    vector loads).  The model's x and the column slices B, C of its conv
    output are."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:-1]))


def _kernel_operand(t: torch.Tensor, variant: str) -> torch.Tensor:
    """``t`` as the kernels of ``variant`` read it: itself where it can be
    read in place (the general variant needs only the last dimension
    dense, ``shared_cb`` ``kernel_ready``), else a copy in fresh contiguous
    memory."""
    ok = kernel_ready(t) if variant == SHARED_CB else t.stride(-1) == 1
    return t if ok else t.clone(memory_format=torch.contiguous_format)


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    n = _SMS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = n
    return n


def plan_for(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128) -> Plan:
    """``plan`` for these tensors, with the SM count of their card
    (``H100_SMS`` off the card)."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    sms = _sm_count(x.device) if x.device.type == "cuda" else H100_SMS
    return plan(b, s, nh, hp, ds, q, x.dtype, sms)


def scratch_tensors(p: "Plan | BwdPlan", device
                    ) -> Dict[str, torch.Tensor]:
    """The float32 scratch tensors of a call planned as ``p``, allocated
    with ``torch.empty`` (every element is written before it is read)."""
    return {name: torch.empty(shape, dtype=torch.float32, device=device)
            for name, shape in p.scratch.items()}


def ssd_scan_with_scratch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, *,
                          chunk: int = 128,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Dict[str, torch.Tensor]]:
    """``ssd_scan`` on CUDA tensors, also returning the call's scratch (the
    per-chunk ``cum`` among it), for checks on the card."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    out = _out_dtype(x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors; got {x.device}")
    p = plan(b, s, nh, hp, ds, q, x.dtype, _sm_count(x.device))
    x, B, C = (_kernel_operand(t, p.variant) for t in (x, B, C))
    dev = x.device
    y = torch.empty((b, s, nh, hp), dtype=out, device=dev)
    final = torch.empty((b, nh, hp, ds), dtype=torch.float32, device=dev)
    scratch = scratch_tensors(p, dev)
    cb = scratch.get("cb")
    A = A.contiguous()
    strides = (ctypes.c_longlong * 10)(
        *(int(st) for st in (*x.stride()[:3], *dt.stride(), *B.stride()[:2],
                             *C.stride()[:2])))
    lib = _library()
    name = f"ssd_scan_{_SUFFIX[x.dtype]}"
    code = getattr(lib, name)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), final.data_ptr(),
        scratch["states"].data_ptr(), scratch["cum"].data_ptr(),
        None if cb is None else cb.data_ptr(), b, s, nh, hp, ds, q,
        _VARIANT_ID[p.variant], strides, int(out == torch.bfloat16),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[name] += 1
    if code != 0:
        msg = lib.ssd_scan_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {name} ({p.variant}) failed: "
                           f"{msg} (cudaError {code}) at b {b}, S {s}, nh "
                           f"{nh}, hp {hp}, ds {ds}, Q {q}")
    return y, final, scratch


def _scan(x, dt, A, B, C, chunk: int, out_dtype: Optional[torch.dtype]
          ) -> Tuple[torch.Tensor, torch.Tensor,
                     Optional[Dict[str, torch.Tensor]]]:
    """``ssd_scan``, also returning what the backward reads of the call's
    scratch (``states``, ``cum``) on the card and on the meta device (None
    on the CPU, whose plain backward recomputes it)."""
    with census.kernel_call(lambda: (
            f"ssd_scan_{_SUFFIX[x.dtype]}",
            *census_work(*_validate(x, dt, A, B, C, chunk), x.dtype,
                         _out_dtype(x, out_dtype)))):
        if x.device.type == "cpu":
            return (*ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                    out_dtype=out_dtype), None)
        if x.device.type == "meta":       # the census's shape-only route
            p = plan_for(x, dt, A, B, C, chunk=chunk)
            b, s, nh, hp, ds, _ = _validate(x, dt, A, B, C, chunk)
            scratch = scratch_tensors(p, x.device)
            return (torch.empty((b, s, nh, hp),
                                dtype=_out_dtype(x, out_dtype),
                                device=x.device),
                    torch.empty((b, nh, hp, ds), dtype=torch.float32,
                                device=x.device),
                    {k: scratch[k] for k in ("states", "cum")})
        y, final, scratch = ssd_scan_with_scratch(x, dt, A, B, C, chunk=chunk,
                                                  out_dtype=out_dtype)
        return y, final, {k: scratch[k] for k in ("states", "cum")}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             out_dtype: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of ``x`` [b, S, nh, hp] with ``dt`` [b, S, nh], ``A``
    [nh], ``B``, ``C`` [b, S, 1, ds] in chunks of ``min(chunk, S)``; returns
    ``(y`` [b, S, nh, hp] in ``out_dtype`` (default ``x.dtype``), the final
    state [b, nh, hp, ds] float32``)``.  CUDA tensors launch the variant
    that ``plan`` picks; CPU tensors take the plain version."""
    return _scan(x, dt, A, B, C, chunk, out_dtype)[:2]


# --- the backward ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call runs: the variant, the grid (x, y, z) of each
    of its launches in order (``BWD_LAUNCH_NAMES[variant]``), the float32
    scratch tensors the wrapper allocates (name -> shape, in
    ``BWD_SCRATCH`` order), the dynamic shared memory (bytes) of the
    launches that take any, and the head groups of the ``tc`` variant's
    dB / dC pass (1 under ``general``)."""
    variant: str
    grids: Dict[str, Tuple[int, int, int]]
    scratch: Dict[str, Tuple[int, ...]]
    smem: Dict[str, int]
    groups: int


@functools.lru_cache(maxsize=4096)
def plan_bwd(b: int, s: int, nh: int, hp: int, ds: int, q: int,
             dtype: torch.dtype, sms: int = H100_SMS) -> BwdPlan:
    """The backward's plan for a scan of x [b, s, nh, hp] in chunks of
    ``q`` with state size ``ds`` and inputs in ``dtype`` on a card of
    ``sms`` SMs (a pure function of its arguments): ``tc`` for the sizes
    the forward's ``shared_cb`` takes, with the heads of the ``dxbc``
    launch (per 64-row tile of a chunk, one d(xdt) block and one dB / dC
    block per 64 columns of ds, each walking its heads in order) split into
    groups until that launch has two blocks an SM; ``general`` for every
    other shape the forward takes, in 64 x 64 tiles of 256 threads."""
    if dtype not in _SUFFIX:
        raise TypeError(f"no K4 backward for {dtype}")
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    if q > BWD_MAX_Q:
        raise ValueError(f"chunk {q} exceeds the backward's {BWD_MAX_Q}")
    nc, bh = s // q, b * nh
    t, td = _cdiv(q, _TILE), _cdiv(ds, _TILE)
    shared = {"dcb": (t * (t + 1) // 2, b * nc, 1),
              "state_pass": (_cdiv(hp * ds, _PASS_THREADS), bh, 1),
              "dcum": (nc, bh, 1), "da": (_cdiv(nh, _PASS_THREADS), 1, 1)}
    scratch = {"cb": (b, nc, q, q), "dcb": (b, nc, q, q),
               "dstate": (b, nh, nc, hp, ds), "rowpart": (b, nh, nc, t, q),
               "colpart": (b, nh, nc, t, q), "dcum_loc": (b, nh, nc, q),
               "ddt_x": (b, nh, nc, q), "rsum": (b, nh, nc, t),
               "dA_part": (nh, b, nc)}
    # y_off's partial row sums, one per 64 columns of ds
    scratch["yoff"] = (b, nh, nc, td, q)
    smem = {"dcum": 4 * q}
    if _shared_cb_fits(hp, ds, q):
        variant = BWD_TC
        # dxbc blocks a head group: per row tile one d(xdt) block and one
        # dB / dC block per 64 columns of ds
        rows = t * (1 + td) * b * nc
        per = _cdiv(nh, min(nh, _cdiv(_BWD_TC_BLOCKS_PER_SM * sms, rows)))
        groups = _cdiv(nh, per)
        grids = {"state_grad": (nc, bh, td),
                 "dxbc": (t, (1 + td) * groups, b * nc),
                 "bc_sum": (_cdiv(2 * b * s * ds, 4 * _PASS_THREADS), 1, 1),
                 **shared}
        scratch["bcpart"] = (groups, 2, b, s, ds)
        # the ring of staged operand slices; dcb's bf16 C and B rows of its
        # C B^T tile share its space
        smem["dcb"] = max(_BWD_TC_RING, 2 * _TILE * (ds + 8) * 2) \
            if dtype == torch.bfloat16 else _BWD_TC_RING
        smem["state_grad"] = smem["dxbc"] = _BWD_TC_RING
    else:
        variant, groups = GENERAL, 1
        grids = {"state_grad": (nc, bh, _cdiv(hp, _TILE) * td),
                 "dx": (t, nc, bh), "dbc": (t, td, b * nc), **shared}
    grids = {k: grids[k] for k in BWD_LAUNCH_NAMES[variant]}
    return BwdPlan(variant, grids, scratch, smem, groups)


def census_work_bwd(b: int, s: int, nh: int, hp: int, ds: int, q: int,
                    in_dtype: torch.dtype, with_final: bool
                    ) -> Tuple[int, int]:
    """(flops, bytes) of one backward call, as the census books it: the
    dots of the chunked VJP with full Q x Q products, as ``census_work``
    counts the forward's -- per (b, chunk) C B^T and dCB's two products, 6
    Q^2 ds; per head M and d(xdt)'s masked product, 4 Q^2 hp, and five Q
    hp ds products (G, B dS^T, C S_in^T, dY S_in, xdt dS), 10 Q hp ds --;
    dy (float32), the final state's cotangent when given, x, dt, A, B, C
    and the forward's ``states`` and ``cum`` read, dx, ddt, dA, dB, dC
    written once -- never the scratch."""
    nc = s // q
    flops = b * nc * (6 * q * q * ds
                      + nh * (4 * q * q * hp + 10 * q * hp * ds))
    it = in_dtype.itemsize
    nbytes = (4 * b * s * nh * hp + 4 * b * nh * hp * ds * int(with_final)
              + 2 * (it * b * s * (nh * hp + 2 * ds) + 4 * (b * s * nh + nh))
              + 4 * b * nh * nc * (hp * ds + q))
    return flops, nbytes


_bwd_bound = None


def _bwd_library():
    """The backward's loaded library with ``argtypes`` set."""
    global _bwd_bound
    if _bwd_bound is None:
        from repro_torch.kernels import build
        lib = build.load(BWD_SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in BWD_KEYS:
            fn = getattr(lib, name)
            fn.argtypes = ([vp] * 14 + [ctypes.POINTER(vp)] + [ci] * 8
                           + [ctypes.POINTER(ctypes.c_longlong), ci, vp])
            fn.restype = ci
        lib.ssd_scan_bwd_error_string.argtypes = [ci]
        lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_bwd_launch_shape.argtypes = [ci] * 9 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.ssd_scan_bwd_launch_shape.restype = None
        _bwd_bound = lib
    return _bwd_bound


def bwd_launch_shape(b: int, s: int, nh: int, hp: int, ds: int, q: int,
                     dtype: torch.dtype, sms: int = H100_SMS
                     ) -> Dict[str, object]:
    """What the backward's library launches for ``plan_bwd``'s variant and
    head groups at these sizes (builds and loads it): per launch its grid,
    threads per block and dynamic shared memory (bytes); and its constants
    (tile, threads of a general block, largest chunk, scratch pointers)."""
    p = plan_bwd(b, s, nh, hp, ds, q, dtype, sms)
    names = BWD_LAUNCH_NAMES[p.variant]
    n = len(names)
    out = (ctypes.c_int * (5 * n + 4))()
    _bwd_library().ssd_scan_bwd_launch_shape(
        b, s, nh, hp, ds, q, _BWD_VARIANT_ID[p.variant], p.groups,
        int(dtype == torch.bfloat16), out)
    v = list(out)
    return {"variant": p.variant,
            "launches": {name: {"grid": tuple(v[5 * i: 5 * i + 3]),
                                "threads": v[5 * i + 3],
                                "smem": v[5 * i + 4]}
                         for i, name in enumerate(names)},
            "tile": v[5 * n], "threads": v[5 * n + 1],
            "max_q": v[5 * n + 2], "scratch": v[5 * n + 3]}


def ssd_scan_bwd_plain(dy: torch.Tensor, d_final: Optional[torch.Tensor],
                       x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward, the kernel's formulas in
    float32, all (b, h) together: the forward's chunk loop again for the
    state entering every chunk, then the chunks last to first -- d(x dt)
    from ``(C B^T . L)^T dY`` and ``decay_end . (B dS_out^T)``; dCB and dL
    from ``dY (x dt)^T`` under the causal mask; dcum from dL's rows minus
    its columns, y_off (the row sums of ``C . (e^cum dY S_in)``, from the
    product dC needs: no ``C S_in^T``), decay_end and the chunk decay; ddA
    its reverse cumsum (float64); ``dS_in = (C . e^cum)^T dY + e^{cum_last}
    dS_out``.
    Returns ``(dx, ddt, dA, dB, dC)``, each in its input's dtype."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    dev = x.device
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B[:, :, 0].float(), C[:, :, 0].float()
    dyf = dy.float()
    tril = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
    cums, states = [], []
    state = torch.zeros((b, nh, hp, ds), dtype=torch.float32, device=dev)
    for t0 in range(0, s, q):       # the forward's states, as ssd_scan_plain
        xdt = (xf[:, t0:t0 + q] * dtf[:, t0:t0 + q, :, None]).transpose(1, 2)
        cum = torch.cumsum((dtf[:, t0:t0 + q].transpose(1, 2)
                            * A[:, None]).double(), dim=-1).float()
        cums.append(cum)
        states.append(state)
        decay_end = torch.exp(cum[..., -1:] - cum)
        contrib = (xdt * decay_end[..., None]).transpose(-1, -2) \
            @ Bf[:, None, t0:t0 + q]
        state = state * torch.exp(cum[..., -1])[..., None, None] + contrib
    dx = torch.empty((b, s, nh, hp), dtype=torch.float32, device=dev)
    ddt = torch.empty((b, s, nh), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, 1, ds), dtype=torch.float32, device=dev)
    dC = torch.empty((b, s, 1, ds), dtype=torch.float32, device=dev)
    dA = torch.zeros((nh,), dtype=torch.float32, device=dev)
    dS = (torch.zeros((b, nh, hp, ds), dtype=torch.float32, device=dev)
          if d_final is None else d_final.float())
    for c in reversed(range(s // q)):
        t0 = c * q
        xc = xf[:, t0:t0 + q].transpose(1, 2)            # [b, nh, Q, hp]
        dtc = dtf[:, t0:t0 + q].transpose(1, 2)          # [b, nh, Q]
        dyc = dyf[:, t0:t0 + q].transpose(1, 2)          # [b, nh, Q, hp]
        Bc, Cc = Bf[:, None, t0:t0 + q], Cf[:, None, t0:t0 + q]
        cum, s_in = cums[c], states[c]
        L = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~tril, float("-inf")))
        xdt = xc * dtc[..., None]
        CB = Cc @ Bc.transpose(-1, -2)                   # [b, 1, Q, Q]
        decay_end = torch.exp(cum[..., -1:] - cum)
        decay_in = torch.exp(cum)
        BdS = Bc @ dS.transpose(-1, -2)                  # [b, nh, Q, hp]
        dxdt = (CB * L).transpose(-1, -2) @ dyc + decay_end[..., None] * BdS
        M = (dyc @ xdt.transpose(-1, -2)).masked_fill(~tril, 0.0)
        ML = M * L
        P = ML * CB
        dYS = dyc @ s_in                                 # [b, nh, Q, ds]
        r = decay_end * (xdt * BdS).sum(-1)
        dcum = P.sum(-1) - P.sum(-2) + decay_in * (Cc * dYS).sum(-1) - r
        dcum[..., -1] += r.sum(-1) + torch.exp(cum[..., -1]) * (
            s_in * dS).sum((-1, -2))
        ddA = torch.flip(torch.cumsum(torch.flip(dcum.double(), [-1]), -1),
                         [-1]).float()
        dCB = ML.sum(1, keepdim=True)                    # [b, 1, Q, Q]
        dC[:, t0:t0 + q, 0] = (dCB @ Bc + (decay_in[..., None] * dYS)
                               .sum(1, keepdim=True))[:, 0]
        dB[:, t0:t0 + q, 0] = (dCB.transpose(-1, -2) @ Cc
                               + (decay_end[..., None] * (xdt @ dS))
                               .sum(1, keepdim=True))[:, 0]
        dx[:, t0:t0 + q] = (dxdt * dtc[..., None]).transpose(1, 2)
        ddt[:, t0:t0 + q] = ((dxdt * xc).sum(-1) + ddA * A[:, None]) \
            .transpose(1, 2)
        dA += (ddA * dtc).sum((0, 2))
        dS = dyc.transpose(-1, -2) @ (Cc * decay_in[..., None]) \
            + torch.exp(cum[..., -1])[..., None, None] * dS
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype))


def _bwd_kernel(dy, d_final, x, dt, A, B, C, states, cum, chunk: int
                ) -> Tuple[torch.Tensor, ...]:
    """The backward's kernels on CUDA tensors ``_validate`` accepted."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    dev = x.device
    p = plan_bwd(b, s, nh, hp, ds, q, x.dtype, _sm_count(dev))
    operand = SHARED_CB if p.variant == BWD_TC else GENERAL
    x, B, C = (_kernel_operand(t, operand) for t in (x, B, C))
    dt = dt if dt.stride(-1) == 1 else dt.contiguous()
    dy = dy.float().contiguous()
    if d_final is not None:
        d_final = d_final.float().contiguous()
    A = A.contiguous()
    if tuple(states.shape) != (b, nh, s // q, hp, ds) or \
            tuple(cum.shape) != (b, nh, s // q, q):
        raise ValueError(f"forward scratch states {tuple(states.shape)}, "
                         f"cum {tuple(cum.shape)} do not fit the scan")
    states, cum = states.contiguous(), cum.contiguous()
    dx = torch.empty((b, s, nh, hp), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, nh), dtype=torch.float32, device=dev)
    dA = torch.empty((nh,), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, 1, ds), dtype=B.dtype, device=dev)
    dC = torch.empty((b, s, 1, ds), dtype=C.dtype, device=dev)
    scratch = scratch_tensors(p, dev)
    ptrs = (ctypes.c_void_p * len(BWD_SCRATCH))(
        *(scratch[k].data_ptr() if k in scratch else None
          for k in BWD_SCRATCH))
    strides = (ctypes.c_longlong * 10)(
        *(int(st) for st in (*x.stride()[:3], *dt.stride(), *B.stride()[:2],
                             *C.stride()[:2])))
    lib = _bwd_library()
    name = f"ssd_scan_bwd_{_SUFFIX[x.dtype]}"
    code = getattr(lib, name)(
        dy.data_ptr(), None if d_final is None else d_final.data_ptr(),
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), states.data_ptr(), cum.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), ptrs,
        b, s, nh, hp, ds, q, _BWD_VARIANT_ID[p.variant], p.groups, strides,
        dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[name] += 1
    if code != 0:
        msg = lib.ssd_scan_bwd_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {name} ({p.variant}) failed: "
                           f"{msg} (cudaError {code}) at b {b}, S {s}, nh "
                           f"{nh}, hp {hp}, ds {ds}, Q {q}")
    return dx, ddt, dA, dB, dC


def ssd_scan_bwd(dy: torch.Tensor, d_final: Optional[torch.Tensor],
                 x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                 states: Optional[torch.Tensor] = None,
                 cum: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Gradients ``(dx, ddt, dA, dB, dC)`` of the scan ``ssd_scan(x, dt, A,
    B, C, chunk=chunk)`` given dy [b, S, nh, hp] (computed in float32) and
    the final state's gradient [b, nh, hp, ds] (None: zero).  CUDA tensors
    launch the backward's kernels, which read the forward's scratch
    ``states`` and ``cum`` (``ssd_scan_with_scratch``), or raise; CPU
    tensors take ``ssd_scan_bwd_plain``."""
    b, s, nh, hp, ds, q = _validate(x, dt, A, B, C, chunk)
    if tuple(dy.shape) != (b, s, nh, hp) or dy.device != x.device:
        raise ValueError(f"dy must be [b, S, nh, hp] = {(b, s, nh, hp)} on "
                         f"{x.device}; got {tuple(dy.shape)} on {dy.device}")
    if d_final is not None and tuple(d_final.shape) != (b, nh, hp, ds):
        raise ValueError(f"d_final must be [b, nh, hp, ds] = "
                         f"{(b, nh, hp, ds)}; got {tuple(d_final.shape)}")
    with census.kernel_call(lambda: (
            f"ssd_scan_bwd_{_SUFFIX[x.dtype]}",
            *census_work_bwd(b, s, nh, hp, ds, q, x.dtype,
                             d_final is not None))):
        if x.device.type == "cpu":
            return ssd_scan_bwd_plain(dy, d_final, x, dt, A, B, C,
                                      chunk=chunk)
        if x.device.type == "meta":       # the census's shape-only route
            plan_bwd(b, s, nh, hp, ds, q, x.dtype)
            return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         for t in (x, dt, A, B, C))
        if states is None or cum is None:
            raise ValueError("the backward's kernels read the forward's "
                             "scratch: pass states and cum "
                             "(ssd_scan_with_scratch)")
        return _bwd_kernel(dy, d_final, x, dt, A, B, C, states, cum, q)


class SSDScan(torch.autograd.Function):
    """K4 with its backward: the forward saves its inputs and, on the card
    and the meta device, the scratch the backward reads (``states``,
    ``cum``); the backward is ``ssd_scan_bwd``.  On the CPU both are the
    plain versions."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int,
                out_dtype: Optional[torch.dtype]):
        y, final, scratch = _scan(x, dt, A, B, C, chunk, out_dtype)
        saved = (x, dt, A, B, C)
        if scratch is not None:
            saved += (scratch["states"], scratch["cum"])
        ctx.save_for_backward(*saved)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, d_final):
        x, dt, A, B, C, *scratch = ctx.saved_tensors
        if dy is None:
            b, s, nh, hp = x.shape
            dy = torch.zeros((b, s, nh, hp), dtype=torch.float32,
                             device=x.device)
        states, cum = scratch if scratch else (None, None)
        grads = ssd_scan_bwd(dy, d_final, x, dt, A, B, C, chunk=ctx.chunk,
                             states=states, cum=cum)
        return (*grads, None, None)
