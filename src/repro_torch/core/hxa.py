"""HxA for the port: the reference's HLO-text analyzer (part a) and its
counterpart for the port's own eager step (part b, ``analyze_step``).

Part (a), kept from the reference's ``core/hxa.py`` unchanged: the
analyzer from ``parse_module`` to ``analyze_hlo_text``, pure Python.  The
port has no compiler IR of its own; it keeps the analyzer to re-analyze
reference artifacts that carry their compiled HLO
(``launch.dryrun.reanalyze``) and for the parity tests.

Part (b), ``analyze_step``: the same census of what EXECUTES, taken from the
port's step op by op (a ``TorchDispatchMode``), with the keys of
``analyze_hlo_text``; the hand-written kernels, which no dispatch mode sees,
report their own entries (``kernel_call``).  It lives in ``core/census.py``
(which the kernel wrappers import) and is re-exported here.

The reference's description of part (a):

HxA — Hybrid HLO Analyzer (the paper's HyPA, adapted PTX -> HLO).

The paper's HyPA statically analyzes compiled PTX and micro-simulates control
flow (loops, branches) to recover the number of instructions that actually
EXECUTE, because a static census alone undercounts loop bodies.  The exact
same gap exists in XLA: ``compiled.cost_analysis()`` counts a ``while`` body
(every ``lax.scan`` — i.e. every scanned transformer stack) ONCE, not
trip-count times (verified empirically; see EXPERIMENTS.md §Dry-run).

HxA closes the gap the HyPA way:
  1. parse the compiled (post-SPMD, post-fusion) HLO module text,
  2. statically census FLOPs / HBM-traffic bytes / collective bytes per op,
  3. "simulate" control flow: recover each while loop's trip count from its
     condition computation (the compare-against-constant pattern) and multiply
     the body's census through — nested loops compose multiplicatively.

Everything here is per-device (post-SPMD shapes are per-device shards).

Cost conventions (documented knobs, not truth claims):
  * dot:           2 * prod(result) * K   (K = contracted extent)
  * convolution:   2 * prod(result) * prod(kernel) / out_features
  * elementwise:   1 flop / output element (transcendentals too)
  * reduce:        1 flop / input element
  * HBM bytes:     operand + result bytes of materializing ops only (fusion
                   interiors are free — they never round-trip to HBM)
  * collectives:   operand bytes (the §Roofline contract), plus a modeled
                   "wire bytes" using ring formulas for reporting.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_TYPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_ASSIGN_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_OPCODE_RE = re.compile(r"([a-z][a-z0-9\-]*)\(")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\([^)]*\))?.*\{\s*$")
_CALL_ATTR_RE = re.compile(r"(?:calls|body|condition|to_apply)=%?([\w.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _shape_elems(shape_str: str) -> int:
    if not shape_str:
        return 1
    n = 1
    for d in shape_str.split(","):
        n *= int(d)
    return n


def _parse_types(segment: str) -> List[Tuple[str, List[int]]]:
    out = []
    for m in _TYPE_RE.finditer(segment):
        dims = [int(d) for d in m.group(2).split(",") if d] if m.group(2) else []
        out.append((m.group(1), dims))
    return out


def _bytes_of(types: List[Tuple[str, List[int]]]) -> int:
    total = 0
    for dt, dims in types:
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


@dataclasses.dataclass
class Op:
    name: str
    opcode: str
    result_types: List[Tuple[str, List[int]]]
    operand_names: List[str]
    args: str
    attrs: str
    calls: List[str]
    operand_types: List[Tuple[str, List[int]]] = dataclasses.field(default_factory=list)


_OPERAND_RE = re.compile(r"%([\w.\-]+)")


def parse_module(text: str) -> Dict[str, List[Op]]:
    """Split an HLO module into computations -> op lists.

    Optimized HLO prints operands as bare %names — types are resolved through
    a per-computation symbol table (operands always live in their computation).
    """
    comps: Dict[str, List[Op]] = {}
    current: Optional[str] = None
    for line in text.splitlines():
        if current is None:
            m = _COMP_RE.match(line.strip()) if line.rstrip().endswith("{") else None
            if m and ("->" in line or line.lstrip().startswith(("ENTRY", "%"))):
                current = m.group(1)
                comps[current] = []
            continue
        if line.startswith("}") or line.strip() == "}":
            current = None
            continue
        m = _ASSIGN_RE.match(line)
        if not m:
            continue
        name, rest0 = m.groups()
        # the opcode is the first `token(` after the (possibly tuple) type —
        # type strings never contain '(' directly after an identifier.
        om = _OPCODE_RE.search(rest0)
        if not om:
            continue
        rtype, opcode, rest = rest0[: om.start()], om.group(1), rest0[om.end():]
        # split args segment from attributes (first unmatched ')')
        depth, idx = 1, 0
        for idx, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    break
        args, attrs = rest[:idx], rest[idx + 1:]
        comps[current].append(Op(
            name=name, opcode=opcode,
            result_types=_parse_types(rtype),
            operand_names=_OPERAND_RE.findall(args),
            args=args,
            attrs=attrs,
            calls=_CALL_ATTR_RE.findall(attrs)))
    # resolve operand types
    for ops in comps.values():
        table = {op.name: op.result_types for op in ops}
        for op in ops:
            inline = _parse_types(op.args)
            if inline:
                op.operand_types = inline
            else:
                op.operand_types = [t for nm in op.operand_names
                                    for t in table.get(nm, [])]
    return comps


# --- per-op flop model ------------------------------------------------------------

_ELEMENTWISE_FREE = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "reshape", "transpose", "copy", "broadcast", "iota", "slice",
    "dynamic-slice", "dynamic-update-slice", "concatenate", "pad", "reverse",
    "gather", "scatter", "convert", "after-all", "custom-call",
    "rng-bit-generator", "partition-id", "replica-id", "optimization-barrier",
    "while", "conditional", "call", "fusion", "select-and-scatter", "bitcast-convert",
} | set(COLLECTIVE_OPS)


def _op_flops(op: Op) -> float:
    out_elems = sum(_shape_elems(",".join(map(str, dims))) if dims else 1
                    for _, dims in op.result_types)
    if op.opcode == "dot":
        m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.attrs)
        k = 1
        if m and op.operand_types:
            lhs_dims = op.operand_types[0][1]
            for ci in (int(c) for c in m.group(1).split(",") if c):
                if ci < len(lhs_dims):
                    k *= lhs_dims[ci]
        return 2.0 * out_elems * k
    if op.opcode == "convolution":
        if len(op.operand_types) >= 2:
            kdims = op.operand_types[1][1]
            kelems = 1
            for d in kdims:
                kelems *= d
            out_feat = kdims[-1] if kdims else 1
            return 2.0 * out_elems * (kelems / max(out_feat, 1))
        return 2.0 * out_elems
    if op.opcode in ("reduce", "reduce-window"):
        in_elems = sum(_shape_elems(",".join(map(str, d))) if d else 1
                       for _, d in op.operand_types)
        return float(in_elems)
    if op.opcode in _ELEMENTWISE_FREE:
        return 0.0
    return float(out_elems)          # elementwise / transcendental: 1/elt


def _trip_count(cond_ops: List[Op]) -> int:
    """HyPA-style control-flow resolution: largest integer constant in the
    loop condition (scan conditions compare the counter to the trip bound)."""
    best = 1
    for op in cond_ops:
        if op.opcode == "constant":
            m = re.match(r"\s*(\d+)\s*$", op.args)
            if m:
                best = max(best, int(m.group(1)))
        for m in _CONST_RE.finditer(op.attrs):
            best = max(best, int(m.group(1)))
    return best


_MATERIALIZING = {"fusion", "dot", "convolution", "copy", "concatenate",
                  "scatter", "sort", "reduce", "transpose",
                  "pad", "custom-call"} | set(COLLECTIVE_OPS)
# broadcasts/iotas fuse into consumers on TPU: no HBM round-trip.
# window-ops: traffic = the data actually touched, not the whole base buffer
_WINDOW_READ = {"dynamic-slice", "slice", "gather"}
_WINDOW_WRITE = {"dynamic-update-slice"}


@dataclasses.dataclass
class Census:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0           # operand bytes (§Roofline contract)
    wire_bytes: float = 0.0                 # ring-modeled bytes on the ICI
    op_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_by_opcode: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    loops: List[Dict] = dataclasses.field(default_factory=list)

    def _hbm(self, opcode: str, nbytes: float):
        self.hbm_bytes += nbytes
        self.hbm_by_opcode[opcode] = self.hbm_by_opcode.get(opcode, 0.0) + nbytes

    def add(self, other: "Census", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.wire_bytes += other.wire_bytes * mult
        for k, v in other.op_counts.items():
            self.op_counts[k] = self.op_counts.get(k, 0) + v * mult
        for k, v in other.hbm_by_opcode.items():
            self.hbm_by_opcode[k] = self.hbm_by_opcode.get(k, 0.0) + v * mult
        for k, v in other.collectives.items():
            slot = self.collectives.setdefault(k, {"count": 0.0, "bytes": 0.0,
                                                   "wire_bytes": 0.0})
            for kk in slot:
                slot[kk] += v.get(kk, 0.0) * mult
        self.loops.extend(other.loops)


def _group_size(attrs: str) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", attrs)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", attrs)
    if m:
        return len(m.group(1).split(","))
    return 2


def _wire_factor(opcode: str, n: int) -> float:
    """Ring-algorithm bytes-on-wire multiplier per device."""
    if n <= 1:
        return 0.0
    if opcode == "all-reduce":
        return 2.0 * (n - 1) / n
    if opcode in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0  # collective-permute


def _passes_through_bf16(src: Op, comps: Dict[str, List[Op]]) -> bool:
    """True when `src` produces f32 values that semantically went through
    bf16 (XLA:CPU's promotion of bf16 math; TPU keeps bf16)."""
    if not src.result_types or src.result_types[0][0] != "f32":
        return False
    if src.opcode == "convert":
        return any(dt == "bf16" for dt, _ in src.operand_types)
    if src.opcode == "fusion" and "convert" in src.name and src.calls:
        callee = comps.get(src.calls[0], [])
        return any(o.opcode == "convert" and o.result_types
                   and o.result_types[0][0] == "bf16" for o in callee)
    return False


def census_computation(name: str, comps: Dict[str, List[Op]],
                       _memo: Optional[dict] = None,
                       trips_ctx: int = 1) -> Census:
    """trips_ctx: trip count of the IMMEDIATELY enclosing while loop.  A
    fusion that dynamic-slices a stacked buffer inside a T-trip loop touches
    a 1/T window of it per iteration — the HyPA-style control-flow-aware
    traffic attribution."""
    memo = _memo if _memo is not None else {}
    key = (name, trips_ctx)
    if key in memo:
        return memo[key]
    c = Census()
    producers = {o.name: o for o in comps.get(name, [])}
    for op in comps.get(name, []):
        c.op_counts[op.opcode] = c.op_counts.get(op.opcode, 0) + 1
        c.flops += _op_flops(op)
        if op.opcode in COLLECTIVE_OPS:
            b = _bytes_of(op.operand_types)
            if op.opcode == "all-gather":                  # result is the moved unit
                b = max(b, _bytes_of(op.result_types))
            # XLA:CPU promotes bf16 reductions to f32 (no native bf16 adds);
            # TPU reduces in bf16.  If the operand passes through bf16 (a
            # bf16->f32 convert, or a fusion with an interior bf16 roundtrip),
            # charge the collective at bf16 width.
            if op.operand_names:
                src = producers.get(op.operand_names[0])
                if src is not None and _passes_through_bf16(src, comps):
                    b *= 0.5
            n = _group_size(op.attrs)
            wire = b * _wire_factor(op.opcode, n)
            c.collective_bytes += b
            c.wire_bytes += wire
            slot = c.collectives.setdefault(op.opcode,
                                            {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += b
            slot["wire_bytes"] += wire
            c._hbm(op.opcode, _bytes_of(op.operand_types) + _bytes_of(op.result_types))
        elif op.opcode == "while":
            body, cond = None, None
            m = re.search(r"body=%?([\w.\-]+)", op.attrs)
            if m:
                body = m.group(1)
            m = re.search(r"condition=%?([\w.\-]+)", op.attrs)
            if m:
                cond = m.group(1)
            trips = _trip_count(comps.get(cond, [])) if cond else 1
            if body:
                sub = census_computation(body, comps, memo, trips_ctx=trips)
                c.add(sub, mult=trips)
                c.loops.append({"body": body, "trips": trips,
                                "body_flops": sub.flops})
        elif op.opcode in ("fusion", "call", "conditional"):
            sub_counts = Census()
            for callee in op.calls:
                sub = census_computation(callee, comps, memo, trips_ctx=trips_ctx)
                c.add(sub)
                sub_counts.add(sub)
            if op.opcode == "fusion":
                ob = [_bytes_of([t]) for t in op.operand_types]
                rb = _bytes_of(op.result_types)
                has_ds = sub_counts.op_counts.get("dynamic-slice", 0) > 0
                has_reduce = any(k.startswith("reduce")
                                 for k in sub_counts.op_counts)
                # XLA:CPU widens bf16 while-carries to f32 (wrapped_convert at
                # entry; converts inside every carry-touching fusion).  TPU has
                # native bf16 — charge such fusions at bf16 width.  Signature:
                # interior converts with both f32 and bf16 params present.
                widened = (
                    sub_counts.op_counts.get("convert", 0) >= 2
                    and any(dt == "f32" for dt, _ in op.operand_types)
                    and trips_ctx > 1
                    and (sub_counts.op_counts.get("dynamic-update-slice")
                         or sub_counts.op_counts.get("select")))
                width_corr = 0.5 if widened else 1.0
                if sub_counts.op_counts.get("dynamic-update-slice"):
                    # in-place window write (scan ys / cache update): the base
                    # buffer is aliased through; true traffic is the window,
                    # read + write — approximated by the non-base operands,
                    # themselves window-capped when sliced inside a loop.
                    base = max((x for x in ob if x <= rb), default=0)
                    rest = 0.0
                    for x in ob:
                        if x == base:
                            base = -1          # consume base exactly once
                            continue
                        if trips_ctx > 1:
                            # per-iteration window of stacked buffers: no
                            # operand moves more than biggest-buffer/trips
                            rest += min(x, max(rb, x) / trips_ctx)
                        else:
                            rest += x
                    b = 2.0 * max(rest, 1.0)
                else:
                    b = rb
                    for x in ob:
                        if has_ds and trips_ctx > 1 and x > 4 * rb:
                            # sliced stacked buffer inside a T-trip loop:
                            # per-iteration window = 1/T of the base
                            b += max(rb, x / trips_ctx)
                        elif has_reduce:
                            b += x          # reductions truly read it all
                        elif x > 4 * rb:
                            # windowed read of a big buffer outside loops
                            b += rb if has_ds else x
                        else:
                            b += min(x, rb) if not has_reduce else x
                c._hbm("fusion", b * width_corr)
        elif op.opcode == "copy":
            # loop-carry copies are aliased away by TPU buffer assignment;
            # charge the write side only.
            c._hbm(op.opcode, _bytes_of(op.result_types))
        elif op.opcode in _WINDOW_READ:
            c._hbm(op.opcode, 2.0 * _bytes_of(op.result_types))
        elif op.opcode in _WINDOW_WRITE:
            upd = (_bytes_of(op.operand_types[1:2])
                   if len(op.operand_types) > 1 else _bytes_of(op.result_types))
            c._hbm(op.opcode, 2.0 * upd)
        else:
            if op.opcode in _MATERIALIZING:
                c._hbm(op.opcode, _bytes_of(op.operand_types) + _bytes_of(op.result_types))
    memo[name] = c
    return c


def _entry_name(comps: Dict[str, List[Op]], text: str) -> str:
    m = re.search(r"^ENTRY\s+%?([\w.\-]+)", text, re.M)
    if m and m.group(1) in comps:
        return m.group(1)
    # fallback: computation with the most ops
    return max(comps, key=lambda k: len(comps[k]))


def analyze_hlo_text(text: str) -> dict:
    """Full HxA analysis of one compiled HLO module (per-device numbers)."""
    comps = parse_module(text)
    entry = _entry_name(comps, text)
    # fusions called inside while bodies are memoized once; the recursion in
    # census_computation handles nesting, so we only walk from the entry.
    census = census_computation(entry, comps, {})
    return {
        "entry": entry,
        "flops": census.flops,
        "hbm_bytes": census.hbm_bytes,
        "collective_bytes": census.collective_bytes,
        "wire_bytes": census.wire_bytes,
        "op_counts": dict(sorted(census.op_counts.items(),
                                 key=lambda kv: -kv[1])[:40]),
        "hbm_by_opcode": dict(sorted(census.hbm_by_opcode.items(),
                                     key=lambda kv: -kv[1])[:15]),
        "collectives": census.collectives,
        "loops": census.loops[:20],
        "n_computations": len(comps),
    }


# part (b) lives in core/census.py, which the kernel wrappers import without
# this parser
from repro_torch.core.census import analyze_step  # noqa: E402,F401
