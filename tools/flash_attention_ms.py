#!/usr/bin/env python3
"""Time of the PyTorch port's attention kernel (K3) alone, from a checkout.

    python3 tools/flash_attention_ms.py [--root DIR] [--iters 50]
        [--seed 0] [--shapes NAME,...] [--check] [--scales]
        [--source COPY.cu]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Calls
``repro_torch.kernels.flash_attention.flash_attention`` (causal, with the
shape's bidirectional prefix) on the model shapes of ``chip_smoke.py`` --
stablelm-1.6b B=1 S=4096 and B=8 S=1024 (32 heads of 64), qwen3-14b B=1
S=2048 (40 heads, 8 kv, of 128), paligemma-3b B=1 S=4096 and B=8 S=1024
(8 heads, 1 kv, of 256, a prefix of 256 patches) and a ragged B=2 S=1000
(4 heads, 2 kv, of 256, prefix 77), each in bf16 and float32, stablelm B=1
S=4096 in float32, and deepseek-v2 / v3's MLA at (hd, hv) = (192, 128) (B=1 S=4096,
128 heads, prefill (a); a ragged B=2 S=1000, 4 heads; H == KV; each in
bf16 and float32) -- on seeded random inputs on the first CUDA card, and
prints one JSON
object: per shape the milliseconds of one call (``call``; CUDA events
around ``--iters`` back-to-back calls after a warm-up, inputs L2-warm
where they fit), of the training forward that also writes the log-sum-exp
(``lse``, ``flash_attention_fwd``, where the checkout has it) and of
``F.scaled_dot_product_attention`` on the same inputs (``sdpa``; causal
by ``is_causal``, a prefix as a boolean mask, timed only), with the card's
name; and the memory the card holds at the peak of one call (``peak_gb``:
inputs, output and whatever scratch the call allocates; torch's allocator
statistics) and ``b_fit``, the batch at which that peak, linear in B,
reaches the card's memory (computed, not run).  ``--check``
also holds each call against the plain version on the card (bf16: within
2e-2 + 2e-2 |plain|, float32 1e-5) and against a second call, bitwise, and
exits 1 if one fails.  ``--scales`` instead runs float32 K3 at
``chip_smoke.py``'s other softmax scales and scale shapes (B=1 S=300 H=4,
hd 64, 128, (192, 128) and 256, causal and not) and prints, per case, how far
K3, the plain version and each other lie (max |diff|) and how far each of
the two lies from softmax attention in float64: a reading, no gate.
``--source`` builds an edited copy of ``csrc/flash_attention.cu``
(``hopper.cuh`` beside it) with that source's nvcc flags and runs it in
place of the checkout's forward library (the same C interface), printing
its ptxas report for the float32 wgmma kernel, so that variants of the
source can be checked and timed in turns, one process each.  Needs a CUDA
card; exits 2 without one.
"""

import argparse
import json
import os
import sys

# (name, dtype, B, S, H, KV, d, prefix); d is hd == hv or (hd, hv)
SHAPES = (("stablelm_b1_s4096", "bfloat16", 1, 4096, 32, 32, 64, 0),
          ("stablelm_b8_s1024", "bfloat16", 8, 1024, 32, 32, 64, 0),
          ("qwen3_b1_s2048", "bfloat16", 1, 2048, 40, 8, 128, 0),
          ("paligemma_b1_s4096", "bfloat16", 1, 4096, 8, 1, 256, 256),
          ("paligemma_b8_s1024", "bfloat16", 8, 1024, 8, 1, 256, 256),
          ("prefix_ragged_d256", "bfloat16", 2, 1000, 4, 2, 256, 77),
          ("stablelm_b1_s4096_f32", "float32", 1, 4096, 32, 32, 64, 0),
          ("paligemma_b1_s4096_f32", "float32", 1, 4096, 8, 1, 256, 256),
          ("paligemma_b8_s1024_f32", "float32", 8, 1024, 8, 1, 256, 256),
          ("prefix_ragged_d256_f32", "float32", 2, 1000, 4, 2, 256, 77),
          ("deepseek_b1_s4096", "bfloat16", 1, 4096, 128, 128, (192, 128),
           0),
          ("mla_ragged_b2_s1000", "bfloat16", 2, 1000, 4, 4, (192, 128), 0),
          ("deepseek_b1_s4096_f32", "float32", 1, 4096, 128, 128,
           (192, 128), 0),
          ("mla_ragged_b2_s1000_f32", "float32", 2, 1000, 4, 4, (192, 128),
           0))
# --scales: (B, S, H, KV, d) and the scales of chip_smoke.py's scale cases
SCALE_SHAPES = ((1, 300, 4, 2, 64), (1, 300, 4, 2, 128),
                (1, 300, 4, 4, (192, 128)), (1, 300, 4, 2, 256))
SCALES = (0.3, -0.2)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="",
                    help="comma-separated names (default: all)")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--scales", action="store_true")
    ap.add_argument("--source", default="",
                    help="an edited copy of csrc/flash_attention.cu to "
                         "build and run in place of the checkout's")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import flash_attention as k3
    source = {}
    if args.source:
        source = {"source": os.path.abspath(args.source),
                  "ptxas_f32_tc": use_source(k3, args.source)}

    def time_ms(fn):
        for _ in range(5):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 1e9

    if args.scales:
        print(json.dumps(scale_errors(torch, k3, args)))
        return 0
    card_gb = torch.cuda.mem_get_info()[1] / 1e9
    wanted = set(filter(None, args.shapes.split(",")))
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), **source, "ms": {}}
    failed = []
    for name, dtype, b, s, h, kv, d, prefix in SHAPES:
        if wanted and name not in wanted:
            continue
        dt = getattr(torch, dtype)
        hd, hv = d if isinstance(d, tuple) else (d, d)
        q, k, v = (torch.randn((b, s, n, w), generator=g, device="cuda")
                   .to(dt) for n, w in ((h, hd), (kv, hd), (kv, hv)))
        kw = {"prefix_len": prefix} if prefix else {}
        row = {"peak_gb": peak_gb(lambda: k3.flash_attention(
            q, k, v, causal=True, **kw))}
        row["b_fit"] = int(card_gb // (row["peak_gb"] / b))
        row["call"] = time_ms(lambda: k3.flash_attention(
            q, k, v, causal=True, **kw))
        if hasattr(k3, "flash_attention_fwd") and (
                hd == hv and hd in k3.BWD_HEAD_DIMS
                or (hd, hv) in getattr(k3, "RECT_PAIRS", ())):
            row["lse"] = time_ms(lambda: k3.flash_attention_fwd(
                q, k, v, causal=True, **kw))
        i = torch.arange(s, device="cuda")
        mask = ((i[None, :] <= i[:, None]) | (i[None, :] < prefix)) \
            if prefix else None
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        row["sdpa"] = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=not prefix,
            enable_gqa=True))
        if args.check:
            got = k3.flash_attention(q, k, v, causal=True, **kw)
            again = k3.flash_attention(q, k, v, causal=True, **kw)
            want = k3.flash_attention_plain(q, k, v, causal=True,
                                            **kw).float()
            err = (got.float() - want).abs()
            tol = (2e-2 + 2e-2 * want.abs()) if dt == torch.bfloat16 \
                else (1e-5 + 1e-5 * want.abs())
            row["max_abs_err"] = float(err.max())
            row["within"] = bool((err <= tol).all())
            row["bitwise_twice"] = bool(torch.equal(got, again))
            if "lse" in row:    # the training forward: o and lse
                o2, lse2 = k3.flash_attention_fwd(q, k, v, causal=True, **kw)
                lse_want = k3._plain_forward(q, k, v, True, hd ** -0.5,
                                             prefix)[1]
                row["lse_max_abs_err"] = float((lse2 - lse_want).abs().max())
                row["within"] = row["within"] and bool(
                    torch.equal(o2, got)) and row["lse_max_abs_err"] <= 2e-3
                del o2, lse2, lse_want
            if not (row["within"] and row["bitwise_twice"]):
                failed.append(name)
            del got, again, want, err, tol
        out["ms"][name] = row
        # nothing of this shape stays allocated into the next one's peak
        del q, k, v, qs, ks, vs, mask
    if args.check:
        out["failed"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


def scale_errors(torch, k3, args) -> dict:
    """float32 K3 and its plain version against float64 attention at
    ``SCALES`` on ``SCALE_SHAPES``."""
    def exact(q, k, v, causal, scale):
        q, k, v = (t.double() for t in (q, k, v))
        g = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        if causal:
            s = q.shape[1]
            seen = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
            sc = sc.masked_fill(~seen, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), v)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for b, s, h, kv, d in SCALE_SHAPES:
        hd, hv = d if isinstance(d, tuple) else (d, d)
        for scale in SCALES:
            for causal in (True, False):
                q, k, v = (torch.randn((b, s, n, w), generator=g,
                                       device="cuda")
                           for n, w in ((h, hd), (kv, hd), (kv, hv)))
                o = k3.flash_attention(q, k, v, causal=causal, scale=scale)
                op = k3.flash_attention_plain(q, k, v, causal=causal,
                                              scale=scale)
                want = exact(q, k, v, causal, scale)
                rows.append({"shape": [b, s, h, kv, hd, hv], "scale": scale,
                             "causal": causal, "k3_plain": err(o, op),
                             "k3_f64": err(o, want),
                             "plain_f64": err(op, want)})
    return {"root": os.path.abspath(args.root),
            "device": torch.cuda.get_device_name(0), "scales": rows}


def use_source(k3, src: str) -> list:
    """Builds ``src`` (a copy of the forward's source) with the source's
    nvcc flags and makes it ``k3``'s forward library; returns ptxas's
    register and spill lines for the float32 wgmma kernel's instances."""
    import ctypes
    import hashlib
    import re
    import subprocess

    from repro_torch.kernels import build
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = build.default_build_dir() / f"fwd_source_{tag}.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.flags(k3.SOURCE),
                           "-o", str(lib_path), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    template = k3._library()
    lib = ctypes.CDLL(str(lib_path))
    for fn in (list(k3.FWD_VARIANTS) + [v + "_lse" for v in k3.LSE_VARIANTS]
               + [k3.F32_TC_ENTRY, k3.F32_TC_ENTRY + "_lse",
                  "flash_attention_error_string"]):
        getattr(lib, fn).argtypes = getattr(template, fn).argtypes
        getattr(lib, fn).restype = getattr(template, fn).restype
    k3._bound = lib
    report, name = [], None
    for ln in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m[1]
        elif name and "flash_f32_tc_kernel" in name and (
                "registers" in ln or "spill" in ln):
            report.append(f"{name[-40:]}: {ln.split(':', 1)[-1].strip()}")
    return report


if __name__ == "__main__":
    sys.exit(main())
