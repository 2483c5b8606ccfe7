#!/usr/bin/env python3
"""Time of the PyTorch port's attention backward (K3's backward) alone, from
a checkout.

    python3 tools/flash_attention_bwd_ms.py [--root DIR] [--iters 20]
        [--seed 0] [--shapes NAME,...] [--check] [--source COPY.cu]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so two
checkouts can be compared on one card, in turns.  Calls
``repro_torch.kernels.flash_attention.flash_attention_bwd`` on the shapes
of ``chip_smoke.py``'s training (d) -- stablelm-1.6b B=1 S=4096 (32 heads
of 64) and qwen3-14b B=1 S=2048 (40 heads, 8 kv, of 128), causal; a
ragged B=2 S=1000 (4 heads of 64, causal) and a non-causal B=1 S=512 (8
heads, 2 kv, of 128); each in bf16 and float32 -- and on paligemma-3b's
head-dim-256 shapes (B=1 S=4096 and B=8 S=1024, 8 heads, 1 kv, a prefix
of 256; a ragged B=2 S=1000, 4 heads, 2 kv, prefix 77; each in bf16 and
float32) and deepseek-v2 / v3's MLA at (hd, hv) = (192, 128)
(B=1 S=4096, 128 heads, causal, training (r)'s shape; a ragged B=2 S=1000,
4 heads; H == KV; each in bf16 and float32) on seeded random inputs and
the forward kernel's own
output and log-sum-exp, on the first CUDA card.  Prints one JSON object:
per shape the milliseconds of one call (CUDA events around ``--iters``
back-to-back calls after a warm-up, inputs L2-warm where they fit), of
the dQ and the dK / dV kernel alone where the checkout can launch them
apart (``bwd_launch``), and of SDPA's backward on the same inputs
(``torch.autograd.grad`` through ``F.scaled_dot_product_attention``, the
prefix as a boolean mask; timed only), with the card's name; and the
memory the card holds at the peak of one call (``peak_gb``: inputs,
outputs and whatever scratch the call allocates; torch's allocator
statistics) and ``b_fit``, the batch at which that peak, linear in B,
reaches the card's memory (computed, not run).  ``--check`` also holds
each gradient against the plain backward on the card (within 2e-2 of its
scale in bf16, 1e-4 in float32) and against a second call, bitwise, and
exits 1 if one fails.  ``--source`` builds an edited copy of
``csrc/flash_attention_bwd.cu`` (``hopper.cuh`` beside it) with that
source's nvcc flags into the build directory and runs it in place of the
checkout's backward library (the same C interface), so that variants of
the source can be checked and timed in turns, one process each.  Needs a
CUDA card; exits 2 without one.
"""

import argparse
import json
import os
import sys

# (name, dtype, B, S, H, KV, d, causal, prefix); d is hd == hv or (hd, hv)
SHAPES = (("stablelm_b1_s4096", "bfloat16", 1, 4096, 32, 32, 64, True, 0),
          ("qwen3_b1_s2048", "bfloat16", 1, 2048, 40, 8, 128, True, 0),
          ("ragged_b2_s1000", "bfloat16", 2, 1000, 4, 4, 64, True, 0),
          ("noncausal_b1_s512_gqa", "bfloat16", 1, 512, 8, 2, 128, False,
           0),
          ("paligemma_b1_s4096", "bfloat16", 1, 4096, 8, 1, 256, True, 256),
          ("paligemma_b8_s1024", "bfloat16", 8, 1024, 8, 1, 256, True, 256),
          ("prefix_ragged_d256", "bfloat16", 2, 1000, 4, 2, 256, True, 77),
          ("stablelm_b1_s4096_f32", "float32", 1, 4096, 32, 32, 64, True,
           0),
          ("qwen3_b1_s2048_f32", "float32", 1, 2048, 40, 8, 128, True, 0),
          ("ragged_b2_s1000_f32", "float32", 2, 1000, 4, 4, 64, True, 0),
          ("noncausal_b1_s512_gqa_f32", "float32", 1, 512, 8, 2, 128, False,
           0),
          ("paligemma_b1_s4096_f32", "float32", 1, 4096, 8, 1, 256, True,
           256),
          ("paligemma_b8_s1024_f32", "float32", 8, 1024, 8, 1, 256, True,
           256),
          ("prefix_ragged_d256_f32", "float32", 2, 1000, 4, 2, 256, True,
           77),
          ("deepseek_b1_s4096", "bfloat16", 1, 4096, 128, 128, (192, 128),
           True, 0),
          ("mla_ragged_b2_s1000", "bfloat16", 2, 1000, 4, 4, (192, 128),
           True, 0),
          ("deepseek_b1_s4096_f32", "float32", 1, 4096, 128, 128,
           (192, 128), True, 0),
          ("mla_ragged_b2_s1000_f32", "float32", 2, 1000, 4, 4, (192, 128),
           True, 0))


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="",
                    help="comma-separated names (default: all)")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--source", default="",
                    help="an edited copy of csrc/flash_attention_bwd.cu to "
                         "build and run in place of the checkout's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import flash_attention as k3
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "ms": {}}
    if args.source:
        out["source"] = os.path.abspath(args.source)
        out["ptxas_warnings"] = use_source(k3, args.source)

    def time_ms(fn):
        for _ in range(3):
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

    wanted = set(filter(None, args.shapes.split(",")))
    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 1e9

    card_gb = torch.cuda.mem_get_info()[1] / 1e9
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    failed = []
    for name, dtype, b, s, h, kv, d, causal, prefix in SHAPES:
        if wanted and name not in wanted:
            continue
        dt = getattr(torch, dtype)
        hd, hv = d if isinstance(d, tuple) else (d, d)
        q, k, v, do = (torch.randn((b, s, n, w), generator=g, device="cuda")
                       .to(dt) for n, w in ((h, hd), (kv, hd), (kv, hv),
                                            (h, hv)))
        kw = {"prefix_len": prefix} if prefix else {}
        o, lse = k3.flash_attention_fwd(q, k, v, causal=causal, **kw)
        row = {"peak_gb": peak_gb(lambda: k3.flash_attention_bwd(
            do, q, k, v, o, lse, causal=causal, **kw))}
        row["b_fit"] = int(card_gb // (row["peak_gb"] / b))
        row["call"] = time_ms(lambda: k3.flash_attention_bwd(
            do, q, k, v, o, lse, causal=causal, **kw))
        scratch = None
        if hasattr(k3, "bwd_launch"):
            scale = hd ** -0.5
            pkw = {"prefix": prefix} if prefix else {}
            scratch = k3.bwd_launch(do, q, k, v, o, lse, causal, scale,
                                    k3.BWD_BOTH, **pkw)[3]
            row["dq"] = time_ms(lambda: k3.bwd_launch(
                do, q, k, v, o, lse, causal, scale, k3.BWD_DQ, **pkw))
            row["dkdv"] = time_ms(lambda: k3.bwd_launch(
                do, q, k, v, o, lse, causal, scale, k3.BWD_DKDV, scratch,
                **pkw))
        i = torch.arange(s, device="cuda")
        mask = ((i[None, :] <= i[:, None]) | (i[None, :] < prefix)) \
            if prefix else None
        qs, ks, vs = (t.transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        lib_o = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and not prefix,
            enable_gqa=True)
        do_t = do.transpose(1, 2)
        row["sdpa"] = time_ms(lambda: torch.autograd.grad(
            lib_o, (qs, ks, vs), do_t, retain_graph=True))
        if args.check:
            got = k3.flash_attention_bwd(do, q, k, v, o, lse, causal=causal,
                                         **kw)
            again = k3.flash_attention_bwd(do, q, k, v, o, lse,
                                           causal=causal, **kw)
            want = k3.flash_attention_bwd_plain(do, q, k, v, o, lse,
                                                causal=causal, **kw)
            tol = 2e-2 if dt == torch.bfloat16 else 1e-4
            errs = {}
            for gname, x, w in zip(("dq", "dk", "dv"), got, want):
                w = w.float()
                errs[gname] = float((x.float() - w).abs().max()
                                    / w.abs().max().clamp_min(1e-30))
            row["err_of_scale"] = errs
            row["within"] = all(e <= tol for e in errs.values())
            row["bitwise_twice"] = all(torch.equal(x, y)
                                       for x, y in zip(got, again))
            if not (row["within"] and row["bitwise_twice"]):
                failed.append(name)
            del got, again, want, x, w
        out["ms"][name] = row
        # nothing of this shape stays allocated into the next one's peak
        del q, k, v, do, o, lse, qs, ks, vs, lib_o, do_t, scratch
    if args.check:
        out["failed"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


def use_source(k3, src: str) -> list:
    """Builds ``src`` (a copy of the backward's source) with the source's
    nvcc flags and makes it ``k3``'s backward library; returns ptxas's
    warnings."""
    import ctypes
    import hashlib
    import subprocess

    from repro_torch.kernels import build
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = build.default_build_dir() / f"bwd_source_{tag}.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.flags(k3.BWD_SOURCE),
                           "-o", str(lib_path), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    template = k3._bwd_library()
    lib = ctypes.CDLL(str(lib_path))
    for fn in (k3.BWD_BF16, k3.BWD_F32,
               getattr(k3, "BWD_F32_TC_ENTRY", k3.BWD_F32),
               "flash_attention_bwd_error_string"):
        getattr(lib, fn).argtypes = getattr(template, fn).argtypes
        getattr(lib, fn).restype = getattr(template, fn).restype
    k3._bwd_bound = lib
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "arning" in ln]


if __name__ == "__main__":
    sys.exit(main())
