"""Serving driver: token generation, selection queries, or index builds.

Three modes (``--mode``, default ``token``), the reference's
``repro.launch.serve`` flag for flag, on the card:

  token        batched requests through the continuous-batching engine
               python -m repro_torch.launch.serve --arch stablelm-1.6b \
                   --requests 8

  build-index  campaign checkpoint -> FrontierIndex artifact
               python -m repro_torch.launch.serve --mode build-index \
                   --checkpoint experiments/campaign.ckpt.json \
                   --out experiments/frontier_index.json

  select       answer selection queries against a FrontierIndex
               python -m repro_torch.launch.serve --mode select \
                   --index experiments/frontier_index.json \
                   [--queries queries.json]
               The queries file is a JSON list of
               ``{"workload": {...workload_to_dict...},
                  "constraint": {...} | absent, "deadline_s": float | absent}``;
               without it, every indexed family is queried as a self-check
               (all answers must come back ``index_exact``).

The functions take ``device=`` (default ``"cuda"``, which raises without a
card); the command line adds no flag for it, so it runs on the card.  The
token engine feeds every prompt token through a full [slots, 1] decode
that advances the one shared cache position, and the port's decode raises
on a full cache: ``--max-len`` must cover the run's total decode steps.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device


def serve(arch: str, n_requests: int = 8, slots: int = 4, max_len: int = 128,
          prompt_len: int = 8, max_new: int = 16, seed: int = 0,
          device: DeviceLike = DEFAULT_DEVICE):
    """``n_requests`` seeded prompts through a ``ServingEngine`` over the
    reduced ``arch`` (random weights drawn from ``seed`` on ``device``);
    returns (requests, engine stats + ``completed``, ``mean_latency_s``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine

    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = api.build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    engine = ServingEngine(model, slots=slots, max_len=max_len, device=dev)
    engine.load(params)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        rng.integers(2, prompt_len + 1)).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n_requests)]
    for r in reqs:
        engine.submit(r)
    stats = engine.run_until_drained()
    done = sum(r.done for r in reqs)
    lat = [r.finished_s - r.arrived_s for r in reqs if r.finished_s]
    stats.update(completed=done,
                 mean_latency_s=float(np.mean(lat)) if lat else 0.0)
    return reqs, stats


def build_index(checkpoint: str, out: str,
                device: DeviceLike = DEFAULT_DEVICE) -> str:
    """Campaign checkpoint of this package -> saved FrontierIndex; returns
    the path."""
    from repro_torch.serving.frontier_index import FrontierIndex

    index = FrontierIndex.from_checkpoint(checkpoint, device=device)
    path = index.save(out)
    print(f"[serve] indexed {len(index)} workload families -> {path}")
    return path


def select_queries(index_path: str, queries_path: str = None,
                   device: DeviceLike = DEFAULT_DEVICE):
    """Answer a batch of selection queries on ``device``; returns the
    answers.

    All queries are submitted before one ``flush`` — the CLI batch IS the
    batching window, so concurrent novel queries share one fused sweep.
    """
    from repro_torch.core import dse
    from repro_torch.dse_campaign.runner import workload_from_dict
    from repro_torch.serving.engine import SelectionEngine
    from repro_torch.serving.frontier_index import FrontierIndex

    index = FrontierIndex.load(index_path)
    engine = SelectionEngine(index, device=device)
    if queries_path:
        with open(queries_path) as f:
            queries = json.load(f)
        for qd in queries:
            engine.submit(
                workload_from_dict(qd["workload"]),
                constraint=(dse.Constraint(**qd["constraint"])
                            if qd.get("constraint") else None),
                deadline_s=qd.get("deadline_s"))
    else:
        for entry in index.entries:           # self-check: all index hits
            engine.submit(entry.workload)
    answers = engine.flush()
    for a in answers:
        top = a.choices[0] if a.choices else None
        pick = (f"{top.candidate.chip} x{top.candidate.n_chips} "
                f"@ {top.candidate.freq_mhz:.0f} MHz, "
                f"{top.energy_j:.3e} J / {top.latency_s:.3e} s"
                if top else "no feasible candidate")
        print(f"[serve] q{a.qid} {a.workload.arch}|{a.workload.shape} "
              f"[{a.provenance}] {pick} ({a.wall_s * 1e3:.1f} ms)")
    print(f"[serve] {engine.stats['queries']} queries: "
          + ", ".join(f"{p}={engine.stats[p]}"
                      for p in ("index_exact", "mini_campaign",
                                "predictor_only"))
          + f"; fused launches: {engine.fused_launches}")
    return answers


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("token", "select", "build-index"),
                    default="token")
    ap.add_argument("--arch", help="token mode: model architecture")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--checkpoint", help="build-index: campaign checkpoint")
    ap.add_argument("--out", help="build-index: output index path")
    ap.add_argument("--index", help="select: FrontierIndex artifact")
    ap.add_argument("--queries", help="select: JSON query batch (optional)")
    args = ap.parse_args()
    if args.mode == "build-index":
        if not (args.checkpoint and args.out):
            ap.error("--mode build-index needs --checkpoint and --out")
        build_index(args.checkpoint, args.out)
        return
    if args.mode == "select":
        if not args.index:
            ap.error("--mode select needs --index")
        select_queries(args.index, args.queries)
        return
    if not args.arch:
        ap.error("--mode token needs --arch")
    reqs, stats = serve(args.arch, n_requests=args.requests, slots=args.slots,
                        max_len=args.max_len, max_new=args.max_new)
    print(f"[serve] {stats['completed']}/{len(reqs)} done, "
          f"{stats['decoded_tokens']} tokens, {stats['tok_per_s']:.1f} tok/s, "
          f"mean latency {stats['mean_latency_s'] * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
