"""Public entry point of the fused campaign evaluator.

``dse_sweep`` is what ``TileEvaluator.sweep_reduced`` calls per tile: the
sweep kernel, the screen kernel and the survivor compaction in sequence on
the device the packed tile lives on, returning the host-side
``SweepReduced``.  With CUDA tensors the two hand-written kernels run (or
the call raises); with CPU tensors their plain versions do — the device of
the inputs alone decides, there is no switch and no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core import costmodel
from repro_torch.kernels import dse_sweep as _k
from repro_torch.kernels.dse_sweep import (CAND_COLS, launch_counts,
                                           reset_launch_counts)

__all__ = ["CAND_COLS", "dse_sweep", "launch_counts", "reset_launch_counts"]


def dse_sweep(cand_cols: torch.Tensor, wl_cols: torch.Tensor, *,
              sim: costmodel.SimConfig = costmodel.SimConfig(),
              constraint=None,
              max_survivors: int = 2048) -> costmodel.SweepReduced:
    """Fused on-device campaign evaluator.

    Evaluates all workload rows of ``wl_cols`` against the packed candidate
    tile ``cand_cols`` (padding lanes carry ``valid = 0``) and reduces each
    row to its screen survivors + frontier-accounting aggregates.
    ``constraint`` duck-types ``dse.Constraint`` (``max_power_w`` /
    ``max_latency_s`` / ``min_hbm_fit``).  The tensors' dtype is the
    precision tier: float64 frontiers hold the exact tier's candidate set,
    float32 is the fast tier.
    """
    kw = dict(max_power_w=None, max_latency_s=None, min_hbm_fit=True)
    if constraint is not None:
        kw = dict(max_power_w=constraint.max_power_w,
                  max_latency_s=constraint.max_latency_s,
                  min_hbm_fit=constraint.min_hbm_fit)
    e, l, feas = _k.dse_sweep(cand_cols, wl_cols, sim=sim, **kw)
    return costmodel.build_sweep_reduced(
        _k.screen_rows(e, l, feas) + (e, l, feas), int(max_survivors))
