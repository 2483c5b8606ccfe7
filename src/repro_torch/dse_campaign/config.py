"""The one campaign configuration object.

``CampaignConfig`` is the single, frozen description of *how* to evaluate a
design space: the space itself, the evaluator tier with its ``device`` and
``dtype``, the constraint and ``SimConfig``, survivor knobs and checkpoint
policy.  ``Campaign`` and ``TileEvaluator`` construct from one of these.
Workloads are deliberately NOT part of the config: they are data (the thing
being evaluated), and the same config is reused across workload sets.

Evaluator tiers of the port, and the reference tier each reproduces:

============  =========  ====================================================
port          dtype      reference (``repro.dse_campaign``)
============  =========  ====================================================
``"torch"``   float64    ``"numpy"`` — per-workload float64 simulator, raw
                         merge; the exact oracle
``"cuda"``    float64    the fused-kernel tier run in float64 — fused
                         all-workloads launch + screen + compaction ->
                         ``merge_reduced``; same frontier candidate set as
                         the exact tier
``"cuda"``    float32    the fused float32 tiers (``"jit"`` and the compiled
                         kernel) — ~1e-6 relative
============  =========  ====================================================

``"cuda"`` names the fused path, not a device: with ``device="cuda"`` (the
default) it launches the hand-written CUDA kernels or raises; with
``device="cpu"`` — which only a caller that asks for it gets — the same
path runs the kernels' plain PyTorch versions, which is how CPU tests reach
``sweep_reduced`` / ``reduce_tile``.  ``"torch"`` is always float64.  The
predictor tier ``"fast"`` is not ported yet and is refused; the adaptive
(surrogate-steered) campaign and its ``AdaptiveConfig`` come with it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import costmodel, dse
from repro_torch.device import (DEFAULT_DEVICE, dtype_name, resolve_device,
                                resolve_dtype)
from repro_torch.dse_campaign.space import SpaceSpec

# evaluator tiers understood by TileEvaluator (see the table above)
EVALUATORS = ("torch", "cuda")

# reference evaluator name -> (port evaluator, dtype name); used when state
# written by the reference package is carried across
REFERENCE_EVALUATORS = {"numpy": ("torch", "float64"),
                        "pallas": ("cuda", "float64"),
                        "jit": ("cuda", "float32")}


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Frozen configuration shared by the campaign entry points.

    Field groups:

    * evaluation — ``space`` (the ``SpaceSpec`` to sweep; ``chunk_size``
      optionally overrides its tile size without rebuilding it),
      ``evaluator`` (one of ``EVALUATORS``), ``device`` (``"cuda"`` by
      default — resolved when the config is built, so asking for a card
      that is not there raises here, not mid-sweep), ``dtype`` (float64 or
      float32; ``"torch"`` is float64 only), ``constraint`` (``None`` means
      the default ``dse.Constraint()``), ``sim`` and ``max_survivors`` (the
      fused path's per-tile survivor capacity);
    * checkpointing — ``checkpoint_every`` (tiles between saves) and
      ``checkpoint_path`` (default path ``Campaign.run`` persists to).

    The dataclass is frozen so a config can be shared without aliasing
    surprises; use ``replace`` to derive variants.
    """

    space: SpaceSpec
    evaluator: str = "torch"
    constraint: Optional[dse.Constraint] = None
    sim: costmodel.SimConfig = costmodel.SimConfig()
    device: Any = DEFAULT_DEVICE
    dtype: Any = torch.float64
    max_survivors: int = 2048
    chunk_size: Optional[int] = None
    checkpoint_every: int = 1
    checkpoint_path: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.space, SpaceSpec):
            raise TypeError(f"CampaignConfig.space must be a SpaceSpec, got "
                            f"{type(self.space).__name__}")
        if self.evaluator == "fast":
            raise ValueError("evaluator='fast' (trained predictors) is not "
                             "ported yet; use 'torch' or 'cuda'")
        if self.evaluator not in EVALUATORS:
            raise ValueError(f"unknown evaluator {self.evaluator!r}; expected "
                             f"one of {EVALUATORS}")
        # resolve once, here: a missing card raises at construction
        object.__setattr__(self, "device", resolve_device(self.device))
        object.__setattr__(self, "dtype", resolve_dtype(self.dtype))
        if self.evaluator == "torch" and self.dtype != torch.float64:
            raise ValueError("evaluator='torch' is the exact float64 tier; "
                             "float32 runs on the fused 'cuda' evaluator")
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.max_survivors < 1:
            raise ValueError("max_survivors must be >= 1")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")

    @property
    def dtype_name(self) -> str:
        """``"float64"`` / ``"float32"`` (the checkpoint's form)."""
        return dtype_name(self.dtype)

    @property
    def resolved_space(self) -> SpaceSpec:
        """``space`` with the ``chunk_size`` override applied (if any)."""
        if self.chunk_size is None or self.chunk_size == self.space.chunk_size:
            return self.space
        return dataclasses.replace(self.space, chunk_size=self.chunk_size)

    @property
    def resolved_constraint(self) -> dse.Constraint:
        """``constraint`` with ``None`` resolved to the default."""
        return self.constraint if self.constraint is not None else dse.Constraint()

    def replace(self, **changes) -> "CampaignConfig":
        """A copy with ``changes`` applied (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)


# CampaignConfig fields each entry point also accepts as plain keywords
# beside a positional ``SpaceSpec`` (the short form used in tests / scripts)
_EVALUATOR_KEYWORDS = ("constraint", "evaluator", "sim", "device", "dtype",
                       "max_survivors")
_CAMPAIGN_KEYWORDS = _EVALUATOR_KEYWORDS + ("checkpoint_every",)


def coerce_config(owner: str, config, keywords: Dict,
                  allowed: Tuple[str, ...]) -> CampaignConfig:
    """Resolve an entry point's ``(config, **kwargs)`` into a CampaignConfig.

    ``config`` is either a ``CampaignConfig`` (any extra keyword then
    raises) or a ``SpaceSpec`` (alternatively passed as ``space=``) with the
    ``allowed`` config fields as keywords — the short form
    ``Campaign(workloads, space, evaluator=..., device=...)``.
    """
    if isinstance(config, CampaignConfig):
        if keywords:
            raise TypeError(
                f"{owner}: pass either a CampaignConfig or a SpaceSpec with "
                f"keyword arguments, not both (got {sorted(keywords)})")
        return config
    if isinstance(config, SpaceSpec):
        if "space" in keywords:
            raise TypeError(f"{owner}: space given both positionally and by "
                            "keyword")
        keywords = {"space": config, **keywords}
    elif config is not None:
        raise TypeError(
            f"{owner}: second argument must be a CampaignConfig or a "
            f"SpaceSpec, got {type(config).__name__}")
    unknown = set(keywords) - set(allowed) - {"space"}
    if unknown:
        raise TypeError(f"{owner}: unexpected keyword arguments "
                        f"{sorted(unknown)}")
    if "space" not in keywords:
        raise TypeError(f"{owner}: no space given — pass a CampaignConfig")
    return CampaignConfig(**keywords)
