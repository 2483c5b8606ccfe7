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
``"fast"``    float64    ``"fast"`` — the trained predictors
                         (``power_model`` / ``cycles_model``, which predict on
                         their own device) through ``dse.predict_space``
============  =========  ====================================================

``"cuda"`` names the fused path, not a device: with ``device="cuda"`` (the
default) it launches the hand-written CUDA kernels or raises; with
``device="cpu"`` — which only a caller that asks for it gets — the same
path runs the kernels' plain PyTorch versions, which is how CPU tests reach
``sweep_reduced`` / ``reduce_tile``.  ``"torch"`` and ``"fast"`` are always
float64.  ``AdaptiveConfig`` holds the knobs of the surrogate-steered
campaign (``adaptive.AdaptiveCampaign``); a config without one is an exact
sweep.
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
EVALUATORS = ("torch", "cuda", "fast")

# reference evaluator name -> (port evaluator, dtype name); used when state
# written by the reference package is carried across
REFERENCE_EVALUATORS = {"numpy": ("torch", "float64"),
                        "pallas": ("cuda", "float64"),
                        "jit": ("cuda", "float32")}


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the surrogate-guided adaptive campaign (``adaptive.py``), the
    reference's field for field.

    Budgets are fractions of the space's candidate count, rounded up to
    whole tiles: ``seed_fraction`` is evaluated exactly up front (evenly
    spaced tiles, so the surrogates see every region of the space),
    ``round_fraction`` is evaluated per acquisition round, and the loop
    hard-stops once ``budget_fraction`` has been spent.  ``budget_fraction
    >= 1`` short-circuits to the exact sweep (bitwise identical — the
    degenerate-mode gate).

    Acquisition = expected hypervolume gain against the frontier's
    pinned-ref proxy, computed from LCB-optimistic surrogate predictions
    (``exp(mu - explore_weight * sigma)``, sigma = per-tree forest spread),
    with predicted-infeasible candidates screened out.  The loop stops
    early once the frontier hypervolume has improved by less than
    ``plateau_tol`` (relative) for ``plateau_rounds`` consecutive rounds.

    ``train_sample`` rows per (workload, tile) are subsampled for surrogate
    training (seeded by tile index, so any evaluation order yields the same
    rows); ``n_trees`` / ``refresh_trees`` / ``max_depth`` / ``min_leaf``
    size the per-target forests — smaller than the offline predictors
    because they are refit every round.
    """

    budget_fraction: float = 0.10
    seed_fraction: float = 0.04
    round_fraction: float = 0.01
    explore_weight: float = 1.0
    plateau_rounds: int = 2
    plateau_tol: float = 1e-3
    train_sample: int = 64
    n_trees: int = 16
    refresh_trees: int = 8
    max_depth: int = 10
    min_leaf: int = 4
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.budget_fraction <= 1.0:
            raise ValueError("budget_fraction must be in (0, 1]")
        if not 0.0 < self.seed_fraction:
            raise ValueError("seed_fraction must be > 0")
        if not 0.0 < self.round_fraction:
            raise ValueError("round_fraction must be > 0")
        if self.explore_weight < 0.0:
            raise ValueError("explore_weight must be >= 0")
        if self.plateau_rounds < 1:
            raise ValueError("plateau_rounds must be >= 1")
        if self.plateau_tol < 0.0:
            raise ValueError("plateau_tol must be >= 0")
        if self.train_sample < 1:
            raise ValueError("train_sample must be >= 1")
        if self.n_trees < 1 or self.refresh_trees < 1:
            raise ValueError("n_trees and refresh_trees must be >= 1")
        if self.refresh_trees > self.n_trees:
            raise ValueError("refresh_trees must be <= n_trees")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AdaptiveConfig":
        return cls(**d)


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
      the default ``dse.Constraint()``), ``sim``, ``max_survivors`` (the
      fused path's per-tile survivor capacity) and the fitted
      ``power_model`` / ``cycles_model`` the ``"fast"`` evaluator needs
      (never checkpointed: they must be re-passed on resume);
    * checkpointing — ``checkpoint_every`` (tiles between saves) and
      ``checkpoint_path`` (default path ``Campaign.run`` persists to);
    * fabric — ``n_workers`` / ``lease_timeout_s`` for
      ``fabric.run_distributed`` and ``adaptive.run_adaptive_distributed``;
    * adaptive — an optional ``AdaptiveConfig`` enabling the
      surrogate-guided campaign mode (``adaptive.AdaptiveCampaign``);
      ``None`` (the default) keeps every entry point on the exact sweep.

    The dataclass is frozen so a config can be shared without aliasing
    surprises; use ``replace`` to derive variants.
    """

    space: SpaceSpec
    evaluator: str = "torch"
    constraint: Optional[dse.Constraint] = None
    sim: costmodel.SimConfig = costmodel.SimConfig()
    device: Any = DEFAULT_DEVICE
    dtype: Any = torch.float64
    power_model: Any = None
    cycles_model: Any = None
    max_survivors: int = 2048
    chunk_size: Optional[int] = None
    checkpoint_every: int = 1
    checkpoint_path: Optional[str] = None
    n_workers: int = 2
    lease_timeout_s: float = 300.0
    adaptive: Optional[AdaptiveConfig] = None

    def __post_init__(self):
        if self.adaptive is not None and not isinstance(self.adaptive,
                                                        AdaptiveConfig):
            raise TypeError(
                f"CampaignConfig.adaptive must be an AdaptiveConfig, got "
                f"{type(self.adaptive).__name__}")
        if not isinstance(self.space, SpaceSpec):
            raise TypeError(f"CampaignConfig.space must be a SpaceSpec, got "
                            f"{type(self.space).__name__}")
        if self.evaluator not in EVALUATORS:
            raise ValueError(f"unknown evaluator {self.evaluator!r}; expected "
                             f"one of {EVALUATORS}")
        if self.evaluator == "fast" and (self.power_model is None
                                         or self.cycles_model is None):
            raise ValueError("evaluator='fast' needs fitted power_model and "
                             "cycles_model")
        # resolve once, here: a missing card raises at construction
        object.__setattr__(self, "device", resolve_device(self.device))
        object.__setattr__(self, "dtype", resolve_dtype(self.dtype))
        if self.evaluator in ("torch", "fast") and self.dtype != torch.float64:
            raise ValueError(f"evaluator={self.evaluator!r} is a float64 "
                             "tier; float32 runs on the fused 'cuda' "
                             "evaluator")
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.max_survivors < 1:
            raise ValueError("max_survivors must be >= 1")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.n_workers < 1:
            raise ValueError("n_workers must be >= 1")

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
