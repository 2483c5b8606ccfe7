"""Streaming DSE campaigns: generator-backed mega-spaces, incremental Pareto
frontiers, resumable orchestration, persisted trajectory artifacts — and a
distributed fabric that shards a campaign across worker processes.

The layer between the tensor primitives (``repro_torch.core.dse`` /
``repro_torch.core.costmodel``) and the scripts that drive them: a
``SpaceSpec`` describes a 100-1000x larger space than ``dse.default_space``
without materializing it, a ``Campaign`` streams it tile-by-tile over every
workload with checkpoint/resume, and each workload's ``StreamingFrontier``
maintains a skyline provably identical to one-shot ``dse.pareto_search``.
The ``fabric`` module distributes the same sweep across ``spawn`` worker
processes — the coordinator leases tile indices, workers ship
``TileReduction`` payloads — with a frontier bitwise-identical to the
single-process run regardless of worker count, interleaving, or worker
loss; the ``chaos`` module replays seeded fault schedules against it.

``AdaptiveCampaign`` turns the sweep into a learned search: it evaluates a
seed slice exactly, fits surrogate forests on it, and spends the rest of a
bounded budget (default 10% of the space) on the tiles with the highest
expected hypervolume gain; ``run_adaptive_distributed`` farms its tiles to
a pool of fabric workers, bitwise the single-process run.

The entry points — ``Campaign``, ``TileEvaluator``, ``run_distributed``,
``AdaptiveCampaign`` and ``run_adaptive_distributed`` — construct from one
frozen ``CampaignConfig``.
"""

from repro_torch.dse_campaign.adaptive import (AdaptiveCampaign,
                                               AdaptiveResult,
                                               run_adaptive_distributed)
from repro_torch.dse_campaign.chaos import (CHAOS_KINDS, ChaosEvent,
                                            ChaosPolicy, ChaosRunner)
from repro_torch.dse_campaign.config import (EVALUATORS, AdaptiveConfig,
                                             CampaignConfig)
from repro_torch.dse_campaign.fabric import (FabricCoordinator, FakeClock,
                                             FaultInjection, LeaseBoard,
                                             LocalFabric, MultiprocessFabric,
                                             campaign_config,
                                             evaluator_from_config,
                                             run_distributed)
from repro_torch.dse_campaign.frontier import (FrontierSnapshot,
                                               StreamingFrontier,
                                               candidate_from_dict,
                                               candidate_to_dict,
                                               canonical_frontier,
                                               frontiers_identical,
                                               hypervolume_2d,
                                               hypervolume_gain_2d)
from repro_torch.dse_campaign.runner import (Campaign, CampaignResult,
                                             TileEvaluator, TileReduction,
                                             TileStat, state_from_reference)
from repro_torch.dse_campaign.space import (DEFAULT_VARIANTS, SliceVariant,
                                            SpaceSpec, default_campaign_space,
                                            tile_span, tiny_campaign_space)
from repro_torch.dse_campaign import store

__all__ = [
    "AdaptiveCampaign", "AdaptiveConfig", "AdaptiveResult",
    "CHAOS_KINDS", "Campaign", "CampaignConfig", "CampaignResult",
    "ChaosEvent", "ChaosPolicy", "ChaosRunner", "DEFAULT_VARIANTS",
    "EVALUATORS", "FabricCoordinator", "FakeClock", "FaultInjection",
    "FrontierSnapshot", "LeaseBoard", "LocalFabric", "MultiprocessFabric",
    "SliceVariant", "SpaceSpec", "StreamingFrontier", "TileEvaluator",
    "TileReduction", "TileStat", "campaign_config", "candidate_from_dict",
    "candidate_to_dict", "canonical_frontier", "default_campaign_space",
    "evaluator_from_config", "frontiers_identical", "hypervolume_2d",
    "hypervolume_gain_2d", "run_adaptive_distributed", "run_distributed",
    "state_from_reference", "store", "tile_span", "tiny_campaign_space",
]
