"""Streaming DSE campaigns: generator-backed mega-spaces, incremental Pareto
frontiers, resumable orchestration, persisted trajectory artifacts.

The layer between the tensor primitives (``repro_torch.core.dse`` /
``repro_torch.core.costmodel``) and the scripts that drive them: a
``SpaceSpec`` describes a 100-1000x larger space than ``dse.default_space``
without materializing it, a ``Campaign`` streams it tile-by-tile over every
workload with checkpoint/resume, and each workload's ``StreamingFrontier``
maintains a skyline provably identical to one-shot ``dse.pareto_search``.

``AdaptiveCampaign`` turns the sweep into a learned search: it evaluates a
seed slice exactly, fits surrogate forests on it, and spends the rest of a
bounded budget (default 10% of the space) on the tiles with the highest
expected hypervolume gain.

The entry points — ``Campaign``, ``TileEvaluator`` and ``AdaptiveCampaign``
— construct from one frozen ``CampaignConfig``.  Exported here is what the
port carries so far; the distributed fabric (and with it the distributed
adaptive runner) and the chaos harness of the reference package have no
counterpart yet.
"""

from repro_torch.dse_campaign.adaptive import AdaptiveCampaign, AdaptiveResult
from repro_torch.dse_campaign.config import (EVALUATORS, AdaptiveConfig,
                                             CampaignConfig)
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
    "Campaign", "CampaignConfig", "CampaignResult",
    "DEFAULT_VARIANTS", "EVALUATORS", "FrontierSnapshot", "SliceVariant",
    "SpaceSpec", "StreamingFrontier", "TileEvaluator", "TileReduction",
    "TileStat", "candidate_from_dict", "candidate_to_dict",
    "canonical_frontier", "default_campaign_space", "frontiers_identical",
    "hypervolume_2d", "hypervolume_gain_2d", "state_from_reference", "store",
    "tile_span", "tiny_campaign_space",
]
