"""Streaming DSE campaigns: generator-backed mega-spaces, incremental Pareto
frontiers, resumable orchestration, persisted trajectory artifacts.

The layer between the tensor primitives (``repro_torch.core.dse`` /
``repro_torch.core.costmodel``) and the scripts that drive them: a
``SpaceSpec`` describes a 100-1000x larger space than ``dse.default_space``
without materializing it, a ``Campaign`` streams it tile-by-tile over every
workload with checkpoint/resume, and each workload's ``StreamingFrontier``
maintains a skyline provably identical to one-shot ``dse.pareto_search``.

Both entry points — ``Campaign`` and ``TileEvaluator`` — construct from one
frozen ``CampaignConfig``.  Exported here is what the port carries so far;
the distributed fabric, the adaptive (surrogate-steered) campaign and the
chaos harness of the reference package have no counterpart yet.
"""

from repro_torch.dse_campaign.config import EVALUATORS, CampaignConfig
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
                                            tiny_campaign_space)
from repro_torch.dse_campaign import store

__all__ = [
    "Campaign", "CampaignConfig", "CampaignResult",
    "DEFAULT_VARIANTS", "EVALUATORS", "FrontierSnapshot", "SliceVariant",
    "SpaceSpec", "StreamingFrontier", "TileEvaluator", "TileReduction",
    "TileStat", "candidate_from_dict", "candidate_to_dict",
    "canonical_frontier", "default_campaign_space", "frontiers_identical",
    "hypervolume_2d", "hypervolume_gain_2d", "state_from_reference", "store",
    "tiny_campaign_space",
]
