"""The accelerator-selection facade: ``repro_torch.select``.

The documented import surface for serving selection queries — everything a
client needs to build, persist, load and query a selection service:

    from repro_torch import select

    index = select.FrontierIndex.from_checkpoint("campaign.ckpt.json")
    index.save("frontier_index.json")

    engine = select.SelectionEngine(select.FrontierIndex.load(
        "frontier_index.json"))               # device="cuda" by default
    answer = engine.select(workload)          # -> SelectionAnswer
    answer.provenance                         # one of select.PROVENANCES
    answer.choices[0].candidate               # best accelerator config

The implementation lives in ``repro_torch.serving`` (the engine) and
``repro_torch.dse_campaign`` (the campaign stack the index is built from);
this module only re-exports the stable names, the reference package's
``repro.select`` name for name.
"""

from repro_torch.dse_campaign.config import CampaignConfig
from repro_torch.serving.engine import (PROVENANCES, RankedChoice,
                                        SelectionAnswer, SelectionEngine,
                                        SelectionQuery)
from repro_torch.serving.frontier_index import (INDEX_SCHEMA_VERSION,
                                                FrontierIndex, IndexEntry,
                                                family_key)

__all__ = [
    "CampaignConfig", "FrontierIndex", "INDEX_SCHEMA_VERSION", "IndexEntry",
    "PROVENANCES", "RankedChoice", "SelectionAnswer", "SelectionEngine",
    "SelectionQuery", "family_key",
]
