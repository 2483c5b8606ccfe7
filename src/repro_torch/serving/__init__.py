"""Serving layer: the token-serving engine and the accelerator-selection
query engine.  ``repro_torch.select`` is the documented facade for the
selection surface; import from there unless you need the internals."""

from repro_torch.serving.engine import (PROVENANCES, Request,
                                        SelectionAnswer, SelectionEngine,
                                        SelectionQuery, ServingEngine)
from repro_torch.serving.frontier_index import FrontierIndex, IndexEntry

__all__ = [
    "FrontierIndex", "IndexEntry", "PROVENANCES", "Request",
    "SelectionAnswer", "SelectionEngine", "SelectionQuery", "ServingEngine",
]
