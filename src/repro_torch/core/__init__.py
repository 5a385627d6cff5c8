"""IGPM core: dynamic graph, RWR, queries, G-Ray bank matcher, PEM.

The JAX package's ``repro.core`` re-exports, except ``rwr`` and
``louvain``: re-exported here those functions would shadow their own
submodules (``import repro_torch.core.rwr as m`` would bind the function).
"""
# The paper's primary contribution: IGPM (incremental G-Ray) + PEM
# (Louvain clustering gated by a DQN).
from repro_torch.core.graph import (DynamicGraph, UpdateBatch, add_edges,
                                    apply_update, new_graph, remove_edges,
                                    set_labels)
from repro_torch.core.query import (Query, QueryBank, clique4, query_zoo,
                                    square, stack_queries, star5, triangle)
from repro_torch.core.rwr import label_rwr
from repro_torch.core.gray import (BankGRayMatcher, GRayMatcher, GRayResult,
                                   gray_match)
from repro_torch.core.louvain import louvain_constrained
from repro_torch.core.dqn import DQNAgent
from repro_torch.core.pem import PartialExecutionManager

# The matcher facades import repro_torch.engine, whose modules import back
# into repro_torch.core.* submodules (running THIS __init__ first), so they
# are re-exported lazily (PEP 562) and either package may initialize first.
_MATCHER_EXPORTS = ("AdaptiveMatcher", "BatchMatcher",
                    "NaiveIncrementalMatcher")


def __getattr__(name):
    if name in _MATCHER_EXPORTS:
        from repro_torch.core import matcher
        return getattr(matcher, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DynamicGraph", "UpdateBatch", "new_graph", "add_edges", "remove_edges",
    "set_labels", "apply_update",
    "Query", "QueryBank", "stack_queries", "query_zoo",
    "triangle", "square", "star5", "clique4",
    "label_rwr",
    "GRayResult", "GRayMatcher", "BankGRayMatcher", "gray_match",
    "louvain_constrained",
    "DQNAgent",
    "PartialExecutionManager",
    "BatchMatcher", "NaiveIncrementalMatcher", "AdaptiveMatcher",
]
