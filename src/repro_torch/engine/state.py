"""EngineState + StepOutput — the functional core's explicit state.

The engine API is ``engine.step(state, update_batch) -> (state, StepOutput)``:
every quantity that evolves across serving steps and is *data* (device
tensors or plain counters) lives in :class:`EngineState` and is threaded
functionally. Host-side *caches* that are pure functions of this state (the
ELL mirror, the storm seed memo) live on the
:class:`~repro_torch.engine.core.Engine` and are rebuilt on demand.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.graph import DynamicGraph


@dataclass(frozen=True)
class EngineState:
    """One engine's evolving match state.

    graph        — the live dynamic graph (device tensors)
    r_lab        — warm-start label-RWR table of the FULL graph, kept by the
                   storm fallback (None until the first storm step)
    rlab_events  — update events applied since ``r_lab`` was refreshed (the
                   staleness key of the storm seed cache)
    rlab_version — bumped on every refresh (seed-memo identity key)
    step_idx     — serving steps taken
    """

    graph: DynamicGraph
    r_lab: Optional[torch.Tensor] = None
    rlab_events: int = 0
    rlab_version: int = 0
    step_idx: int = 0

    def evolve(self, **kw) -> "EngineState":
        return replace(self, **kw)


class QueryDelta(NamedTuple):
    """Per-standing-query result of one engine step."""

    qid: str
    name: str
    n_new: int      # patterns first seen this step
    total: int      # live patterns in the store
    exact: int      # live exact patterns


class StepOutput(NamedTuple):
    """Everything one ``engine.step`` reports (facades project subsets)."""

    step: int
    elapsed: float            # matching-pipeline time (the paper's metric)
    n_recompute: int
    frac_affected: float
    community_size: int
    rl_loss: float
    storm: bool               # full-graph fallback taken this step
    subgraph_nodes: int
    subgraph_edges: int
    ell_refresh_s: float      # ELL mirror maintenance, outside ``elapsed``
    n_pruned: int
    n_events: int             # masked update entries applied this step
    rlab_cache_hit: bool      # storm step reused r_lab without refreshing
    seed_cache_hit: bool      # storm step reused every bucket's seed top-k
    rwr_sweeps: int = 0       # label-RWR sweeps run (measured if adaptive)
    rwr_cols_skipped: int = 0  # converged-column sweeps retired (adaptive)
    deltas: Tuple[QueryDelta, ...] = ()
    # per-stage wall seconds when tracing is on (EngineConfig.obs), else None
    stage_s: Optional[Dict[str, float]] = None

    @property
    def n_new_patterns(self) -> int:
        return sum(d.n_new for d in self.deltas)
