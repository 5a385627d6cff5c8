"""PEM — Partial Execution Manager (paper §III-C), non-adaptive mode.

Chooses the vertex set IGPM recomputes each step:

  1. the graph is partitioned by constrained Louvain into communities no
     larger than the threshold ``c``;
  2. every community touched by the step's updates contributes ALL of its
     vertices to the recompute set (paper §III-C-1).

The paper's third part — a DQN moving ``c`` by ±1 per step — is the
adaptive mode (IGPM-PEM). It is not ported yet: ``adaptive=True`` raises.
With ``adaptive=False`` this is the paper's naive incremental matcher (Inc):
``c`` stays at ``init_community_size``.

Partitions are cached per ``c`` value on a Louvain split dendrogram that is
rebuilt only when the live edge count grows beyond ``recluster_growth``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.config.base import IGPMConfig
from repro_torch.core.graph import DynamicGraph, to_numpy
from repro_torch.core.louvain import Dendrogram, build_dendrogram


class PartialExecutionManager:
    def __init__(self, cfg: IGPMConfig, adaptive: bool = True, seed: int = 0,
                 recluster_growth: float = 0.2):
        if adaptive:
            raise NotImplementedError(
                "adaptive PEM (the DQN-driven community size, core/dqn.py) is "
                "not ported yet — see ROADMAP.md queue 1, 'core/dqn.py + "
                "adaptive PEM'; use adaptive=False (the Inc matcher)")
        self.cfg = cfg
        self.adaptive = adaptive
        self.seed = seed
        self.c = int(cfg.init_community_size)
        self.agent = None
        self.recluster_growth = recluster_growth
        self._dendro: Optional[Dendrogram] = None
        # per-dendrogram cut cache: c → (comm array, n_comm)
        self._cuts: Dict[int, Tuple[np.ndarray, int]] = {}
        self.recluster_count = 0
        self.clustering_time = 0.0

    # -- clustering ----------------------------------------------------------

    def reset_clustering(self) -> None:
        """Drop the dendrogram so the next ``communities`` call rebuilds it.

        The dendrogram is stale-TOLERANT (rebuilt only on 1+growth edge
        increase), so it is results-affecting state; a restored state must
        drop it to behave like a fresh process.
        """
        self._dendro = None
        self._cuts = {}

    def communities(self, g: DynamicGraph) -> Tuple[np.ndarray, int]:
        """Constrained-Louvain membership for the current threshold ``c``.

        The split dendrogram is rebuilt only when the live edge count grows
        past ``recluster_growth``; any threshold is then an O(n·depth) cut.
        """
        em = to_numpy(g.edge_mask)
        n_live_edges = int(em.sum())
        if (self._dendro is None
                or n_live_edges > self._dendro.n_edges_at_build
                * (1 + self.recluster_growth)):
            s = to_numpy(g.senders)
            r = to_numpy(g.receivers)
            t0 = time.perf_counter()
            self._dendro = build_dendrogram(
                s[em], r[em], g.n_max,
                min_size=self.cfg.min_community_size, seed=self.seed)
            self.clustering_time += time.perf_counter() - t0
            self._cuts = {}
            self.recluster_count += 1
        if self.c not in self._cuts:
            comm = self._dendro.cut(self.c)
            self._cuts[self.c] = (comm, int(comm.max()) + 1 if len(comm) else 0)
        return self._cuts[self.c]

    # -- recompute-set extraction (paper §III-C-1) ----------------------------

    def recompute_mask(self, g: DynamicGraph,
                       updated: np.ndarray) -> Tuple[np.ndarray, float]:
        """All vertices of every community containing an updated vertex.

        Returns (mask bool[n_max], fraction of communities affected).
        """
        comm, n_comm = self.communities(g)
        updated = np.asarray(updated, np.int64)
        updated = updated[updated >= 0]
        if len(updated) == 0:
            return np.zeros(g.n_max, bool), 0.0
        touched = np.unique(comm[updated])
        mask = np.isin(comm, touched) & to_numpy(g.node_mask)
        frac = len(touched) / max(n_comm, 1)
        return mask, frac

    def feedback(self, g: DynamicGraph, frac_affected: float,
                 elapsed: float) -> Tuple[int, float]:
        """The RL hook of the step loop: a no-op in non-adaptive mode.
        Returns (c, TD loss)."""
        return self.c, 0.0
