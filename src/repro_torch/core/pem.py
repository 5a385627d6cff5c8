"""PEM — Partial Execution Manager (paper §III-C).

Chooses the vertex set IGPM recomputes each step:

  1. the graph is partitioned by constrained Louvain into communities no
     larger than the threshold ``c``;
  2. every community touched by the step's updates contributes ALL of its
     vertices to the recompute set (paper §III-C-1);
  3. with ``adaptive=True`` (IGPM-PEM) a DQN adjusts ``c`` (±1 per step,
     paper Fig. 3 lines 7-12) from a 2-d observation (graph density,
     fraction of affected communities) with reward 1/elapsed-time. With
     ``adaptive=False`` this is the paper's naive incremental matcher
     (Inc): ``c`` stays at ``init_community_size``.

Partitions are cached per ``c`` value on a Louvain split dendrogram that is
rebuilt only when the live edge count grows beyond ``recluster_growth`` —
the paper reclusters every step; cache semantics are identical whenever the
graph is unchanged. The DQN agent lives on the device the caller names (the
engine's); the Louvain build and cuts are host numpy.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.config.base import IGPMConfig
from repro_torch.core.dqn import DQNAgent, Transition
from repro_torch.core.graph import DynamicGraph, to_numpy
from repro_torch.core.louvain import Dendrogram, build_dendrogram


class PartialExecutionManager:
    def __init__(self, cfg: IGPMConfig, adaptive: bool = True, seed: int = 0,
                 recluster_growth: float = 0.2, device="cuda"):
        self.cfg = cfg
        self.adaptive = adaptive
        self.seed = seed
        self.c = int(cfg.init_community_size)
        self.agent: Optional[DQNAgent] = (
            DQNAgent(cfg, seed, device=device) if adaptive else None)
        self.recluster_growth = recluster_growth
        self._dendro: Optional[Dendrogram] = None
        # per-dendrogram cut cache: c → (comm array, n_comm)
        self._cuts: Dict[int, Tuple[np.ndarray, int]] = {}
        self._last_obs: Optional[np.ndarray] = None
        self._last_action: Optional[int] = None
        self._reward_ema: Optional[float] = None
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
        # counted on the graph's device: the arrays come to the host only
        # when the dendrogram is rebuilt
        n_live_edges = int(g.edge_mask.sum())
        if (self._dendro is None
                or n_live_edges > self._dendro.n_edges_at_build
                * (1 + self.recluster_growth)):
            em = to_numpy(g.edge_mask)
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

    # -- RL feedback loop (paper Fig. 3 lines 7-12) ---------------------------

    def observation(self, g: DynamicGraph, frac_affected: float) -> np.ndarray:
        """(density / 10, fraction of communities affected). The live
        counts are summed on the graph's device: two scalars come back, not
        the masks."""
        n_nodes = max(float(int(g.node_mask.sum())), 1.0)
        n_edges = float(int(g.edge_mask.sum()))
        density = n_edges / n_nodes
        return np.array([density / 10.0, frac_affected], np.float32)

    def feedback(self, g: DynamicGraph, frac_affected: float,
                 elapsed: float) -> Tuple[int, float]:
        """Reward the agent with 1/t and apply its ±1 action to ``c``.

        Returns (new c, TD loss). No-op in non-adaptive (naive) mode.
        """
        if not self.adaptive:
            return self.c, 0.0
        obs = self.observation(g, frac_affected)
        loss = 0.0
        if self._last_obs is not None:
            # paper: reward = 1/t, normalized by a running mean so the
            # reward scale does not depend on the absolute step time
            raw = 1.0 / max(elapsed, 1e-6)
            if self._reward_ema is None:
                self._reward_ema = raw
            self._reward_ema = 0.9 * self._reward_ema + 0.1 * raw
            reward = raw / max(self._reward_ema, 1e-9)
            loss = self.agent.observe(Transition(
                self._last_obs, self._last_action, reward, obs, False))
        action = self.agent.act(obs)
        # paper: y==0 → c−1 else c+1
        self.c = int(np.clip(self.c + (1 if action else -1),
                             self.cfg.min_community_size,
                             self.cfg.max_community_size))
        self._last_obs, self._last_action = obs, action
        return self.c, loss
