"""Fanout neighbor sampler (GraphSAGE-style) for the ``minibatch_lg`` cells
(a copy of ``repro.sparse.sampler``: host numpy, so one seed gives the
reference's blocks bit for bit).

Sampling is data-pipeline work: the sampled block goes to the device as
dense int arrays with static shapes (batch_nodes, fanout1, fanout2).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class SampledBlock(NamedTuple):
    """Two-hop sampled computation block, dense/static shapes.

    seeds:   int64[B]          seed node ids
    hop1:    int64[B, F1]      sampled 1-hop neighbors (self-loop padded)
    hop2:    int64[B, F1, F2]  sampled 2-hop neighbors
    """

    seeds: np.ndarray
    hop1: np.ndarray
    hop2: np.ndarray

    def flatten_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """COO (senders, receivers) of the sampled block, receivers=local idx."""
        b, f1 = self.hop1.shape
        f2 = self.hop2.shape[2]
        s1 = self.hop1.reshape(-1)
        r1 = np.repeat(np.arange(b), f1)
        s2 = self.hop2.reshape(-1)
        r2 = np.repeat(self.hop1.reshape(-1), f2)
        return np.concatenate([s1, s2]), np.concatenate([r1, r2])


class NeighborSampler:
    def __init__(self, senders: np.ndarray, receivers: np.ndarray, n: int,
                 seed: int = 0):
        order = np.argsort(senders, kind="stable")
        self._nbrs = receivers[order]
        deg = np.bincount(senders, minlength=n)
        self._offsets = np.concatenate([[0], np.cumsum(deg)])
        self._n = n
        self._rng = np.random.default_rng(seed)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """Uniform with-replacement fanout sample; isolated → self-loops."""
        lo = self._offsets[nodes]
        hi = self._offsets[nodes + 1]
        deg = hi - lo
        u = self._rng.integers(0, np.maximum(deg, 1)[:, None],
                               size=(len(nodes), fanout))
        picked = self._nbrs[np.minimum(lo[:, None] + u, len(self._nbrs) - 1)]
        return np.where(deg[:, None] > 0, picked, nodes[:, None])

    def sample_block(self, seeds: np.ndarray, fanout1: int,
                     fanout2: int) -> SampledBlock:
        hop1 = self.sample_neighbors(seeds, fanout1)
        hop2 = self.sample_neighbors(hop1.reshape(-1), fanout2)
        return SampledBlock(seeds, hop1,
                            hop2.reshape(len(seeds), fanout1, fanout2))
