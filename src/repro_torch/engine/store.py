"""Host-side pattern stores — the engine's per-query result state.

:class:`PatternStore` dedups matched subgraphs by their (sorted) vertex
assignment; it is the only per-query piece of a serving step.
``to_arrays``/``load_arrays`` give the store an array codec, the layout of
the JAX package's engine ``state_dict`` (``Engine.load_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.graph import DynamicGraph, to_numpy


class PatternStore:
    """Host-side dedup of matched subgraphs (keyed by the vertex assignment)."""

    def __init__(self):
        self._patterns: Dict[Tuple[int, ...], Tuple[float, bool]] = {}

    def share_from(self, primary: "PatternStore") -> None:
        """Become a shared view of ``primary``: both stores reference the
        SAME pattern dict. Exact-duplicate alias stores are bitwise clones
        by construction (one device row serves the whole group, and
        ``Engine._merge`` feeds every group member identical arrays), so
        sharing the dict makes the per-alias merge fan-out O(1) per group
        instead of O(aliases) — the measured bank1024 host cost (ROADMAP).
        A store silently un-shares if :meth:`load_arrays` later rebinds its
        dict; ``Engine`` re-shares content-equal group members after load.
        """
        self._patterns = primary._patterns

    def shares_with(self, other: "PatternStore") -> bool:
        return self._patterns is other._patterns

    def merge_arrays(self, matched: np.ndarray, goodness: np.ndarray,
                     exact: np.ndarray, valid: np.ndarray,
                     q_mask: np.ndarray) -> int:
        new = 0
        qm = np.asarray(q_mask)
        for i in range(matched.shape[0]):
            if not valid[i]:
                continue
            verts = matched[i][qm]
            if (verts < 0).any():
                continue
            key = tuple(sorted(int(v) for v in verts))
            if len(set(key)) != len(key):
                continue  # degenerate (data vertex reused)
            if key not in self._patterns:
                new += 1
                self._patterns[key] = (float(goodness[i]), bool(exact[i]))
            elif goodness[i] > self._patterns[key][0]:
                self._patterns[key] = (float(goodness[i]), bool(exact[i]))
        return new

    def merge(self, res, q_mask: np.ndarray) -> int:
        """Merge a single-query single-query result."""
        return self.merge_arrays(to_numpy(res.matched),
                                 to_numpy(res.goodness),
                                 to_numpy(res.exact),
                                 to_numpy(res.valid), q_mask)

    def prune(self, node_mask: np.ndarray) -> int:
        """Drop patterns touching vertices no longer live.

        Later ``UpdateBatch``es can delete every arc of a matched vertex;
        without this hook ``n_patterns_total``/``n_exact_total`` drift upward
        on deletion-heavy streams. Invalidation is deliberately *vertex*-
        level: patterns are keyed by their vertex assignment and approximate
        matches never required the literal edge (bridges admit multi-hop
        paths), so removing a single matched arc does not falsify the
        pattern — a dead vertex does. Returns the number of patterns removed.
        """
        node_mask = np.asarray(node_mask, bool)
        dead = [key for key in self._patterns
                if any(not node_mask[v] for v in key)]
        for key in dead:
            del self._patterns[key]
        return len(dead)

    @property
    def total(self) -> int:
        return len(self._patterns)

    @property
    def exact(self) -> int:
        return sum(1 for _, e in self._patterns.values() if e)

    # -- checkpoint codec (Engine.save/load) ----------------------------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Store contents as fixed-dtype arrays (keys (N, L), N patterns of
        key length L — one query's patterns all share L)."""
        keys = sorted(self._patterns)
        length = len(keys[0]) if keys else 0
        return {
            "keys": np.asarray(keys, np.int64).reshape(len(keys), length),
            "goodness": np.asarray([self._patterns[k][0] for k in keys],
                                   np.float32),
            "exact": np.asarray([self._patterns[k][1] for k in keys], bool),
        }

    def load_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        self._patterns = {
            tuple(int(v) for v in key): (float(gd), bool(ex))
            for key, gd, ex in zip(arrays["keys"], arrays["goodness"],
                                   arrays["exact"])}


def live_vertex_mask(g: DynamicGraph) -> np.ndarray:
    """Vertices incident to at least one live arc (host-side)."""
    em = to_numpy(g.edge_mask)
    live = np.zeros(g.n_max, bool)
    live[to_numpy(g.senders)[em]] = True
    live[to_numpy(g.receivers)[em]] = True
    return live & to_numpy(g.node_mask)
