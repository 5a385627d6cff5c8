"""Induced-subgraph extraction — the 'partial' in Partial Execution Manager.

IGPM's speedup (paper §IV-D) comes from running G-Ray only on the subgraph
induced by the update-touched communities, not the full graph. We gather that
subgraph into compact buffers whose capacities are rounded up to powers of
two, so sweep cost tracks the *live* subgraph size. With ``ell_k`` set, the
extraction also emits the subgraph's incoming-adjacency ELL tile directly
from the kept-edge arrays — no COO round trip — sized to the bucket's static
row capacity. Patterns that cross community boundaries are missed — the
exact limitation the paper concedes for cycle/dense queries (§III-D).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.graph import DynamicGraph, new_graph, to_numpy
from repro_torch.sparse.ell import EllGraph, build_ell, ell_row_capacity


class Subgraph(NamedTuple):
    graph: DynamicGraph     # local-id graph (bucketed capacity)
    local_to_global: np.ndarray  # int64[n_cap] (−1 pad)
    n_nodes: int
    n_edges: int
    ell: Optional[EllGraph] = None  # incoming-adjacency ELL tile (bucketed)


def _pow2(x: int, floor: int) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(x, 1)))))


def extract_induced(g: DynamicGraph, mask: np.ndarray,
                    n_floor: int = 64, e_floor: int = 256,
                    ell_k: Optional[int] = None) -> Subgraph:
    """Induced subgraph over ``mask`` with bucketed capacities (host-side
    gather; the result lives on ``g``'s device)."""
    mask = np.asarray(mask, bool)
    senders = to_numpy(g.senders)
    receivers = to_numpy(g.receivers)
    em = to_numpy(g.edge_mask)
    labels = to_numpy(g.labels)

    ids = np.where(mask)[0]
    n_sub = len(ids)
    g2l = np.full(g.n_max, -1, np.int64)
    g2l[ids] = np.arange(n_sub)

    keep = em & mask[senders] & mask[receivers]
    ls = g2l[senders[keep]]
    lr = g2l[receivers[keep]]
    e_sub = len(ls)

    n_cap = _pow2(n_sub, n_floor)
    e_cap = _pow2(e_sub, e_floor)
    lab = np.zeros(n_cap, np.int32)
    lab[:n_sub] = labels[ids]
    sub = new_graph(n_cap, e_cap, labels=lab[:n_sub] if n_sub else None,
                    senders=ls, receivers=lr, device=g.device)
    l2g = np.full(n_cap, -1, np.int64)
    l2g[:n_sub] = ids
    ell = None
    if ell_k is not None:
        # row owner = receiver: the gather direction of the RWR/BFS sweeps
        ell = build_ell(lr, ls, n_cap, k=ell_k,
                        r_cap=ell_row_capacity(n_cap, e_cap, ell_k),
                        device=g.device)
    return Subgraph(sub, l2g, n_sub, e_sub, ell)


def remap_matched(matched: np.ndarray, local_to_global: np.ndarray) -> np.ndarray:
    """Map local matched-vertex ids back to global ids (−1 stays −1)."""
    out = np.where(matched >= 0,
                   local_to_global[np.clip(matched, 0, None)], -1)
    return out.astype(np.int64)
