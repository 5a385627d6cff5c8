"""Louvain community detection (Blondel et al. 2008) — PEM's clustering
sub-component (paper §III-C-2).

Control-plane code: runs host-side in numpy (cluster membership is shipped to
the device as one int array per step). The paper's usage is "repeat the
Louvain method until clusters cannot be divided further or are smaller than
the size threshold from the RL component" — that recursive subdivision is
:func:`louvain_constrained`.

A numpy copy of the JAX package's ``repro.core.louvain``; the same inputs
and seed give bitwise the same partitions and dendrogram (only the child
split of :func:`build_dendrogram` is regrouped, with identical output).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _csr(senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray,
         n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    order = np.argsort(senders, kind="stable")
    nbr = receivers[order]
    w = weights[order]
    deg = np.bincount(senders, minlength=n)
    offs = np.concatenate([[0], np.cumsum(deg)])
    return offs, nbr, w


def _one_level(offs: np.ndarray, nbr: np.ndarray, w: np.ndarray, n: int,
               resolution: float, rng: np.random.Generator,
               max_sweeps: int = 10) -> np.ndarray:
    """Phase 1: greedy local moves maximizing modularity gain."""
    comm = np.arange(n)
    k = np.zeros(n)  # weighted degree
    np.add.at(k, np.repeat(np.arange(n), np.diff(offs)), w)
    two_m = max(w.sum(), 1e-12)  # directed sum == 2m for symmetric input
    sigma_tot = k.copy()  # per-community total degree

    for _ in range(max_sweeps):
        moved = 0
        for v in rng.permutation(n):
            lo, hi = offs[v], offs[v + 1]
            if lo == hi:
                continue
            ncomm = comm[nbr[lo:hi]]
            cv = comm[v]
            # weight from v to each neighboring community
            uniq, inv = np.unique(ncomm, return_inverse=True)
            w_to = np.bincount(inv, weights=w[lo:hi])
            sigma_tot[cv] -= k[v]
            # ΔQ ∝ w_to(c) − γ·k_v·Σ_tot(c)/2m  (v removed from cv first)
            gain = w_to - resolution * k[v] * sigma_tot[uniq] / two_m
            best = uniq[int(np.argmax(gain))]
            # gain of staying put: w_to(cv) may be 0 if no neighbor shares cv
            where_cv = np.where(uniq == cv)[0]
            if len(where_cv):
                base = gain[int(where_cv[0])]
            else:
                base = -resolution * k[v] * sigma_tot[cv] / two_m
            if gain.max() > base + 1e-12 and best != cv:
                comm[v] = best
                sigma_tot[best] += k[v]
                moved += 1
            else:
                sigma_tot[cv] += k[v]
        if moved == 0:
            break
    # relabel densely
    _, comm = np.unique(comm, return_inverse=True)
    return comm


def _aggregate(senders: np.ndarray, receivers: np.ndarray,
               weights: np.ndarray, comm: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Phase 2: collapse communities into super-vertices."""
    cs, cr = comm[senders], comm[receivers]
    nc = int(comm.max()) + 1 if len(comm) else 0
    key = cs.astype(np.int64) * nc + cr
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.bincount(inv, weights=weights)
    return (uniq // nc).astype(np.int64), (uniq % nc).astype(np.int64), w, nc


def louvain(senders: np.ndarray, receivers: np.ndarray, n: int,
            weights: np.ndarray | None = None, resolution: float = 1.0,
            seed: int = 0, max_levels: int = 10) -> np.ndarray:
    """Full multi-level Louvain. Input must contain both arcs of each
    undirected edge. Returns dense community ids per vertex."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if weights is None:
        weights = np.ones(len(senders))
    rng = np.random.default_rng(seed)
    mapping = np.arange(n)
    s, r, w, nn = senders, receivers, weights.astype(np.float64), n
    for _ in range(max_levels):
        offs, nbr, wc = _csr(s, r, w, nn)
        comm = _one_level(offs, nbr, wc, nn, resolution, rng)
        nc = int(comm.max()) + 1 if len(comm) else 0
        mapping = comm[mapping]
        if nc == nn:  # no coarsening possible — converged
            break
        s, r, w, _ = _aggregate(s, r, w, comm)
        # drop self loops' effect on moves? keep (standard louvain keeps them)
        nn = nc
    return mapping


def modularity(senders: np.ndarray, receivers: np.ndarray, n: int,
               comm: np.ndarray, weights: np.ndarray | None = None,
               resolution: float = 1.0) -> float:
    if weights is None:
        weights = np.ones(len(senders), np.float64)
    two_m = max(weights.sum(), 1e-12)
    k = np.zeros(n)
    np.add.at(k, senders, weights)
    internal = weights[comm[senders] == comm[receivers]].sum()
    sig = np.bincount(comm, weights=k, minlength=int(comm.max()) + 1)
    return float(internal / two_m - resolution * np.sum((sig / two_m) ** 2))


def _split_oversized(senders: np.ndarray, receivers: np.ndarray,
                     comm: np.ndarray, max_size: int, n: int,
                     seed: int, depth: int = 0) -> np.ndarray:
    """Recursively re-run Louvain (with a resolution bump) inside oversized
    communities; fall back to balanced chunking when indivisible."""
    comm = comm.copy()
    next_id = int(comm.max()) + 1
    sizes = np.bincount(comm)
    for c in np.where(sizes > max_size)[0]:
        members = np.where(comm == c)[0]
        local = np.full(n, -1, np.int64)
        local[members] = np.arange(len(members))
        emask = (comm[senders] == c) & (comm[receivers] == c)
        ls, lr = local[senders[emask]], local[receivers[emask]]
        sub = None
        if len(ls) and depth < 8:
            sub = louvain(ls, lr, len(members),
                          resolution=1.0 + 0.5 * (depth + 1), seed=seed + depth)
            if sub.max() == 0:
                sub = None
        if sub is None:  # indivisible — balanced chunks (paper: "cannot be
            # divided further"); chunking preserves the ≤max_size contract
            sub = np.arange(len(members)) // max_size
        sub_sizes = np.bincount(sub)
        if (sub_sizes > max_size).any():
            # recurse into sub-communities
            sub = _split_oversized(ls, lr, sub, max_size, len(members),
                                   seed + 1, depth + 1)
        comm[members] = next_id + sub
        next_id += int(sub.max()) + 1
    _, dense = np.unique(comm, return_inverse=True)
    return dense


def louvain_constrained(senders: np.ndarray, receivers: np.ndarray, n: int,
                        max_size: int, weights: np.ndarray | None = None,
                        seed: int = 0) -> np.ndarray:
    """Paper §III-C: repeat Louvain until every community ≤ ``max_size``."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    comm = louvain(senders, receivers, n, weights=weights, seed=seed)
    return _split_oversized(senders, receivers, comm, max(1, max_size), n, seed)


class Dendrogram:
    """Recursive-Louvain split tree, cuttable at ANY size threshold in
    O(n·depth) — PEM's ±1 community-size actions then cost a table lookup
    instead of a full recluster (beyond-paper optimization; EXPERIMENTS.md
    §Perf logs the win).

    ``path_ids[v, d]`` / ``path_sizes[v, d]``: the community id / size of v's
    ancestor at depth d (root = whole graph at d=0); rows are padded by
    repeating the leaf entry, so sizes are non-increasing along each row.
    """

    def __init__(self, path_ids: np.ndarray, path_sizes: np.ndarray,
                 n_edges_at_build: int):
        self.path_ids = path_ids
        self.path_sizes = path_sizes
        self.n_edges_at_build = n_edges_at_build

    def cut(self, max_size: int) -> np.ndarray:
        """Membership whose every community has size ≤ max_size (or is a
        leaf). Picks the shallowest ancestor satisfying the bound."""
        ok = self.path_sizes <= max_size
        # argmax returns the FIRST True along the row; rows with no True
        # (c < leaf size) fall back to the leaf (last column)
        first = np.argmax(ok, axis=1)
        none = ~ok.any(axis=1)
        first[none] = self.path_ids.shape[1] - 1
        comm = self.path_ids[np.arange(len(first)), first]
        _, dense = np.unique(comm, return_inverse=True)
        return dense


def build_dendrogram(senders: np.ndarray, receivers: np.ndarray, n: int,
                     min_size: int = 2, seed: int = 0,
                     max_depth: int = 32) -> Dendrogram:
    """Recursively split the graph with Louvain (resolution bump per level,
    balanced chunking for indivisible communities) down to ``min_size``."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    paths: list = [[] for _ in range(n)]  # (node_id, size) chain per vertex

    counter = [0]

    def record(members: np.ndarray) -> None:
        nid = counter[0]
        counter[0] += 1
        for v in members:
            paths[v].append((nid, len(members)))

    def rec(ls: np.ndarray, lr: np.ndarray, members: np.ndarray,
            depth: int) -> None:
        record(members)
        if len(members) <= min_size or depth >= max_depth:
            return
        sub = None
        if len(ls):
            sub = louvain(ls, lr, len(members),
                          resolution=1.0 + 0.4 * depth, seed=seed + depth)
            if int(sub.max()) == 0:
                sub = None
        if sub is None:
            sub = np.arange(len(members)) // max(min_size, len(members) // 2)
        # split into the children in one grouping pass: child c gets its
        # members in their current order (local ids 0..size-1) and its
        # internal edges in their current order. Grouping by a stable sort
        # costs O(members + edges) per level instead of per child — the
        # isolated capacity vertices of a large graph become hundreds of
        # thousands of singleton children.
        n_sub = int(sub.max()) + 1
        order = np.argsort(sub, kind="stable")
        bounds = np.searchsorted(sub[order], np.arange(n_sub + 1))
        local = np.empty(len(members), np.int64)
        local[order] = np.arange(len(members)) - bounds[sub[order]]
        cs = sub[ls]
        e_idx = np.nonzero(cs == sub[lr])[0]
        e_child = cs[e_idx]
        e_order = np.argsort(e_child, kind="stable")
        e_sorted = e_idx[e_order]
        e_bounds = np.searchsorted(e_child[e_order], np.arange(n_sub + 1))
        for c in range(n_sub):
            child = members[order[bounds[c]:bounds[c + 1]]]
            ei = e_sorted[e_bounds[c]:e_bounds[c + 1]]
            rec(local[ls[ei]], local[lr[ei]], child, depth + 1)

    rec(senders, receivers, np.arange(n), 0)
    depth = max(len(p) for p in paths) if paths else 1
    path_ids = np.zeros((n, depth), np.int64)
    path_sizes = np.zeros((n, depth), np.int64)
    for v, chain in enumerate(paths):
        for d in range(depth):
            nid, sz = chain[min(d, len(chain) - 1)]
            path_ids[v, d] = nid
            path_sizes[v, d] = sz
    return Dendrogram(path_ids, path_sizes, len(senders))
