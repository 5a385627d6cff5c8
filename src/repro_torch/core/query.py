"""Query pattern graphs (paper §IV-C): triangle, square, star-5, clique-4.

Query and bank tensors are small host-built int/bool tensors (CPU unless a
bank is moved to a device); every function here is host-side.

A query is padded to ``q_max`` vertices. The G-Ray expansion order is a
host-precomputed BFS spanning tree from the anchor vertex (highest-degree
query vertex — the paper notes hubs make the best seeds), followed by the
non-tree edges which are verified/bridged between already-matched vertices.

For continuous serving many standing queries are evaluated against one
update stream, so :func:`stack_queries` re-pads a heterogeneous set of
queries to a common ``(q_max, qe_max)`` and stacks them into a
:class:`QueryBank` — one device array per field with a leading query axis
that the bank matcher batches over.

Overlapping standing queries share *sub-patterns*: every BFS-schedule
prefix of a query is itself a pattern, and two queries whose prefixes
canonicalize identically expand through bitwise-identical partial
matches. :func:`decompose` compiles a query into its canonical
:class:`SubPatternKey` path and :class:`PlanDAG` refcounts the distinct
nodes across a bank — the host-side half of the shared sub-pattern tables
in :class:`~repro_torch.core.gray.BankGRayMatcher`.
"""

from __future__ import annotations

import heapq
import hashlib

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Query(NamedTuple):
    labels: torch.Tensor      # int32[q_max]
    mask: torch.Tensor        # bool[q_max]
    # expansion schedule: rows (qa, qb, is_tree); padded rows masked
    order_src: torch.Tensor   # int32[qe_max]
    order_dst: torch.Tensor   # int32[qe_max]
    order_tree: torch.Tensor  # bool[qe_max]
    order_mask: torch.Tensor  # bool[qe_max]
    anchor: torch.Tensor      # int32 scalar — seed query vertex
    name: str = "query"

    @property
    def q_max(self) -> int:
        return self.labels.shape[0]

    @property
    def n_nodes(self) -> int:
        return int(_np(self.mask).sum())

    @property
    def n_edges(self) -> int:
        return int(_np(self.order_mask).sum())


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def build_query(edges: List[Tuple[int, int]], labels: List[int],
                q_max: int = 8, qe_max: int = 16, name: str = "query") -> Query:
    """Host-side query compiler: BFS schedule from the highest-degree vertex."""
    q = len(labels)
    assert q <= q_max
    deg = np.zeros(q, np.int64)
    adj = [[] for _ in range(q)]
    eset = set()
    for a, b in edges:
        if (a, b) in eset or (b, a) in eset:
            continue
        eset.add((a, b))
        adj[a].append(b)
        adj[b].append(a)
        deg[a] += 1
        deg[b] += 1
    anchor = int(np.argmax(deg))
    # BFS spanning tree
    seen = {anchor}
    frontier = [anchor]
    tree: List[Tuple[int, int]] = []
    while frontier:
        nxt = []
        for u in frontier:
            for v in sorted(adj[u]):
                if v not in seen:
                    seen.add(v)
                    tree.append((u, v))
                    nxt.append(v)
        frontier = nxt
    assert len(seen) == q, "query must be connected"
    tree_set = {frozenset(e) for e in tree}
    rest = [e for e in eset if frozenset(e) not in tree_set]
    sched = [(a, b, True) for a, b in tree] + [(a, b, False) for a, b in rest]
    assert len(sched) <= qe_max

    lab = np.zeros(q_max, np.int32)
    lab[:q] = labels
    mask = np.arange(q_max) < q
    osrc = np.zeros(qe_max, np.int32)
    odst = np.zeros(qe_max, np.int32)
    otree = np.zeros(qe_max, bool)
    omask = np.zeros(qe_max, bool)
    for i, (a, b, t) in enumerate(sched):
        osrc[i], odst[i], otree[i], omask[i] = a, b, t, True
    return Query(torch.as_tensor(lab), torch.as_tensor(mask),
                 torch.as_tensor(osrc), torch.as_tensor(odst),
                 torch.as_tensor(otree), torch.as_tensor(omask),
                 torch.tensor(anchor, dtype=torch.int32), name)


class QueryBank(NamedTuple):
    """A stack of standing queries padded to one ``(q_max, qe_max)`` shape.

    Every field of :class:`Query` gains a leading query axis ``B``; the bank
    matcher batches its expansion over that axis while sharing the per-step
    sweeps . ``names`` is host metadata.
    """

    labels: torch.Tensor      # int32[B, q_max]
    mask: torch.Tensor        # bool[B, q_max]
    order_src: torch.Tensor   # int32[B, qe_max]
    order_dst: torch.Tensor   # int32[B, qe_max]
    order_tree: torch.Tensor  # bool[B, qe_max]
    order_mask: torch.Tensor  # bool[B, qe_max]
    anchor: torch.Tensor      # int32[B]
    names: Tuple[str, ...] = ()

    @property
    def n_queries(self) -> int:
        return self.labels.shape[0]

    @property
    def q_max(self) -> int:
        return self.labels.shape[1]

    @property
    def qe_max(self) -> int:
        return self.order_src.shape[1]

    def query(self, i: int) -> Query:
        """Unstack query ``i`` (the single-query view of one bank row)."""
        return Query(self.labels[i], self.mask[i], self.order_src[i],
                     self.order_dst[i], self.order_tree[i],
                     self.order_mask[i], self.anchor[i],
                     self.names[i] if i < len(self.names) else f"q{i}")


def _repad(a: np.ndarray, width: int) -> np.ndarray:
    out = np.zeros(width, a.dtype)
    out[: len(a)] = a
    return out


def stack_queries(queries: Sequence[Query], q_max: Optional[int] = None,
                  qe_max: Optional[int] = None) -> QueryBank:
    """Stack queries into a :class:`QueryBank`, re-padding each to the
    common ``q_max``/``qe_max`` (defaults: the max over the bank)."""
    if not queries:
        raise ValueError("cannot stack an empty query bank")
    n_nodes = [q.n_nodes for q in queries]
    n_edges = [q.n_edges for q in queries]
    q_max = q_max or max(max(n_nodes), 1)
    qe_max = qe_max or max(max(n_edges), 1)
    if max(n_nodes) > q_max:
        raise ValueError(f"q_max {q_max} < largest query ({max(n_nodes)})")
    if max(n_edges) > qe_max:
        raise ValueError(f"qe_max {qe_max} < longest schedule "
                         f"({max(n_edges)})")
    fields = {k: [] for k in ("labels", "mask", "order_src", "order_dst",
                              "order_tree", "order_mask")}
    anchors = []
    for q, nn, ne in zip(queries, n_nodes, n_edges):
        fields["labels"].append(_repad(_np(q.labels)[:nn], q_max))
        fields["mask"].append(_repad(_np(q.mask)[:nn], q_max))
        fields["order_src"].append(_repad(_np(q.order_src)[:ne],
                                          qe_max))
        fields["order_dst"].append(_repad(_np(q.order_dst)[:ne],
                                          qe_max))
        fields["order_tree"].append(_repad(_np(q.order_tree)[:ne],
                                           qe_max))
        fields["order_mask"].append(_repad(_np(q.order_mask)[:ne],
                                           qe_max))
        anchors.append(int(q.anchor))
    return QueryBank(
        **{k: torch.as_tensor(np.stack(v)) for k, v in fields.items()},
        anchor=torch.as_tensor(np.asarray(anchors, np.int32)),
        names=tuple(q.name for q in queries))


# -- shared sub-pattern decomposition --------------------------


def query_signature(query: Query) -> Tuple:
    """Exact content signature of a query's device tensors (name excluded).

    Two queries with equal signatures produce bitwise-identical bank rows
    under any common re-padding — the dedup key for the engine's exact-
    duplicate fast path. Padding is stripped first, so the signature is
    invariant to the ``q_max``/``qe_max`` a query was built with.
    """
    nn, ne = query.n_nodes, query.n_edges
    return (nn, ne, int(query.anchor),
            _np(query.labels)[:nn].tobytes(),
            _np(query.order_src)[:ne].tobytes(),
            _np(query.order_dst)[:ne].tobytes(),
            _np(query.order_tree)[:ne].tobytes())


class SubPatternKey(NamedTuple):
    """Canonical signature of one BFS-schedule prefix.

    ``seed`` pins everything the seed-finder and expansion read
    *positionally* — the padded label vector, live mask and anchor index.
    (The seed score sums ``log r_lab`` over query-vertex positions, so
    float addition order makes label-multiset equality insufficient:
    sharing requires exact positional equality.) ``prefix`` is the
    canonical tree-edge sequence up to this node: the ``j``-th tree step
    matches canonical vertex ``j+1`` (anchor = 0), recorded as
    ``(canonical source id, destination label)``. Non-tree steps never
    extend the matched set, so they are excluded — queries differing only
    in their verification edges share their whole expansion path.
    """

    seed: Tuple
    prefix: Tuple[Tuple[int, int], ...]

    @property
    def depth(self) -> int:
        return len(self.prefix)

    def digest(self) -> int:
        """Stable 63-bit content hash (checkpoint round-trip guard)."""
        h = hashlib.blake2b(repr(self).encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") >> 1


def decompose(query: Query) -> List[SubPatternKey]:
    """Compile a query to its path of canonical sub-pattern nodes.

    Node ``j`` is the prefix pattern whose last matched vertex is
    canonical vertex ``j`` (node 0 = the seeded anchor); a query with
    ``T`` tree steps yields ``T + 1`` nodes. Every schedule step *reads*
    the expansion tables of the node that matched its source vertex —
    :func:`schedule_reads` maps steps to indices into this list.
    """
    return _decompose(query)[0]


def schedule_reads(query: Query) -> np.ndarray:
    """``int32[qe_max]``: per schedule step, the index into
    ``decompose(query)`` of the node whose tables the step reads
    (0 for masked padding steps — the matcher masks those reads)."""
    return _decompose(query)[1]


def _decompose(query: Query) -> Tuple[List[SubPatternKey], np.ndarray]:
    lab = _np(query.labels)
    msk = _np(query.mask)
    osrc = _np(query.order_src)
    odst = _np(query.order_dst)
    otree = _np(query.order_tree)
    omask = _np(query.order_mask)
    # strip the seed to the REAL vertices (padding-invariant, like
    # query_signature): padded positions contribute an exact 0.0 to the
    # seed score (logp * mask 0) whatever the pad labels hold, so equal
    # stripped seeds score bitwise-identically inside any one bucket
    nn = int(msk.sum())
    seed = (tuple(int(x) for x in lab[:nn]), tuple(bool(x) for x in msk[:nn]),
            int(query.anchor))
    canon: Dict[int, int] = {int(query.anchor): 0}
    prefix: List[Tuple[int, int]] = []
    keys = [SubPatternKey(seed, ())]
    reads = np.zeros(osrc.shape[0], np.int32)
    for ei in range(osrc.shape[0]):
        if not omask[ei]:
            continue
        src = int(osrc[ei])
        assert src in canon, "schedule source must be matched already"
        reads[ei] = canon[src]
        if otree[ei]:
            dst = int(odst[ei])
            prefix.append((canon[src], int(lab[dst])))
            canon[dst] = len(keys)
            keys.append(SubPatternKey(seed, tuple(prefix)))
    return keys, reads


class DagFull(RuntimeError):
    """A :class:`PlanDAG` ran out of node slots — the caller grows the
    capacity (a bucket rebuild, amortized like the row doubling)."""


class PlanDAG:
    """Refcounted slot allocator for the distinct sub-pattern nodes of one
    bank. ``acquire`` interns a query's node path (allocating the lowest
    free slot per previously-unseen key — deterministic across replays),
    ``release`` decrements and frees leaves. The device-side mirror is the
    bucket's ``row_node`` table: slot ids index the matcher's shared
    expansion tables."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._slot: Dict[SubPatternKey, int] = {}
        self._ref: Dict[SubPatternKey, int] = {}
        self._free: List[int] = list(range(capacity))
        heapq.heapify(self._free)

    @property
    def n_nodes(self) -> int:
        return len(self._slot)

    def slot(self, key: SubPatternKey) -> int:
        return self._slot[key]

    def refcounts(self) -> Dict[SubPatternKey, int]:
        return dict(self._ref)

    def acquire(self, keys: Sequence[SubPatternKey]) -> List[int]:
        """Intern a query's node path; returns the slot per key. Raises
        :exc:`DagFull` (before any mutation) when the fresh keys outnumber
        the free slots."""
        fresh = [k for k in dict.fromkeys(keys) if k not in self._slot]
        if len(fresh) > len(self._free):
            raise DagFull(
                f"PlanDAG capacity {self.capacity} exceeded: "
                f"{self.n_nodes} live nodes + {len(fresh)} new")
        for k in fresh:
            self._slot[k] = heapq.heappop(self._free)
        for k in keys:
            self._ref[k] = self._ref.get(k, 0) + 1
        return [self._slot[k] for k in keys]

    def release(self, keys: Sequence[SubPatternKey]) -> None:
        for k in keys:
            r = self._ref[k] - 1
            if r == 0:
                del self._ref[k]
                heapq.heappush(self._free, self._slot.pop(k))
            else:
                self._ref[k] = r

    def digest(self) -> np.ndarray:
        """``int64[capacity, 2]`` — per slot ``(key digest, refcount)``,
        zeros for free slots. The checkpoint round-trip view: content-
        stable, so a reload against the same registry must reproduce it
        exactly."""
        out = np.zeros((self.capacity, 2), np.int64)
        for k, s in self._slot.items():
            out[s, 0] = k.digest()
            out[s, 1] = self._ref[k]
        return out


def triangle(labels: Tuple[int, int, int] = (0, 0, 0), **kw) -> Query:
    return build_query([(0, 1), (1, 2), (2, 0)], list(labels),
                       name="triangle", **kw)


def square(labels: Tuple[int, int, int, int] = (0, 0, 0, 0), **kw) -> Query:
    return build_query([(0, 1), (1, 2), (2, 3), (3, 0)], list(labels),
                       name="square", **kw)


def star5(labels: Tuple[int, ...] = (0, 0, 0, 0, 0), **kw) -> Query:
    assert len(labels) == 5
    return build_query([(0, 1), (0, 2), (0, 3), (0, 4)], list(labels),
                       name="star5", **kw)


def clique4(labels: Tuple[int, int, int, int] = (0, 0, 0, 0), **kw) -> Query:
    return build_query(
        [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], list(labels),
        name="clique4", **kw)


def line3(labels: Tuple[int, int, int] = (0, 0, 0), **kw) -> Query:
    """Line query — excluded from the paper's experiments (§V) but supported."""
    return build_query([(0, 1), (1, 2)], list(labels), name="line3", **kw)


def prefix_zoo(count: int, q_max: int = 8, qe_max: int = 16) -> List[Query]:
    """``count`` standing queries with heavy BFS-prefix overlap and zero
    exact duplication — the DAG-sharing stress population (ROADMAP).

    Sub-pattern sharing keys on the *stripped* label vector, mask and
    anchor (:class:`SubPatternKey.seed`), so the whole family fixes one
    7-vertex label vector and varies only (a) which earlier vertex each
    tail vertex hangs off (diverging the BFS tree path mid-way) and
    (b) which closure edges verify the match (never extending the tree,
    so those variants share their *entire* expansion path). Closure
    subsets are enumerated innermost: consecutive queries share deepest.

    Every query keeps vertex 0 the (first-index) max-degree vertex so
    :func:`build_query` anchors the family identically; exact duplicates
    are filtered by :func:`query_signature`.
    """
    labels = [0, 1, 2, 3, 1, 2, 3]
    core = [(0, 1), (0, 2), (0, 3)]
    closure_pool = [(1, 2), (1, 3), (2, 3), (4, 5)]
    out: List[Query] = []
    seen = set()
    for a4 in (1, 2, 3):
        for a5 in (1, 2, 3, 4):
            for a6 in (1, 2, 3, 4, 5):
                tails = [(a4, 4), (a5, 5), (a6, 6)]
                for cmask in range(1 << len(closure_pool)):
                    closures = [e for j, e in enumerate(closure_pool)
                                if cmask >> j & 1]
                    edges = core + tails + closures
                    deg = [0] * 7
                    for a, b in edges:
                        deg[a] += 1
                        deg[b] += 1
                    if max(deg[1:]) > deg[0]:
                        continue  # anchor must stay the argmax vertex
                    q = build_query(edges, labels, q_max=q_max,
                                    qe_max=qe_max,
                                    name=f"prefix/t{a4}{a5}{a6}c{cmask:x}")
                    sig = query_signature(q)
                    if sig in seen:
                        continue
                    seen.add(sig)
                    out.append(q)
                    if len(out) >= count:
                        return out
    raise ValueError(f"prefix_zoo exhausted at {len(out)} < {count}")


def query_zoo(count: int, n_labels: int = 4, q_max: int = 8,
              qe_max: int = 16) -> List[Query]:
    """``count`` standing queries for a serving bank: the paper's four
    shapes cycled with rotated label assignments (deterministic)."""
    shapes = (triangle, square, star5, clique4)
    sizes = (3, 4, 5, 4)
    out = []
    for i in range(count):
        fn, sz = shapes[i % 4], sizes[i % 4]
        shift = i // 4
        labs = tuple((shift + j) % n_labels for j in range(sz))
        q = fn(labels=labs, q_max=q_max, qe_max=qe_max)
        out.append(q._replace(name=f"{q.name}/l{shift}"))
    return out
