"""Bucketed dynamic query banks.

Standing queries are grouped into *buckets* keyed on the padded shape
``(q_max, qe_max, B_pad)`` — pow-2 roundups of (query vertices, schedule
length, row count). Each bucket owns one padded :class:`QueryBank` on the
engine's device and ONE :class:`~repro_torch.core.gray.BankGRayMatcher` in
the content-independent ``memo=False`` mode, where every bank tensor is an
argument and the schedule depends only on the bucket key: ``register``
writes a query's tensors into a free row and ``retire`` zeroes them. Only
outgrowing ``B_pad`` (a doubling) builds a new bucket.

With more than one mesh device a bucket's match runs over the ``(q, g)``
device mesh (:class:`~repro_torch.engine.sharding.ShardedBankMatch`): rows
are independent in ``memo=False`` mode, so the query axis needs no
collectives, and its results are bitwise the replicated path's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.base import EngineConfig, IGPMConfig
from repro_torch.core.graph import DynamicGraph, PartitionedEdges, to_numpy
from repro_torch.core.gray import BankGRayMatcher, GRayResult
from repro_torch.core.query import (PlanDAG, Query, QueryBank, SubPatternKey,
                                    decompose, schedule_reads, stack_queries)
from repro_torch.engine.sharding import (ShardedBankMatch, mesh_devices,
                                         query_shard_count)
from repro_torch.sparse.ell import EllGraph


def _pow2(x: int, floor: int) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(x, 1)))))


def encode_strings(strs) -> np.ndarray:
    """Serialize strings as a flat ``uint8`` array (the state-dict layout
    carries numeric dtypes only)."""
    return np.frombuffer("\n".join(strs).encode("utf-8"),
                         np.uint8).copy()


def decode_strings(a: np.ndarray) -> Tuple[str, ...]:
    if a.size == 0:
        return ()
    return tuple(bytes(np.asarray(a, np.uint8)).decode("utf-8").split("\n"))


def bucket_shape(query: Query, ecfg: EngineConfig) -> Tuple[int, int]:
    """The (q_max, qe_max) bucket a query pads into."""
    q = _pow2(query.n_nodes, ecfg.q_floor)
    qe = _pow2(query.n_edges, ecfg.qe_floor)
    if query.n_nodes > ecfg.q_cap or query.n_edges > ecfg.qe_cap:
        raise ValueError(
            f"query {query.name!r} ({query.n_nodes} vertices, "
            f"{query.n_edges} schedule edges) exceeds the engine caps "
            f"(q_cap={ecfg.q_cap}, qe_cap={ecfg.qe_cap})")
    return min(q, ecfg.q_cap), min(qe, ecfg.qe_cap)


def _empty_bank(q_max: int, qe_max: int, b_pad: int,
                device: torch.device) -> QueryBank:
    z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    return QueryBank(
        labels=z(b_pad, q_max), mask=z(b_pad, q_max, dt=torch.bool),
        order_src=z(b_pad, qe_max), order_dst=z(b_pad, qe_max),
        order_tree=z(b_pad, qe_max, dt=torch.bool),
        order_mask=z(b_pad, qe_max, dt=torch.bool),
        anchor=z(b_pad), names=())


_BANK_FIELDS = ("labels", "mask", "order_src", "order_dst", "order_tree",
                "order_mask", "anchor")


class QueryBucket:
    """One padded bank of standing queries sharing one bucket shape.

    ``n_shards`` (from ``shard`` and the query-axis budget ``q_budget``,
    by default every mesh device) splits the rows over the query axis;
    ``g_shards > 1`` adds the graph axis: the storm/batch full-graph match
    runs on the 2-D ``(q, g)`` mesh against the shard-local ELL row blocks
    (``match(..., graph_sharded=True)``), while the induced-subgraph path
    keeps the graph replicated. ``devices`` are the engine's mesh devices."""

    def __init__(self, cfg: IGPMConfig, q_max: int, qe_max: int, b_pad: int,
                 shard: str = "auto", g_shards: int = 1,
                 q_budget: Optional[int] = None,
                 node_cap: Optional[int] = None, device="cuda",
                 devices: Optional[Sequence] = None):
        self.device = torch.device(device)
        devices = mesh_devices(self.device, devices)
        self.q_max, self.qe_max, self.b_pad = q_max, qe_max, b_pad
        # sub-pattern DAG capacity: defaults to the identity bound (every
        # row needs ≤ q_max nodes, so q_max·b_pad never overflows); the
        # engine passes tighter pow-2 caps and grows them on DagFull
        self.node_cap = node_cap if node_cap is not None else q_max * b_pad
        self.dag = PlanDAG(self.node_cap)
        self.row_node = torch.zeros((b_pad, qe_max), dtype=torch.int32,
                                    device=self.device)
        self._row_keys: List[Optional[List[SubPatternKey]]] = [None] * b_pad
        self.bank = _empty_bank(q_max, qe_max, b_pad, self.device)
        self.matcher = BankGRayMatcher(
            self.bank, cfg.n_labels, cfg.top_k_patterns,
            rwr_iters=cfg.rwr_iters, restart=cfg.restart_prob,
            bridge_hops=cfg.bridge_hops, backend=cfg.backend,
            ell_width=cfg.ell_width, memo=False, rwr_tol=cfg.rwr_tol,
            node_cap=self.node_cap, device=self.device)
        self.n_shards = query_shard_count(
            b_pad, shard, max_devices=(len(devices) if q_budget is None
                                       else q_budget))
        self.g_shards = g_shards
        self._sharded = (
            ShardedBankMatch(self.matcher, self.n_shards, g_shards, devices)
            if self.n_shards > 1 or g_shards > 1 else None)
        self.qids: List[Optional[str]] = [None] * b_pad
        self._queries: List[Optional[Query]] = [None] * b_pad
        self._row_masks: List[Optional[np.ndarray]] = [None] * b_pad
        self._names: List[str] = [f"q{i}" for i in range(b_pad)]
        self.version = 0  # bumped on every membership change (seed memo key)

    # -- membership -----------------------------------------------------------

    @property
    def key(self) -> Tuple[int, int, int]:
        return (self.q_max, self.qe_max, self.b_pad)

    @property
    def n_live(self) -> int:
        return sum(q is not None for q in self.qids)

    @property
    def full(self) -> bool:
        return self.n_live == self.b_pad

    def rows(self) -> List[Tuple[int, str]]:
        """(slot, qid) of every occupied row, slot order."""
        return [(i, q) for i, q in enumerate(self.qids) if q is not None]

    def query(self, slot: int) -> Query:
        q = self._queries[slot]
        assert q is not None
        return q

    def row_mask(self, slot: int) -> np.ndarray:
        m = self._row_masks[slot]
        assert m is not None
        return m

    def _write_row(self, slot: int, row: Optional[QueryBank]) -> None:
        b = self.bank
        fields = {}
        for f in _BANK_FIELDS:
            t = getattr(b, f).clone()
            if row is None:
                t[slot] = 0
            else:
                t[slot] = getattr(row, f)[0].to(self.device)
            fields[f] = t
        self.bank = QueryBank(**fields, names=tuple(self._names))

    def register(self, qid: str, query: Query) -> int:
        """Write ``query`` into a free row; returns the slot. The query's
        sub-pattern path is interned into the bucket DAG (refcount
        increments; raises :exc:`~repro_torch.core.query.DagFull` before
        touching anything when the capacity is exhausted) and the row's
        ``row_node`` plan is written alongside the bank row."""
        slot = self.qids.index(None)  # raises ValueError when full
        row = stack_queries([query], q_max=self.q_max, qe_max=self.qe_max)
        row_q = row.query(0)
        keys = decompose(row_q)
        reads = schedule_reads(row_q)
        slots = self.dag.acquire(keys)  # may raise DagFull — no mutation yet
        plan = np.zeros(self.qe_max, np.int32)
        for ei in range(row_q.n_edges):
            plan[ei] = slots[reads[ei]]
        row_node = self.row_node.clone()
        row_node[slot] = torch.as_tensor(plan, device=self.device)
        self.row_node = row_node
        self._row_keys[slot] = keys
        self._names[slot] = query.name
        self._write_row(slot, row)
        self.qids[slot] = qid
        self._queries[slot] = query
        self._row_masks[slot] = to_numpy(row.mask[0])
        self.version += 1
        return slot

    def retire(self, qid: str) -> int:
        """Zero the row of ``qid``; returns the freed slot. The row's DAG
        refcounts decrement, freeing node slots whose last holder left."""
        slot = self.qids.index(qid)
        keys = self._row_keys[slot]
        assert keys is not None
        self.dag.release(keys)
        self._row_keys[slot] = None
        row_node = self.row_node.clone()
        row_node[slot] = 0
        self.row_node = row_node
        self._names[slot] = f"q{slot}"
        self._write_row(slot, None)
        self.qids[slot] = None
        self._queries[slot] = None
        self._row_masks[slot] = None
        self.version += 1
        return slot

    def rename_row(self, old_qid: str, new_qid: str, query: Query) -> int:
        """Hand ``old_qid``'s row to an exact-duplicate alias — pure host
        bookkeeping (the device row is bitwise the alias's row already).
        Returns the slot."""
        slot = self.qids.index(old_qid)
        self.qids[slot] = new_qid
        self._queries[slot] = query
        self._names[slot] = query.name
        self.bank = self.bank._replace(names=tuple(self._names))
        return slot

    # -- execution ------------------------------------------------------------

    def seeds(self, g: DynamicGraph, r_lab: torch.Tensor,
              seed_filter: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.matcher.seeds(g, r_lab, seed_filter, bank=self.bank)

    def match(self, g: DynamicGraph, r_lab: torch.Tensor,
              seed_filter: Optional[torch.Tensor] = None,
              ell: Optional[EllGraph] = None,
              seeds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              graph_sharded: bool = False,
              part: Optional[PartitionedEdges] = None) -> GRayResult:
        """Match every row against ``g`` — replicated on one device, over
        the mesh otherwise. ``seeds`` short-circuits the top-k (the storm
        seed cache path). ``graph_sharded`` marks a full-graph call whose
        ``ell`` is the shard-local row blocks (the graph axis engages; only
        meaningful when the bucket has ``g_shards > 1``). ``part`` is the
        receiver-sliced COO edge store of partitioned storage — it replaces
        the graph's edge tensors on the mesh and requires
        ``graph_sharded=True``."""
        if seeds is None:
            seeds = self.seeds(g, r_lab, seed_filter)
        seed_ids, seed_mask = seeds
        if self._sharded is not None:
            return self._sharded(g, r_lab, seed_ids, seed_mask, ell,
                                 self.bank, graph_sharded=graph_sharded,
                                 row_node=self.row_node, part=part)
        assert part is None, "partitioned storage needs the graph axis"
        return self.matcher.match_from_seeds(g, r_lab, seed_ids, seed_mask,
                                             ell=ell, bank=self.bank,
                                             row_node=self.row_node)

    # -- state-dict views ------------------------------------------------------

    def bank_arrays(self) -> Dict[str, np.ndarray]:
        b = self.bank
        out = {f: to_numpy(getattr(b, f)) for f in _BANK_FIELDS}
        out.update({
            "occupancy": np.asarray([q is not None for q in self.qids]),
            # host metadata rides along as uint8/int64: the per-row names,
            # the row→node plan, and the DAG digest (per-slot key hash +
            # refcount) for the round-trip check
            "names": encode_strings(self._names),
            "row_node": to_numpy(self.row_node),
            "dag": self.dag.digest(),
        })
        return out

    def load_bank_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        occ = np.asarray(arrays["occupancy"], bool)
        live = np.asarray([q is not None for q in self.qids])
        if not np.array_equal(occ, live):
            raise ValueError(
                "state-dict bucket occupancy does not match the live "
                "registry — register the same queries before loading")
        # the DAG/plans are rebuilt by registration, but SLOT ids depend on
        # the register/retire history (freed slots are reused lowest-first),
        # which a restore does not replay — so verify up to slot
        # permutation: the live DAG must hold the same (key-hash, refcount)
        # multiset, and every row's plan must route through the same KEYS
        if "dag" in arrays:
            ck_dag = np.asarray(arrays["dag"])
            lv_dag = self.dag.digest()
            ck_live = ck_dag[ck_dag[:, 1] > 0]
            lv_live = lv_dag[lv_dag[:, 1] > 0]
            if ck_live.shape != lv_live.shape or not np.array_equal(
                    ck_live[np.lexsort(ck_live.T[::-1])],
                    lv_live[np.lexsort(lv_live.T[::-1])]):
                raise ValueError(
                    "state-dict sub-pattern DAG does not match the live "
                    "registry — register the same queries before loading")
            if "row_node" in arrays:
                rmask = occ[:, None] & to_numpy(self.bank.order_mask)
                ck_h = ck_dag[:, 0][np.asarray(arrays["row_node"])]
                lv_h = lv_dag[:, 0][to_numpy(self.row_node)]
                if not np.array_equal(ck_h[rmask], lv_h[rmask]):
                    raise ValueError(
                        "state-dict row→node plan does not match the live "
                        "bank")
        if "names" in arrays:
            names = decode_strings(np.asarray(arrays["names"]))
            if len(names) == self.b_pad:
                self._names = list(names)
        self.bank = QueryBank(
            **{f: torch.as_tensor(np.array(arrays[f]), device=self.device)
               for f in _BANK_FIELDS},
            names=tuple(self._names))
        self.version += 1
