"""The match engine — ONE step pipeline behind the serving facade.

``engine_step(engine, state, upd)`` sequences the paper's serving step:

  1. ``apply_update`` + incremental ELL-mirror refresh (one graph state)
  2. pattern-store pruning when removals could have killed a matched vertex
  3. PEM recompute mask (one Louvain cut; a fixed community size for Inc,
     one the DQN moves by ±1 per step for IGPM-PEM)
  4. induced-subgraph extraction — or the full-graph *storm* fallback with
     warm-started label RWR and the staleness-keyed seed cache
  5. the label-conditioned RWR table (query-independent, shared by all
     buckets)
  6. one bank G-Ray match per bucket
  7. host-side merge into per-query :class:`~repro_torch.engine.store.
     PatternStore`
  8. PEM feedback: the DQN observes the step's time and moves the
     community size (adaptive mode only)

``mode="batch"`` instead re-runs G-Ray from scratch on the full graph each
step (the paper's Batch oracle). All evolving data rides in
:class:`~repro_torch.engine.state.EngineState`; the Engine object holds the
registry (buckets, stores) and host caches that are pure functions of the
state (ELL mirror, Louvain dendrogram, storm seed memo).

``BatchMatcher`` / ``NaiveIncrementalMatcher`` / ``AdaptiveMatcher``
(``repro_torch.core.matcher``) and ``MatchServer`` are facades over this
one pipeline.

The engine runs on ``device="cuda"`` unless the caller asks for the CPU;
the graph, the tables and the DQN agent of adaptive mode live there. Its
device mesh (``devices=``, by default every visible device of that type;
a list may repeat one device) splits between a query axis
(``EngineConfig.shard``) and a graph axis (``graph_shard``) as the JAX
package's ``device_split`` does (:mod:`repro_torch.engine.sharding`).
With a graph axis the full-graph storm/batch sweeps run over it, against
a shard-local ELL mirror or, with ``edge_partition="on"`` on the COO
backend, a receiver-partitioned edge store
(:class:`~repro_torch.core.graph.EdgePartition`); either is a cache of
the graph, rebuilt from it.

``state_dict`` / ``load_state_dict`` carry state in the JAX package's key
layout, and ``save`` / ``load`` write and read it as checkpoint
directories that either package restores.

Tracing (``EngineConfig.obs``) wraps each stage in a span and returns the
per-stage wall times in ``StepOutput.stage_s``; its extra device fences
(``torch.cuda.synchronize``) run only with tracing on. ``set_executor_pool``
fans each step's per-bucket matches across worker threads, joined in
bucket order (serialised under a lock when the mesh has a graph axis).
A serving controller attached as ``Engine.control`` rides
``state_dict``/``save`` and ``load_state_dict``/``load``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.config.base import EngineConfig, IGPMConfig, resolve_backend
from repro_torch.core.graph import (DynamicGraph, EdgePartition, EllCache,
                                    UpdateBatch, apply_update, check_device,
                                    to_numpy, updated_vertices)
from repro_torch.core.pem import PartialExecutionManager
from repro_torch.core.query import DagFull, Query, query_signature
from repro_torch.core.rwr import label_rwr, label_rwr_adaptive
from repro_torch.core.subgraph import extract_induced, remap_matched
from repro_torch.engine.buckets import (QueryBucket, _pow2, bucket_shape,
                                        decode_strings, encode_strings)
from repro_torch.engine.sharding import (ShardedSweep, device_split,
                                         mesh_devices)
from repro_torch.engine.state import EngineState, QueryDelta, StepOutput
from repro_torch.engine.store import PatternStore, live_vertex_mask
from repro_torch.obs import Obs


class Engine:
    """Functional-core match engine with bucketed dynamic query banks."""

    def __init__(self, cfg: IGPMConfig, ecfg: Optional[EngineConfig] = None,
                 seed: int = 0, device="cuda", devices=None):
        ecfg = ecfg or EngineConfig()
        if ecfg.mode not in ("incremental", "batch"):
            raise ValueError(f"unknown engine mode {ecfg.mode!r}")
        if ecfg.shard not in ("auto", "off"):
            raise ValueError(f"unknown query-axis shard mode {ecfg.shard!r}")
        if ecfg.edge_partition not in ("off", "on"):
            raise ValueError(
                f"unknown edge_partition policy {ecfg.edge_partition!r}")
        self.device = check_device(device)
        if cfg.backend == "auto":
            cfg = dataclasses.replace(
                cfg, backend=resolve_backend(cfg.backend, self.device))
        self.cfg = cfg
        self.ecfg = ecfg
        self.seed = seed
        self.pem: Optional[PartialExecutionManager] = (
            None if ecfg.mode == "batch"
            else PartialExecutionManager(cfg, adaptive=ecfg.adaptive,
                                         seed=seed, device=self.device))
        # the device mesh: how its devices split between the query and the
        # graph axis (1/1 on one device)
        self.devices = mesh_devices(self.device, devices)
        self.q_budget, self.g_shards = device_split(
            ecfg.shard, ecfg.graph_shard, cfg.n_max, len(self.devices))
        # without a graph axis the mirrors stay on the engine's device
        self.graph_devices = (self.devices[:self.g_shards]
                              if self.g_shards > 1 else [self.device])
        self._sweeps = (ShardedSweep(self.graph_devices)
                        if self.g_shards > 1 else None)
        # edge-partitioned storage: co-partition the edges with the
        # receiver slices so each graph shard holds ~1/g of them; the
        # mirrors then never hand replicated edges to the mesh
        self.partitioned = (ecfg.edge_partition == "on"
                            and self.g_shards > 1)
        self.ell_cache = None
        self.part_cache = None
        self._new_mirrors()
        # graph-axis dispatch is serialised under the executor pool, as
        # the JAX package serialises its collective-bearing launches: each
        # bucket's mesh sweeps run whole, one bucket after another, which
        # bounds the mesh's working set to one bucket's sweep blocks
        self._dispatch_lock = threading.Lock()
        self.buckets: Dict[Tuple[int, int], QueryBucket] = {}
        self.stores: Dict[str, PatternStore] = {}
        self._where: Dict[str, Tuple[int, int]] = {}  # qid → bucket (q, qe)
        self._order: List[str] = []                   # registration order
        # exact-duplicate groups: content signature → [primary, *aliases].
        # The primary owns the bank row; aliases ride it for free (zero
        # device work at register; results fan out to every store).
        self._dups: Dict[Tuple, List[str]] = {}
        self._sig_of: Dict[str, Tuple] = {}
        self._alias_query: Dict[str, Query] = {}      # alias qid → its Query
        self.n_dedup = 0
        # storm seed cache — see EngineConfig. Entries are (version key,
        # recompute mask, seeds): a step reuses the seeds when the versions
        # match and its mask is within ``seed_cache_hamming`` flips of the
        # cached one (0 = exact).
        self._seed_memo: Dict[Tuple[int, int],
                              Tuple[tuple, np.ndarray, tuple]] = {}
        self.rlab_hits = 0
        self.rlab_misses = 0
        self.seed_hits = 0
        self.seed_hits_exact = 0
        self.seed_hits_bounded = 0
        self.seed_misses = 0
        self.rwr_sweeps = 0  # label-RWR sweeps actually run (adaptive)
        self.rwr_cols_skipped = 0  # converged-column sweeps retired
        self._last_sweeps = 0
        self._last_cols_skipped = 0
        # observability hub: the serving/runtime layers reuse this
        # engine's hub so one event stream spans all threads
        self.obs = Obs(ecfg.obs)
        # last _merge fan-out shape (bank rows folded / alias stores
        # written / merge_arrays calls)
        self.last_merge_rows = 0
        self.last_merge_stores = 0
        self.last_merge_folds = 0
        # per-bucket match fan-out pool (set_executor_pool); None = serial
        self._exec_pool: Optional[ThreadPoolExecutor] = None
        # optional serving-controller attachment (repro_torch.control):
        # when a runtime binds one here, its state rides the engine
        # checkpoint so save/load round-trips the learned policy too
        self.control = None

    # -- standing-query registry ----------------------------------------------

    def register(self, query: Query, qid: Optional[str] = None) -> str:
        """Add a standing query; returns its id. Inside an existing bucket
        this is a row write; a new padded shape — or outgrowing ``B_pad`` —
        builds a new bucket."""
        if qid is None:
            qid = query.name
            i = 1
            while qid in self.stores:
                qid = f"{query.name}#{i}"
                i += 1
        elif qid in self.stores:
            raise ValueError(f"qid {qid!r} already registered")
        shape = bucket_shape(query, self.ecfg)
        # with dedup disabled every registration is its own singleton group
        sig = query_signature(query) if self.ecfg.dedup else (qid,)
        if self.ecfg.dedup and self._dups.get(sig):
            # exact-duplicate fast path: alias the live row. ZERO device
            # work; the row's match results fan out to this store too.
            self._dups[sig].append(qid)
            self._sig_of[qid] = sig
            self._alias_query[qid] = query
            self.n_dedup += 1
            store = PatternStore()
            primary = self.stores[self._dups[sig][0]]
            if primary.total == 0:
                store.share_from(primary)
            self.stores[qid] = store
            self._where[qid] = shape
            self._order.append(qid)
            self.obs.instant("bank/register_alias", qid=qid,
                             primary=self._dups[sig][0])
            return qid
        bucket = self.buckets.get(shape)
        if bucket is None:
            bucket = QueryBucket(self.cfg, *shape, b_pad=1,
                                 node_cap=shape[0], **self._mesh_kw())
            self.buckets[shape] = bucket
        elif bucket.full:
            bucket = self._grow(bucket)
        with self.obs.span("bank/register", qid=qid,
                           bucket=f"{shape[0]}x{shape[1]}"):
            while True:
                try:
                    bucket.register(qid, query)
                    break
                except DagFull:
                    # sub-pattern capacity outgrown: double it (a rebuild,
                    # the same amortized cost as the B_pad doubling)
                    bucket = self._rebuild(bucket, bucket.b_pad,
                                           node_cap=2 * bucket.node_cap)
        self._dups.setdefault(sig, []).append(qid)
        self._sig_of[qid] = sig
        self._seed_memo.pop(shape, None)
        self.stores[qid] = PatternStore()
        self._where[qid] = shape
        self._order.append(qid)
        return qid

    def retire(self, qid: str) -> None:
        """Drop a standing query and its pattern store. Retiring an ALIAS
        (or a primary with live aliases, which hands its row to the next
        one) is pure host bookkeeping. A bucket left EMPTY is dropped; one
        left at ≤ quarter occupancy compacts to half its row capacity."""
        if qid not in self._where:
            raise KeyError(f"unknown qid {qid!r}; live: {self._order}")
        with self.obs.span("bank/retire", qid=qid):
            shape = self._where.pop(qid)
            sig = self._sig_of.pop(qid)
            group = self._dups[sig]
            del self.stores[qid]
            self._order.remove(qid)
            bucket = self.buckets[shape]
            if qid != group[0]:
                # alias — the primary keeps the row
                group.remove(qid)
                del self._alias_query[qid]
                return
            group.pop(0)
            if group:
                # primary with aliases: promote the next one onto the row
                promoted = group[0]
                bucket.rename_row(qid, promoted,
                                  self._alias_query.pop(promoted))
                return
            del self._dups[sig]
            bucket.retire(qid)
            self._seed_memo.pop(shape, None)
            if bucket.n_live == 0:
                del self.buckets[shape]
            elif bucket.b_pad > 1 and bucket.n_live <= bucket.b_pad // 4:
                self._rebuild(bucket, bucket.b_pad // 2)

    def _reshare_alias_stores(self) -> None:
        """Re-establish pattern-dict sharing across exact-duplicate groups
        whose stores hold equal content (fresh after ``reset``, or loaded
        per-qid by ``load_state_dict``)."""
        for group in self._dups.values():
            primary = self.stores.get(group[0])
            if primary is None:
                continue
            for alias in group[1:]:
                store = self.stores.get(alias)
                if (store is not None and not store.shares_with(primary)
                        and store._patterns == primary._patterns):
                    store.share_from(primary)

    def _rebuild(self, bucket: QueryBucket, b_pad: int,
                 node_cap: Optional[int] = None) -> QueryBucket:
        """Repack a bucket's live rows into a ``b_pad``-row bank. ``_grow``
        doubles a full bucket; ``retire`` halves one at ≤ quarter occupancy.
        The DAG capacity re-fits to the live distinct nodes unless an
        explicit ``node_cap`` is forced (the DagFull doubling)."""
        if node_cap is None:
            node_cap = _pow2(bucket.dag.n_nodes, bucket.q_max)
        with self.obs.span("bank/rebuild", b_pad=b_pad, node_cap=node_cap,
                           rows=bucket.n_live):
            fresh = QueryBucket(self.cfg, bucket.q_max, bucket.qe_max,
                                b_pad=b_pad, node_cap=node_cap,
                                **self._mesh_kw())
            for slot, qid in bucket.rows():
                fresh.register(qid, bucket.query(slot))
            self.buckets[(bucket.q_max, bucket.qe_max)] = fresh
        return fresh

    def _grow(self, bucket: QueryBucket) -> QueryBucket:
        # headroom for the incoming row (≤ q_max fresh nodes), so a grow
        # is ONE rebuild, not a rebuild plus a DagFull retry
        return self._rebuild(
            bucket, 2 * bucket.b_pad,
            node_cap=_pow2(bucket.dag.n_nodes + bucket.q_max, bucket.q_max))

    def query(self, qid: str) -> Query:
        q = self._alias_query.get(qid)
        if q is not None:
            return q
        shape = self._where[qid]
        bucket = self.buckets[shape]
        return bucket.query(bucket.qids.index(qid))

    @property
    def qids(self) -> Tuple[str, ...]:
        return tuple(self._order)

    def alias_groups(self) -> Dict[str, str]:
        """qid → its frontier-group primary (itself unless an alias) for
        every live standing query. Exact-duplicate group members share
        one bank row and receive identical result fan-out each step, so
        any per-query delivery frontier is shared across the group — the
        :class:`~repro_torch.obs.freshness.FreshnessLedger` reads this."""
        return {qid: group[0]
                for group in self._dups.values() for qid in group}

    def _mesh_kw(self) -> Dict:
        """The mesh arguments of every bucket this engine builds."""
        return dict(shard=self.ecfg.shard, g_shards=self.g_shards,
                    q_budget=self.q_budget, device=self.device,
                    devices=self.devices)

    def _new_mirrors(self) -> None:
        """Fresh (empty) edge mirrors for this engine's mesh: the ELL mirror
        on the ELL backend, the edge partition on a partitioned COO one.
        Both rebuild from the graph on the next ``_apply``."""
        cfg = self.cfg
        if cfg.backend == "ell":
            self.ell_cache = EllCache(
                cfg.n_max, cfg.e_max, cfg.ell_width, n_shards=self.g_shards,
                partitioned=self.partitioned,
                headroom=self.ecfg.partition_headroom,
                devices=self.graph_devices)
        if self.partitioned and cfg.backend == "coo":
            self.part_cache = EdgePartition(
                cfg.n_max, cfg.e_max, self.g_shards,
                headroom=self.ecfg.partition_headroom,
                devices=self.graph_devices)

    def partition_occupancy(self) -> Optional[float]:
        """Worst live-slice fill fraction of the edge-partitioned storage,
        or None when storage is not partitioned. This is overflow
        *proximity*: 1.0 means the next uneven batch can raise
        ``PartitionOverflowError`` — the health watchdog degrades before
        that."""
        if self.part_cache is not None:
            return self.part_cache.occupancy()
        if self.ell_cache is not None and self.partitioned:
            return self.ell_cache.occupancy()
        return None

    def set_executor_pool(self, n_executors: int) -> None:
        """Install (``n > 1``) or tear down (``n <= 1``) the per-bucket
        match fan-out pool. Pool workers only launch each bucket's match —
        on inputs identical to the serial path — and the join happens in
        bucket order before any merge, so pooled results are bitwise equal
        to serial ones. Host-side step decisions (seed memo, PEM, merge)
        never leave the calling thread."""
        if self._exec_pool is not None:
            self._exec_pool.shutdown(wait=True)
            self._exec_pool = None
        if n_executors > 1:
            self._exec_pool = ThreadPoolExecutor(
                max_workers=n_executors, thread_name_prefix="rt-bucket-exec")

    def occupancy(self) -> Dict[Tuple[int, int, int], Tuple[int, int]]:
        """bucket key (q_max, qe_max, B_pad) → (live rows, padded rows)."""
        return {b.key: (b.n_live, b.b_pad) for b in self.buckets.values()}

    def counters(self) -> Dict[str, int]:
        return {"rlab_cache_hits": self.rlab_hits,
                "rlab_cache_misses": self.rlab_misses,
                "seed_cache_hits": self.seed_hits,
                "seed_cache_hits_exact": self.seed_hits_exact,
                "seed_cache_hits_bounded": self.seed_hits_bounded,
                "seed_cache_misses": self.seed_misses,
                "rwr_sweeps": self.rwr_sweeps,
                "rwr_cols_skipped": self.rwr_cols_skipped,
                "n_dedup": self.n_dedup,
                "standing_queries": len(self._order),
                "bank_rows": sum(b.n_live for b in self.buckets.values()),
                "dag_nodes": sum(b.dag.n_nodes
                                 for b in self.buckets.values()),
                "dag_node_cap": sum(b.node_cap
                                    for b in self.buckets.values())}

    # -- state lifecycle -------------------------------------------------------

    def init_state(self, graph: DynamicGraph) -> EngineState:
        return EngineState(graph=graph)

    def reset(self) -> None:
        """Clear accumulated match state but KEEP the PEM's learned
        threshold and policy — benchmark warm/measure passes replay
        identical streams on one engine."""
        self.stores = {qid: PatternStore() for qid in self._order}
        self._reshare_alias_stores()
        self._seed_memo.clear()
        self.rlab_hits = self.rlab_misses = 0
        self.seed_hits = self.seed_misses = 0
        self.seed_hits_exact = self.seed_hits_bounded = 0
        self.rwr_sweeps = 0
        self.rwr_cols_skipped = 0
        self._new_mirrors()

    # -- the ONE step pipeline -------------------------------------------------

    def step(self, state: EngineState,
             upd: UpdateBatch) -> Tuple[EngineState, StepOutput]:
        return engine_step(self, state, upd)

    def _apply(self, g: DynamicGraph,
               upd: UpdateBatch) -> Tuple[DynamicGraph, float]:
        """Apply the update, refreshing whichever mirror is carried (the
        ELL mirror and/or the edge partition). The returned refresh time
        covers only the mirror maintenance."""
        mirrors = [m for m in (self.ell_cache, self.part_cache)
                   if m is not None]
        if not mirrors:
            return apply_update(g, upd), 0.0
        for m in mirrors:
            if m._last is not g:
                m.rebuild(g)
        g2 = apply_update(g, upd)
        t0 = time.perf_counter()
        for m in mirrors:
            m.refresh(g, g2, upd)
        for dev in dict.fromkeys(self.graph_devices):
            _sync(dev)
        return g2, time.perf_counter() - t0

    @property
    def _full_ell(self):
        return None if self.ell_cache is None else self.ell_cache.ell

    @property
    def _full_part(self):
        """The receiver-sliced edge store to hand the graph axis, or None
        when edge partitioning is off or the ELL backend carries the slices
        itself (its mirror is already built per receiver block)."""
        return None if self.part_cache is None else self.part_cache.part

    def _node_view(self, g: DynamicGraph) -> DynamicGraph:
        """``g`` with the replicated COO edge tensors cut to width-1
        placeholders. Partitioned mesh calls read only the node-level
        fields (labels, node_mask, degree) plus the partitioned slices, so
        handing them this view keeps replicated edge storage off the mesh."""
        z = torch.zeros((1,), dtype=torch.int32, device=g.device)
        return g._replace(senders=z, receivers=z,
                          edge_mask=torch.zeros((1,), dtype=torch.bool,
                                                device=g.device))

    def _label_table(self, g: DynamicGraph,
                     r0: Optional[torch.Tensor] = None,
                     iters: Optional[int] = None, ell=None,
                     part=None, sharded: bool = False) -> torch.Tensor:
        """The per-step label-RWR table. ``sharded`` marks a FULL-graph
        call (storm/batch), which runs over the graph axis when the mesh
        has one (``ell`` then being the shard-local row blocks, ``part``
        the partitioned edges); induced-subgraph tables stay replicated.
        ``cfg.rwr_tol > 0`` swaps the fixed-count loop for the
        residual-adaptive one (hard cap = the fixed count); the sweeps
        actually run are accounted in ``rwr_sweeps``."""
        cfg = self.cfg
        iters = iters if iters is not None else cfg.rwr_iters
        if sharded and self._sweeps is not None:
            r, n, skipped = self._sweeps.label_table(
                g, cfg.n_labels, iters, cfg.restart_prob, r0, ell,
                tol=cfg.rwr_tol, part=part)
            self._account_sweeps(n, skipped)
            return r
        if cfg.rwr_tol > 0:
            r, n, skipped = label_rwr_adaptive(
                g, cfg.n_labels, max_iters=iters, tol=cfg.rwr_tol,
                c=cfg.restart_prob, r0=r0, ell=ell)
            self._account_sweeps(n, skipped)
            return r
        self._account_sweeps(iters, 0)
        return label_rwr(g, cfg.n_labels, iters=iters,
                         c=cfg.restart_prob, r0=r0, ell=ell)

    def _account_sweeps(self, n: int, skipped: int) -> None:
        self.rwr_sweeps += n
        self.rwr_cols_skipped += skipped
        self._last_sweeps = n
        self._last_cols_skipped = skipped

    def _merge(self, results, remap=None,
               rebuild: bool = False) -> Tuple[QueryDelta, ...]:
        """Fold per-bucket results into the per-query stores (the only
        per-query host work of a step), traced per bucket and per row.
        Alias stores created while the primary was empty SHARE the
        primary's pattern dict, so each row folds its arrays once per
        *distinct dict* in its group. ``last_merge_rows``/``_stores``/
        ``_folds`` keep the fan-out accounting."""
        obs = self.obs
        by_qid: Dict[str, QueryDelta] = {}
        n_rows = n_stores = n_folds = 0
        for shape, res in results.items():
            bucket = self.buckets[shape]
            with obs.span("engine/merge/bucket",
                          bucket=f"{shape[0]}x{shape[1]}",
                          rows=bucket.n_live):
                matched = to_numpy(res.matched)
                if remap is not None:
                    matched = remap_matched(
                        matched.reshape(-1, matched.shape[-1]),
                        remap).reshape(matched.shape)
                goodness = to_numpy(res.goodness)
                exact = to_numpy(res.exact)
                valid = to_numpy(res.valid)
                for slot, qid in bucket.rows():
                    group = self._dups.get(self._sig_of[qid], [qid])
                    n_rows += 1
                    n_stores += len(group)
                    folded: Dict[int, int] = {}  # id(pattern dict) → n_new
                    with obs.span("engine/merge/row", qid=qid,
                                  aliases=len(group)):
                        for alias in group:
                            store = self.stores[alias]
                            pid = id(store._patterns)
                            if pid not in folded:
                                if rebuild:
                                    store._patterns.clear()
                                folded[pid] = store.merge_arrays(
                                    matched[slot], goodness[slot],
                                    exact[slot], valid[slot],
                                    bucket.row_mask(slot))
                                n_folds += 1
                            name = (bucket.query(slot).name if alias == qid
                                    else self._alias_query[alias].name)
                            by_qid[alias] = QueryDelta(alias, name,
                                                       folded[pid],
                                                       store.total,
                                                       store.exact)
        self.last_merge_rows = n_rows
        self.last_merge_stores = n_stores
        self.last_merge_folds = n_folds
        return tuple(by_qid[q] for q in self._order if q in by_qid)

    # -- state carried across (the JAX package's state_dict layout) ------------

    def state_dict(self, state: EngineState) -> Dict:
        """The engine state as host arrays, in the key layout of the JAX
        package's ``Engine.state_dict``: graph, the warm-start r_lab table,
        per-bucket bank tables, PEM state (with the DQN agent's, in adaptive
        mode), and the pattern-store arrays.
        The ELL mirror and Louvain dendrogram are caches rebuilt from the
        graph and are not included."""
        n, L = self.cfg.n_max, self.cfg.n_labels
        d: Dict = {
            "graph": {f: to_numpy(getattr(state.graph, f))
                      for f in state.graph._fields},
            "r_lab": (np.zeros((n, L), np.float32) if state.r_lab is None
                      else to_numpy(state.r_lab)),
            "has_rlab": np.asarray(state.r_lab is not None),
            "rlab_events": np.asarray(state.rlab_events, np.int64),
            "step_idx": np.asarray(state.step_idx, np.int64),
            "buckets": {f"{k[0]}x{k[1]}": b.bank_arrays()
                        for k, b in self.buckets.items()},
            "stores": {qid: self.stores[qid].to_arrays()
                       for qid in self._order},
            "aliases": encode_strings(
                f"{a}\t{self._dups[self._sig_of[a]][0]}"
                for a in self._order if a in self._alias_query),
        }
        if self.pem is not None:
            d["pem"] = {"community_size": np.asarray(self.pem.c, np.int64)}
            if self.pem.agent is not None:
                d["pem"]["agent"] = self.pem.agent.state_dict()
        if self.control is not None:
            d["control"] = self.control.state_dict()
        return d

    def save(self, state: EngineState, directory: str,
             step: Optional[int] = None) -> None:
        """Checkpoint :meth:`state_dict` under ``directory`` (step defaults
        to the state's step index)."""
        ckpt = Checkpointer(directory, async_save=False)
        ckpt.save(state.step_idx if step is None else step,
                  self.state_dict(state))

    def load(self, state: EngineState, directory: str,
             step: Optional[int] = None) -> Tuple[EngineState, int]:
        """Restore a checkpoint saved by :meth:`save` of either package.
        The same queries must be registered (the registry is code +
        configuration; the checkpoint carries data). Returns (state,
        step)."""
        ckpt = Checkpointer(directory, async_save=False)
        tree, step = ckpt.restore(self.state_dict(state), step=step)
        return self.load_state_dict(tree), step

    def load_state_dict(self, tree: Dict) -> EngineState:
        """Restore a state tree — this engine's :meth:`state_dict`, or the
        one the JAX package's ``Engine.state_dict`` returns (same keys), so
        a port engine carries on serving from a reference engine's state.
        The same queries must be registered (the registry is code +
        configuration; the tree carries data). A ``control`` entry restores
        the attached controller and is ignored when none is attached."""
        dev = self.device
        graph = DynamicGraph(**{
            f: torch.as_tensor(np.array(tree["graph"][f]), device=dev)
            for f in DynamicGraph._fields})
        for key_s, arrays in tree["buckets"].items():
            q, qe = (int(x) for x in key_s.split("x"))
            self.buckets[(q, qe)].load_bank_arrays(arrays)
        if "aliases" in tree:
            live = tuple(f"{a}\t{self._dups[self._sig_of[a]][0]}"
                         for a in self._order if a in self._alias_query)
            if decode_strings(np.asarray(tree["aliases"])) != live:
                raise ValueError(
                    "state-dict duplicate-alias groups do not match the "
                    "live registry — register the same queries first")
        for qid, arrays in tree["stores"].items():
            self.stores[qid].load_arrays(arrays)
        self._reshare_alias_stores()
        if self.pem is not None:
            self.pem.c = int(np.asarray(tree["pem"]["community_size"]))
            if self.pem.agent is not None:
                self.pem.agent.load_state_dict(tree["pem"]["agent"])
        if self.control is not None and "control" in tree:
            self.control.load_state_dict(tree["control"])
        self._seed_memo.clear()
        if self.pem is not None:
            # the Louvain dendrogram is stale-tolerant (results-affecting)
            # state, not a pure cache: drop it so a load behaves exactly
            # like a fresh process restoring the same state
            self.pem.reset_clustering()
        # the ELL mirror resyncs on the next _apply (graph identity changed)
        return EngineState(
            graph=graph,
            r_lab=(torch.as_tensor(np.array(tree["r_lab"]), device=dev)
                   if bool(np.asarray(tree["has_rlab"])) else None),
            rlab_events=int(np.asarray(tree["rlab_events"])),
            rlab_version=0,
            step_idx=int(np.asarray(tree["step_idx"])))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sync_mesh(eng: Engine) -> None:
    """Wait for every device of the engine and its mesh."""
    for dev in dict.fromkeys([eng.device, *eng.devices]):
        _sync(dev)


def _n_events(upd: UpdateBatch) -> int:
    """Masked update entries in a batch (host-side; staleness accounting)."""
    return int(upd.add_mask.sum() + upd.rem_mask.sum() + upd.lab_mask.sum())




def engine_step(eng: Engine, state: EngineState,
                upd: UpdateBatch) -> Tuple[EngineState, StepOutput]:
    """THE shared step pipeline (module docstring). Evolving data is read
    from ``state`` and returned in the new state; Engine-held host caches
    are rebuilt-on-demand views.

    With tracing off this delegates straight to the pipeline — no span
    objects, no stage dict, no extra device fences. With tracing on, the
    step runs inside a step-scoped trace context (every span carries
    ``step``), the flight recorder captures the step's span group, and
    per-stage wall times come back in ``StepOutput.stage_s``."""
    obs = eng.obs
    if not obs.enabled:
        return _engine_step(eng, state, upd, obs, None)
    step_idx = int(state.step_idx)
    with obs.profile_step(step_idx), obs.context(step=step_idx):
        obs.begin_step(step_idx)
        try:
            return _engine_step(eng, state, upd, obs, {})
        finally:
            obs.end_step(step_idx)


def _run_matches(eng: Engine, jobs, obs: Obs, tracing: bool):
    """Run the per-bucket bank matches: serially without an executor pool
    (or with one job), fanned across the pool otherwise, joined in bucket
    submission order before returning. Each job is ``(shape, bucket_key,
    thunk)``; every bucket's match is the same computation on the same
    inputs either way, so pooled results are bitwise equal to serial ones
    and ``results`` keeps bucket-insertion order. Pooled ``t_gray`` sums
    per-worker seconds (may exceed wall time). With a graph axis the
    workers take the engine's dispatch lock for a whole bucket match and
    its completion, so the mesh runs one bucket at a time as on the serial
    path; without one they launch concurrently."""
    results = {}
    t_gray = t_gwait = 0.0
    dev = eng.device
    pool = eng._exec_pool
    if pool is None or len(jobs) <= 1:
        for shape, bkey, thunk in jobs:
            with obs.span("engine/gray", bucket=bkey) as sp:
                results[shape] = thunk()
            t_gray += sp.dur_s
            if tracing:
                with obs.span("engine/gray_wait", bucket=bkey) as spw:
                    _sync(dev)
                t_gwait += spw.dur_s
        return results, t_gray, t_gwait

    lock = eng._dispatch_lock if eng.g_shards > 1 else None

    def run(bkey, thunk):
        with obs.span("engine/gray", bucket=bkey, pooled=True) as sp:
            if lock is not None:
                with lock:
                    out = thunk()
                    _sync_mesh(eng)
            else:
                out = thunk()
                if tracing:
                    _sync(dev)
        return out, sp.dur_s

    futs = [(shape, pool.submit(run, bkey, thunk))
            for shape, bkey, thunk in jobs]
    for shape, fut in futs:
        out, dur = fut.result()
        results[shape] = out
        t_gray += dur
    return results, t_gray, t_gwait


def _engine_step(eng: Engine, state: EngineState, upd: UpdateBatch,
                 obs: Obs, stage: Optional[Dict[str, float]]
                 ) -> Tuple[EngineState, StepOutput]:
    """Pipeline body. ``stage`` is None when tracing is off (every span
    call then hits the shared no-op span); when tracing, it accumulates
    per-stage seconds for ``StepOutput.stage_s``. Stages: apply (with
    ell_refresh inside it) → prune → pem → [storm: rwr → seeds → gray |
    induced: extract → rwr → gray] → device_wait → merge → feedback. The
    ``torch.cuda.synchronize`` fences that split host dispatch from device
    wait inside rwr, seeds and gray run ONLY when tracing; device_wait is
    the step's one untraced sync, as before."""
    cfg, ecfg = eng.cfg, eng.ecfg
    dev = eng.device
    tracing = stage is not None
    with obs.span("engine/apply") as sp:
        g, refresh_s = eng._apply(state.graph, upd)
        n_events = _n_events(upd)
        rlab_events = state.rlab_events + n_events
        rlab_version = state.rlab_version
        upd_ids = None
        if ecfg.mode != "batch":
            ids, mask = updated_vertices(g, upd, ecfg.v_max)
            upd_ids = to_numpy(torch.where(mask, ids, -1))
    if tracing:
        stage["apply"] = sp.dur_s
        stage["ell_refresh"] = refresh_s

    # -- store pruning (deletion-heavy streams) --------------------------------
    n_pruned = 0
    if (ecfg.mode != "batch"
            and any(s.total for s in eng.stores.values())
            and bool(upd.rem_mask.any())):
        with obs.span("engine/prune") as sp:
            live = live_vertex_mask(g)
            # prune each DISTINCT pattern dict once (alias stores share the
            # primary's dict); every sharer still counts the removals
            removed: Dict[int, int] = {}
            for s in eng.stores.values():
                pid = id(s._patterns)
                if pid not in removed:
                    removed[pid] = s.prune(live)
                n_pruned += removed[pid]
        if tracing:
            stage["prune"] = sp.dur_s

    t0 = time.perf_counter()
    n_live = max(int(g.node_mask.sum()), 1)
    rlab_hit = seed_hit = False
    community = 0
    rl_loss = 0.0
    t_seeds = 0.0

    eng._last_sweeps = 0
    eng._last_cols_skipped = 0
    if ecfg.mode == "batch":
        # the paper's Batch oracle: full fresh pass, stores rebuilt
        frac = 0.0
        n_rec = n_live
        storm = True
        ell = eng._full_ell
        part = eng._full_part
        # partitioned storage: the mesh reads edges from the partitioned
        # slices, so it gets a node-only view of g
        g_mesh = eng._node_view(g) if part is not None else g
        with obs.span("engine/rwr", mode="batch") as sp:
            r_lab = eng._label_table(g_mesh, ell=ell, part=part,
                                     sharded=True)
            if tracing:
                _sync(dev)
        if tracing:
            stage["rwr"] = sp.dur_s
        jobs = [(shape, f"{shape[0]}x{shape[1]}",
                 (lambda b=bucket: b.match(g_mesh, r_lab, ell=ell,
                                           graph_sharded=True, part=part)))
                for shape, bucket in eng.buckets.items()]
        remap = None
        rebuild = True
        sub_n = sub_e = 0
        r_next = None  # batch mode keeps no warm-start state
        rlab_events = 0
    else:
        with obs.span("engine/pem") as sp:
            rec_mask, frac = eng.pem.recompute_mask(g, upd_ids)
            n_rec = int(rec_mask.sum())
        if tracing:
            stage["pem"] = sp.dur_s
        storm = n_rec > ecfg.full_graph_frac * n_live
        rebuild = False

        if storm:
            # update storm — full pass, warm-started label RWR, gated by the
            # staleness-keyed seed cache
            ell = eng._full_ell
            part = eng._full_part
            g_mesh = eng._node_view(g) if part is not None else g
            if (ecfg.seed_cache_staleness > 0 and state.r_lab is not None
                    and rlab_events <= ecfg.seed_cache_staleness):
                r_lab = state.r_lab
                rlab_hit = True
                eng.rlab_hits += 1
                if tracing:
                    stage["rwr"] = 0.0
                    obs.instant("engine/rwr_cache_hit")
            else:
                # warm starts under the residual-adaptive loop keep the
                # full hard cap — convergence is measured, not assumed
                with obs.span("engine/rwr", mode="storm",
                              warm=state.r_lab is not None) as sp:
                    r_lab = eng._label_table(
                        g_mesh, r0=state.r_lab,
                        iters=(None if (state.r_lab is None
                                        or cfg.rwr_tol > 0)
                               else cfg.rwr_iters_incremental),
                        ell=ell, part=part, sharded=True)
                    if tracing:
                        _sync(dev)
                if tracing:
                    stage["rwr"] = sp.dur_s
                rlab_events = 0
                rlab_version += 1
                eng.rlab_misses += 1
            sf = torch.as_tensor(rec_mask, device=dev)
            mask_arr = np.asarray(rec_mask, bool)
            jobs = []
            bucket_hits = []
            for shape, bucket in eng.buckets.items():
                bkey = f"{shape[0]}x{shape[1]}"
                ver_key = (rlab_version, bucket.version)
                hit = eng._seed_memo.get(shape)
                # bounded-divergence reuse: same table/bank versions and a
                # recompute mask within seed_cache_hamming flips of the
                # one the cached seeds were ranked under (0 = exact match)
                ham = (int(np.count_nonzero(hit[1] != mask_arr))
                       if hit is not None and hit[0] == ver_key else None)
                if ham is not None and ham <= ecfg.seed_cache_hamming:
                    seeds = hit[2]
                    bucket_hits.append(True)
                    eng.seed_hits += 1
                    if ham == 0:
                        eng.seed_hits_exact += 1
                    else:
                        eng.seed_hits_bounded += 1
                else:
                    with obs.span("engine/seeds", bucket=bkey) as sp:
                        seeds = bucket.seeds(g, r_lab, sf)
                        if tracing:
                            _sync(dev)
                    t_seeds += sp.dur_s
                    eng._seed_memo[shape] = (ver_key, mask_arr, seeds)
                    bucket_hits.append(False)
                    eng.seed_misses += 1
                jobs.append((shape, bkey,
                             (lambda b=bucket, s=seeds:
                              b.match(g_mesh, r_lab, seed_filter=sf,
                                      ell=ell, seeds=s, graph_sharded=True,
                                      part=part))))
            seed_hit = bool(bucket_hits) and all(bucket_hits)
            remap = None
            sub_n, sub_e = n_live, int(g.edge_mask.sum())
            r_next = r_lab
        else:
            with obs.span("engine/extract") as sp:
                sub = extract_induced(
                    g, rec_mask,
                    ell_k=(cfg.ell_width if eng.ell_cache is not None
                           else None))
            if tracing:
                stage["extract"] = sp.dur_s
            with obs.span("engine/rwr", mode="induced") as sp:
                r_sub = eng._label_table(sub.graph, ell=sub.ell)
                if tracing:
                    _sync(dev)
            if tracing:
                stage["rwr"] = sp.dur_s
            jobs = [(shape, f"{shape[0]}x{shape[1]}",
                     (lambda b=bucket: b.match(sub.graph, r_sub,
                                               ell=sub.ell)))
                    for shape, bucket in eng.buckets.items()]
            remap = sub.local_to_global
            sub_n, sub_e = sub.n_nodes, sub.n_edges
            r_next = state.r_lab  # full-graph warm start unchanged

    results, t_gray, t_gwait = _run_matches(eng, jobs, obs, tracing)
    with obs.span("engine/device_wait") as sp:
        _sync_mesh(eng)
    elapsed = time.perf_counter() - t0
    if tracing:
        if storm and ecfg.mode != "batch":
            stage["seeds"] = t_seeds
        stage["gray"] = t_gray
        stage["device_wait"] = t_gwait + sp.dur_s
    with obs.span("engine/merge") as sp:
        deltas = eng._merge(results, remap=remap, rebuild=rebuild)
    if tracing:
        stage["merge"] = sp.dur_s
        obs.instant("engine/merge/fanout", rows=eng.last_merge_rows,
                    stores=eng.last_merge_stores,
                    folds=eng.last_merge_folds)

    if ecfg.mode != "batch":
        with obs.span("engine/pem_feedback") as sp:
            community, rl_loss = eng.pem.feedback(g, frac, elapsed)
        if tracing:
            stage["feedback"] = sp.dur_s

    new_state = state.evolve(graph=g, r_lab=r_next, rlab_events=rlab_events,
                             rlab_version=rlab_version,
                             step_idx=state.step_idx + 1)
    out = StepOutput(
        step=state.step_idx, elapsed=elapsed, n_recompute=n_rec,
        frac_affected=frac, community_size=community, rl_loss=rl_loss,
        storm=storm, subgraph_nodes=sub_n, subgraph_edges=sub_e,
        ell_refresh_s=refresh_s, n_pruned=n_pruned, n_events=n_events,
        rlab_cache_hit=rlab_hit, seed_cache_hit=seed_hit,
        rwr_sweeps=eng._last_sweeps,
        rwr_cols_skipped=eng._last_cols_skipped, deltas=deltas,
        stage_s=stage)
    return new_state, out
