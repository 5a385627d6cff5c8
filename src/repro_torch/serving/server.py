"""MatchServer — continuous multi-query match serving.

One server owns a registry of *standing queries* and one update stream.
It is the serving shell around the one :class:`repro_torch.engine.Engine` step
pipeline: per serving step it drains a micro-batch from the bounded
ingress queue, hands the packed :class:`UpdateBatch` to
``engine.step(state, batch)``, and fans the engine's per-query
:class:`~repro_torch.engine.QueryDelta`s out as :class:`MatchDelta`
subscription payloads (StreamWorks-style standing queries).

The server owns ONLY serving concerns — ingress back-pressure/coalescing,
telemetry (p50/p99 step latency, updates/sec, patterns/sec, the engine's
seed-cache hit/miss counters), and dynamic membership (``register``/
``retire`` standing queries mid-stream; inside a padded bucket these are
row writes). The matching pipeline — apply + ELL refresh, PEM mask, induced
extraction, label RWR, per-bucket bank G-Ray sweep, store merge — lives in
``repro_torch.engine.core.engine_step``. The server runs on
``device="cuda"`` unless the caller asks for the CPU; ``devices=`` names
the engine's device mesh (by default every visible device of that type),
which ``ServingConfig.shard``/``graph_shard`` split into a query and a
graph axis.

A restarted server resumes through ``save``/``load`` (the whole engine) or
``save_policy``/``load_policy`` (the learned PEM policy alone); both write
checkpoint directories in the JAX package's layout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import Checkpointer
from repro_torch.config.base import IGPMConfig, ServingConfig
from repro_torch.core.graph import DynamicGraph, UpdateBatch
from repro_torch.core.query import Query
from repro_torch.engine import Engine, EngineState, PatternStore
from repro_torch.serving.queue import UpdateEvent, UpdateQueue, batch_to_events
from repro_torch.serving.telemetry import Telemetry


class MatchDelta(NamedTuple):
    """Per-query result of one serving step."""

    query: str
    n_new: int      # patterns first seen this step
    total: int      # live patterns in the store
    exact: int      # live exact patterns


@dataclass
class ServingStepStats:
    step: int
    elapsed: float          # matching pipeline time (the paper's metric)
    total_s: float          # full serving-step latency: drain → merge —
                            # what p50/p99 step latency means for a server
    n_events: int           # stream events consumed this step
    n_recompute: int
    frac_affected: float
    community_size: int
    rl_loss: float
    deltas: List[MatchDelta] = field(default_factory=list)
    n_pruned: int = 0
    ell_refresh_s: float = 0.0
    subgraph_nodes: int = 0
    subgraph_edges: int = 0
    # back-pressure casualties since the previous step (queue deltas):
    # dropped = evicted (drop_oldest pushed out a stale pending event)
    #         + rejected (drop_newest turned the offer away)
    n_dropped: int = 0
    n_evicted: int = 0
    n_rejected: int = 0

    @property
    def n_new_patterns(self) -> int:
        return sum(d.n_new for d in self.deltas)


class MatchServer:
    """Serve a dynamic bank of standing queries against one update stream."""

    def __init__(self, cfg: IGPMConfig, queries: Sequence[Query],
                 serving: Optional[ServingConfig] = None, seed: int = 0,
                 device="cuda", devices=None):
        serving = serving or ServingConfig()
        self.cfg = cfg
        self.serving = serving
        self.engine = Engine(cfg, serving.engine(), seed=seed, device=device,
                             devices=devices)
        self.device = self.engine.device
        self._qids: List[str] = [self.engine.register(q) for q in queries]
        self.queue = UpdateQueue(depth=serving.queue_depth,
                                 policy=serving.drop_policy,
                                 coalesce=serving.coalesce)
        self.telemetry = Telemetry(
            serving.telemetry_window,
            channel_windows=dict(serving.telemetry_channel_windows))
        # every event lane is padded independently; undirected edges emit
        # two arcs, so a full window of one kind bounds the batch width
        self.u_max = 2 * serving.microbatch_window
        self._state: Optional[EngineState] = None
        self._drops_seen = 0
        self._evicted_seen = 0
        self._rejected_seen = 0

    @property
    def obs(self):
        """The engine's observability hub — the async runtime and the CLI
        share it so one trace spans every thread."""
        return self.engine.obs

    # engine-owned pieces the historical API exposed -------------------------

    @property
    def queries(self) -> Tuple[Query, ...]:
        return tuple(self.engine.query(qid) for qid in self._qids)

    @property
    def stores(self) -> List[PatternStore]:
        return [self.engine.stores[qid] for qid in self._qids]

    @property
    def pem(self):
        return self.engine.pem

    @property
    def step_idx(self) -> int:
        return self._state.step_idx if self._state is not None else 0

    def reset(self) -> None:
        """Clear accumulated serving state — benchmark warm/measure passes
        replay identical streams on one instance."""
        self.engine.reset()
        self.telemetry = Telemetry(
            self.serving.telemetry_window,
            channel_windows=dict(self.serving.telemetry_channel_windows))
        self.queue = UpdateQueue(depth=self.serving.queue_depth,
                                 policy=self.serving.drop_policy,
                                 coalesce=self.serving.coalesce)
        self._state = None
        self._drops_seen = 0
        self._evicted_seen = 0
        self._rejected_seen = 0

    # -- dynamic membership ---------------------------------------------------

    def register(self, query: Query, qid: Optional[str] = None) -> str:
        """Register a standing query mid-stream; inside an existing bucket
        this is a row write."""
        qid = self.engine.register(query, qid=qid)
        self._qids.append(qid)
        return qid

    def retire(self, qid: str) -> None:
        """Retire a standing query (and its pattern store) mid-stream."""
        self.engine.retire(qid)
        self._qids.remove(qid)

    def occupancy(self) -> Dict[Tuple[int, int, int], Tuple[int, int]]:
        """Per-bucket (live rows, padded rows), keyed (q_max, qe_max, B_pad)."""
        return self.engine.occupancy()

    # -- ingress -------------------------------------------------------------

    def submit(self, kind: str, u: int, v: int = -1,
               value: int = -1) -> bool:
        """Offer one stream event; False when back-pressure dropped one."""
        return self.queue.offer(UpdateEvent(kind, u, v, value))

    def submit_update(self, upd: UpdateBatch) -> int:
        """Unpack a padded UpdateBatch into queued events (see
        :func:`~repro_torch.serving.queue.batch_to_events`). Returns events
        queued."""
        events = batch_to_events(upd)
        for ev in events:
            self.queue.offer(ev)
        return len(events)

    # -- the serving step ----------------------------------------------------

    def step(self, g: DynamicGraph) -> Tuple[DynamicGraph, ServingStepStats]:
        """Drain one micro-batch and run the engine pipeline once."""
        t_start = time.perf_counter()
        events = self.queue.drain(self.serving.microbatch_window)
        upd = UpdateQueue.pack(events, self.u_max, device=self.device)
        return self.step_packed(g, upd, len(events), t_start=t_start)

    def step_packed(self, g: DynamicGraph, upd: UpdateBatch, n_events: int,
                    t_start: Optional[float] = None
                    ) -> Tuple[DynamicGraph, ServingStepStats]:
        """Run the engine pipeline on an already-packed micro-batch — the
        handoff point the async runtime's executor thread drives (its
        ingress thread owns the queue and packs). :meth:`step` is drain +
        pack + this, so both paths share every line of engine/merge/
        telemetry bookkeeping."""
        t_start = time.perf_counter() if t_start is None else t_start
        if self._state is None or self._state.graph is not g:
            # fresh stream (or caller-rebuilt graph): re-anchor the state
            self._state = self.engine.init_state(g)
        self._state, out = self.engine.step(self._state, upd)

        q = self.queue
        dropped = q.n_dropped - self._drops_seen
        evicted = q.n_evicted - self._evicted_seen
        rejected = q.n_rejected - self._rejected_seen
        self._drops_seen = q.n_dropped
        self._evicted_seen = q.n_evicted
        self._rejected_seen = q.n_rejected
        st = ServingStepStats(
            step=out.step, elapsed=out.elapsed,
            total_s=time.perf_counter() - t_start, n_events=n_events,
            n_recompute=out.n_recompute, frac_affected=out.frac_affected,
            community_size=out.community_size, rl_loss=out.rl_loss,
            deltas=[MatchDelta(d.name, d.n_new, d.total, d.exact)
                    for d in out.deltas],
            n_pruned=out.n_pruned, ell_refresh_s=out.ell_refresh_s,
            subgraph_nodes=out.subgraph_nodes,
            subgraph_edges=out.subgraph_edges,
            n_dropped=dropped, n_evicted=evicted, n_rejected=rejected)
        self.telemetry.record_step(st.total_s, n_events,
                                   st.n_new_patterns, out.frac_affected,
                                   n_dropped=dropped, n_evicted=evicted,
                                   n_rejected=rejected)
        if out.stage_s:
            # tracing on: stage wall times become telemetry channels, so
            # snapshot() grows p50/p99 per pipeline stage
            for name, dur_s in out.stage_s.items():
                self.telemetry.record_latency(f"stage_{name}", dur_s)
        self.telemetry.record_counters(self.engine.counters())
        return self._state.graph, st

    def run(self, g: DynamicGraph,
            event_batches: Iterable[UpdateBatch] = (),
            max_steps: Optional[int] = None
            ) -> Tuple[DynamicGraph, List[ServingStepStats]]:
        """Feed ``event_batches`` through the queue, one serving step per
        batch, then keep stepping until the queue is drained."""
        stats = []
        for upd in event_batches:
            self.submit_update(upd)
            g, st = self.step(g)
            stats.append(st)
            if max_steps is not None and len(stats) >= max_steps:
                return g, stats
        while len(self.queue) > 0:
            g, st = self.step(g)
            stats.append(st)
            if max_steps is not None and len(stats) >= max_steps:
                break
        return g, stats

    # -- persistence (restarts) ----------------------------------------------

    def save(self, directory: str, step: Optional[int] = None) -> None:
        """Whole-engine checkpoint: graph, warm-start tables, bucket banks,
        PEM/DQN state, pattern stores."""
        if self._state is None:
            raise ValueError("nothing to save before the first step")
        self.engine.save(self._state, directory, step=step)

    def load(self, g: DynamicGraph, directory: str,
             step: Optional[int] = None) -> int:
        """Restore a whole-engine checkpoint (the same queries must be
        registered); the restored graph replaces ``g``."""
        self._state, step = self.engine.load(self.engine.init_state(g),
                                             directory, step=step)
        return step

    @property
    def graph(self) -> Optional[DynamicGraph]:
        return self._state.graph if self._state is not None else None

    # -- policy-only persistence ---------------------------------------------

    def policy_state(self) -> Dict:
        if self.pem is None or self.pem.agent is None:
            raise ValueError("non-adaptive server has no policy to persist")
        return {"agent": self.pem.agent.state_dict(),
                "community_size": np.asarray(self.pem.c, np.int64)}

    def save_policy(self, directory: str,
                    step: Optional[int] = None) -> None:
        """Persist the learned PEM policy (DQN + community threshold) so a
        restarted server resumes with its learned behavior."""
        ckpt = Checkpointer(directory, async_save=False)
        ckpt.save(self.step_idx if step is None else step,
                  self.policy_state())

    def load_policy(self, directory: str,
                    step: Optional[int] = None) -> int:
        ckpt = Checkpointer(directory, async_save=False)
        state, step = ckpt.restore(self.policy_state(), step=step)
        self.pem.agent.load_state_dict(state["agent"])
        self.pem.c = int(state["community_size"])
        return step
