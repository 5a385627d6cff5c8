"""The async serving runtime — threaded ingress + double-buffered executor.

The port's copy of ``repro.runtime.runtime``. ``ServingRuntime`` splits
one :class:`~repro_torch.serving.server.MatchServer` into the two halves a
real-time deployment needs to overlap:

  * the **ingress thread** replays a :class:`~repro_torch.runtime.
    scenarios.Workload` against the injected clock: it offers each tick's events
    into the server's bounded/coalescing ``UpdateQueue``, then assembles
    the tick into micro-batches (window-sized chunks) and pushes the
    packed batches into the handoff. All host-side stream handling —
    drain, coalesce, pack — happens here, overlapped with device work.
  * the **device-executor thread** pops packed batches and runs
    ``MatchServer.step_packed`` (the ONE engine pipeline), fans the
    per-query :class:`~repro_torch.serving.server.MatchDelta`s out to
    subscribers, and stamps queue-wait / end-to-end latencies.

The **handoff** between them is a bounded buffer of staged batches; the
executor pops a batch before running it, so the default depth 1 is the
classic double buffer — one batch in flight on the device while the host
assembles micro-batch *k+1* into the freed slot. (Deeper handoffs trade
tail latency for assembly slack: a staged batch is committed work that
eviction can no longer refresh.) When the executor falls behind,
``RuntimeConfig.ingress`` picks the back-pressure story: ``lockstep``
blocks the ingress push (executor timing never sheds anything — a single
tick larger than ``queue_depth`` can still overflow the bound,
deterministically — and because only the ingress thread ever touches the
queue and assembly points are tick-deterministic, the async store is
bit-identical to the sync replay); ``shed`` keeps ingesting while
pending events pile into the ``UpdateQueue``, where coalescing and the
depth bound drop the overflow (counted, surfaced in telemetry).

Micro-batches are cut at tick boundaries and never merged across whenever
an executor happened to be busy — composition is scheduling-independent,
which is the whole determinism contract: threading changes *when* work
runs, never *what* it computes.

``run_workload_sync`` is the single-threaded reference runner: same
workload, same stamps, same step entry point — the baseline the
sync-vs-async benchmarks and the bit-identical tests compare against.

On the card the executor thread's step is mostly host work (extraction,
merge, the PEM), so the two threads share the interpreter lock; the
overlap is what the runtime offers, not a guaranteed tail-latency gain.
``RuntimeConfig.control.mode`` ``train``/``frozen`` attaches the serving
controller (:mod:`repro_torch.control`), which decides on the ingress
thread at micro-batch boundaries.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.config.base import RuntimeConfig
from repro_torch.core.graph import DynamicGraph, UpdateBatch
from repro_torch.obs import Obs
from repro_torch.obs.freshness import FreshnessLedger
from repro_torch.obs.health import HealthMonitor
from repro_torch.runtime.clock import Clock, VirtualClock, WallClock
from repro_torch.runtime.scenarios import ClosedLoopSource, Workload
from repro_torch.serving.queue import UpdateQueue
from repro_torch.serving.server import (MatchDelta, MatchServer,
                                        ServingStepStats)


class PackedBatch(NamedTuple):
    """One assembled micro-batch in the ingress → executor handoff."""

    upd: UpdateBatch
    n_events: int
    arrivals: Tuple[float, ...]  # nominal arrival stamps of packed events
    t_packed: float
    assembly_s: float
    # monotone per-ingress id — the key that lets a trace follow one
    # batch offer → assemble → handoff → step → delta across threads
    batch_id: int = -1


class _Handoff:
    """Bounded FIFO of packed batches — the double buffer."""

    def __init__(self, depth: int):
        self.depth = depth
        self._items: Deque[PackedBatch] = deque()
        self._cv = threading.Condition()
        self._closed = False

    def wait_space(self, block: bool, interrupt: threading.Event) -> bool:
        """True when a push will succeed. ``block=False`` (shed) just
        peeks; ``block=True`` (lockstep) waits until the executor frees a
        slot or ``interrupt`` fires."""
        with self._cv:
            while len(self._items) >= self.depth and not self._closed:
                if not block or interrupt.is_set():
                    return False
                self._cv.wait(0.05)
            return not self._closed

    def push(self, item: PackedBatch) -> None:
        with self._cv:
            self._items.append(item)
            self._cv.notify_all()

    def pop(self, timeout: float) -> Optional[PackedBatch]:
        with self._cv:
            if not self._items:
                self._cv.wait(timeout)
            if not self._items:
                return None
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)


class Subscription:
    """One subscriber's bounded delta stream (oldest evicted past
    ``depth``; evictions counted — a slow consumer never stalls the
    executor).

    An *acking* subscription (``subscribe(ack=True)``) additionally
    reports consumption back to the runtime's :class:`AckLedger`: the
    consumer calls :meth:`ack` exactly once per delivered item, and the
    runtime's delivered-lag frontier (which closed-loop arrival
    modulation reads) only advances once every acking subscriber has
    acked a batch's deltas. Evicting an undelivered item forfeits its
    ack automatically — a consumer too slow for its buffer still lets
    the frontier move (the loss is already counted in ``n_evicted``)."""

    def __init__(self, query: Optional[str], depth: int,
                 ledger: Optional["AckLedger"] = None,
                 sub_id: int = -1, clock: Optional[Clock] = None):
        self.query = query
        self._items: Deque[Tuple[int, MatchDelta]] = deque()
        self.depth = depth
        self.n_evicted = 0
        self._cv = threading.Condition()
        self._ledger = ledger
        self.sub_id = sub_id
        self._clock = clock

    @property
    def acking(self) -> bool:
        return self._ledger is not None

    def _put(self, step: int, delta: MatchDelta) -> None:
        evicted = None
        with self._cv:
            if len(self._items) >= self.depth:
                evicted = self._items.popleft()
                self.n_evicted += 1
            self._items.append((step, delta))
            self._cv.notify_all()
        if evicted is not None and self._ledger is not None:
            self._ledger.ack(self.sub_id, evicted[0], self._clock.now())

    def ack(self, item: Tuple[int, MatchDelta]) -> None:
        """Acknowledge one delivered ``(step, delta)`` item (acking
        subscriptions only; exactly once per item — a double ack
        raises)."""
        if self._ledger is None:
            raise ValueError("not an acking subscription "
                             "(subscribe(ack=True))")
        self._ledger.ack(self.sub_id, item[0], self._clock.now())

    def get(self, timeout: float = 1.0) -> Optional[Tuple[int, MatchDelta]]:
        with self._cv:
            if not self._items:
                self._cv.wait(timeout)
            return self._items.popleft() if self._items else None

    def drain(self) -> List[Tuple[int, MatchDelta]]:
        with self._cv:
            out = list(self._items)
            self._items.clear()
            return out


class AckLedger:
    """Delivered-delta ack accounting — the closed loop's sensor.

    The executor registers each executed batch with :meth:`deliver`
    (``expected`` maps acking-subscriber id → deltas delivered to it; an
    empty map means no acking subscribers and the batch auto-completes —
    prompt-consumer semantics, what the closed-loop runners use). A batch
    *completes* when every expected ack arrived; completion

      * advances the **frontier** — the newest nominal arrival stamp all
        of whose work is consumed. Delivered lag is ``now - frontier``:
        it grows monotonically while an executor stalls and resets only
        as completions catch up, which is exactly the signal the
        closed-loop arrival modulation and the controller read.
      * scores the batch's events against the ack-latency SLO
        (``n_good`` / ``n_viol`` — the goodput curve), and records
        ``ack_lag`` latency samples when a telemetry sink is attached.

    Thread-safe; times are passed in (the ledger owns no clock).
    """

    def __init__(self, slo_s: float = 0.25):
        self.slo_s = slo_s
        self.telemetry = None          # optional; set by the runtime
        # batch-completion hook: called as (step, arrivals, t) after the
        # frontier advances — the per-query FreshnessLedger rides here so
        # its staleness semantics are definitionally the ack semantics
        # (a batch is fresh for a query exactly when its events count
        # toward the frontier, eviction forfeits included)
        self.on_complete = None
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[Tuple[float, ...], Dict[int, int]]] = {}
        self._frontier = 0.0
        self.n_delivered = 0           # deltas handed to acking subscribers
        self.n_acked = 0               # acks received (incl. forfeits)
        self.n_events_acked = 0        # events in completed batches
        self.n_good = 0                # ... acked within slo_s of arrival
        self.n_viol = 0                # ... acked late (SLO violations)

    def deliver(self, step: int, arrivals: Tuple[float, ...], t: float,
                expected: Dict[int, int]) -> None:
        with self._lock:
            self.n_delivered += sum(expected.values())
            if expected:
                self._pending[step] = (arrivals, dict(expected))
            else:
                self._complete(step, arrivals, t)

    def ack(self, sub_id: int, step: int, t: float) -> None:
        with self._lock:
            entry = self._pending.get(step)
            if entry is None or entry[1].get(sub_id, 0) <= 0:
                raise ValueError(
                    f"double (or unknown) ack: sub {sub_id} step {step}")
            arrivals, left = entry
            left[sub_id] -= 1
            self.n_acked += 1
            if all(v == 0 for v in left.values()):
                del self._pending[step]
                self._complete(step, arrivals, t)

    def _complete(self, step: int, arrivals: Tuple[float, ...],
                  t: float) -> None:
        for a in arrivals:
            if t - a <= self.slo_s:
                self.n_good += 1
            else:
                self.n_viol += 1
        self.n_events_acked += len(arrivals)
        if arrivals:
            self._frontier = max(self._frontier, max(arrivals))
        if self.telemetry is not None and arrivals:
            self.telemetry.record_latency("ack_lag",
                                          *(t - a for a in arrivals))
        if self.on_complete is not None:
            self.on_complete(step, arrivals, t)

    def reset(self) -> None:
        """Clear all accounting (train-then-freeze runs reuse one ledger
        across episodes and measure only the final frozen run); the
        ``on_complete`` hook survives."""
        with self._lock:
            self._pending.clear()
            self._frontier = 0.0
            self.n_delivered = self.n_acked = 0
            self.n_events_acked = self.n_good = self.n_viol = 0

    def lag(self, now: float, pending: int = 1) -> float:
        """Delivered lag at ``now``. ``pending`` is the caller's count of
        arrived-but-undelivered work; when nothing is pending anywhere
        the frontier snaps to ``now`` (an idle server has zero lag)."""
        with self._lock:
            if pending == 0 and not self._pending:
                self._frontier = max(self._frontier, now)
            return max(now - self._frontier, 0.0)

    @property
    def outstanding(self) -> int:
        """Delivered-but-uncompleted batches."""
        with self._lock:
            return len(self._pending)

    def summary(self, duration_s: float) -> Dict[str, float]:
        """Goodput / SLO-violation rollup over a run of ``duration_s``."""
        with self._lock:
            acked = max(self.n_events_acked, 1)
            dur = max(duration_s, 1e-9)
            return {
                "events_acked": float(self.n_events_acked),
                "goodput_eps": self.n_good / dur,
                "viol_eps": self.n_viol / dur,
                "viol_rate": self.n_viol / acked,
                "slo_s": self.slo_s,
            }


class RuntimeKnobs:
    """The live runtime knobs — the controller's actuators.

    The ingress reads ``window`` at every assembly; ``queue_depth``
    writes through to the server's ``UpdateQueue`` bound (the shed
    threshold); ``rwr_tol`` swaps the engine config. With no controller
    nothing ever writes these and every value is exactly the static
    config's.
    """

    def __init__(self, server: MatchServer):
        self._server = server
        self.window = server.serving.microbatch_window
        self.queue_depth = server.queue.depth
        self.rwr_tol = server.engine.cfg.rwr_tol

    def set_window(self, window: int) -> None:
        # u_max bounds the packed-batch arrays
        self.window = max(1, min(int(window), self._server.u_max))

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth = max(1, int(depth))
        self._server.queue.depth = self.queue_depth

    def set_rwr_tol(self, tol: float) -> None:
        self.rwr_tol = float(tol)
        eng = self._server.engine
        if eng.cfg.rwr_tol != self.rwr_tol:
            eng.cfg = dataclasses.replace(eng.cfg, rwr_tol=self.rwr_tol)

    def apply(self) -> None:
        """Re-assert the knob values on the server (``MatchServer.reset``
        rebinds the queue; a fresh run must start from the knob state,
        not the orphaned pre-reset queue's)."""
        self._server.queue.depth = self.queue_depth
        if self._server.engine.cfg.rwr_tol != self.rwr_tol:
            self._server.engine.cfg = dataclasses.replace(
                self._server.engine.cfg, rwr_tol=self.rwr_tol)


class _StampedIngress:
    """The server's UpdateQueue plus a parallel ring of nominal arrival
    stamps, kept count-consistent through offers, coalescing annihilation,
    back-pressure eviction, and drains (annihilation pops the newest
    stamp, eviction the oldest — the stamp-to-event pairing is
    approximate under coalescing, the counts are exact). Packed batches
    land on ``device``, the server's."""

    def __init__(self, queue: UpdateQueue, device="cuda"):
        self.queue = queue
        self.device = device
        self._stamps: Deque[float] = deque()
        self._next_batch = 0  # deterministic: counts assembled batches

    def offer(self, ev, t_arrival: float) -> bool:
        before = len(self.queue)
        ok = self.queue.offer(ev)
        delta = len(self.queue) - before
        if delta == 1:             # entered and stayed pending
            self._stamps.append(t_arrival)
        elif delta == -1:          # annihilated a pending opposite event
            if self._stamps:
                self._stamps.pop()
        elif not ok and self.queue.policy == "drop_oldest":
            # overflow: the stalest pending event was evicted for this one
            if self._stamps:
                self._stamps.popleft()
            self._stamps.append(t_arrival)
        # remaining case — drop_newest rejection: nothing entered
        return ok

    def assemble(self, window: int, u_max: int,
                 t_packed: float) -> Optional[PackedBatch]:
        """Drain one window-sized chunk into a packed batch."""
        if len(self.queue) == 0:
            return None
        t0 = time.perf_counter()
        events = self.queue.drain(window)
        stamps = tuple(self._stamps.popleft() if self._stamps else t_packed
                       for _ in events)
        upd = UpdateQueue.pack(events, u_max, device=self.device)
        batch_id = self._next_batch
        self._next_batch += 1
        return PackedBatch(upd, len(events), stamps, t_packed,
                           time.perf_counter() - t0, batch_id)

    def __len__(self) -> int:
        return len(self.queue)


def _record_batch_latencies(tel, item: PackedBatch, t_done: float) -> None:
    """Stamp one executed batch's latency channels — shared by the async
    executor and the sync reference runner so the sync-vs-async benchmark
    always compares structurally identical channels."""
    tel.record_latency("assembly", item.assembly_s)
    tel.record_latency("queue_wait",
                       *(item.t_packed - a for a in item.arrivals))
    tel.record_latency("e2e", *(t_done - a for a in item.arrivals))


class ServingRuntime:
    """Threaded async serving around one MatchServer (module docstring)."""

    def __init__(self, server: MatchServer,
                 rcfg: Optional[RuntimeConfig] = None,
                 clock: Optional[Clock] = None):
        if rcfg is not None:
            if rcfg.ingress not in ("lockstep", "shed"):
                raise ValueError(f"unknown ingress policy {rcfg.ingress!r}")
            if rcfg.handoff_depth < 1:
                raise ValueError(
                    f"handoff_depth must be >= 1 (one staged batch is the "
                    f"double buffer), got {rcfg.handoff_depth}")
            if rcfg.n_executors < 1:
                raise ValueError(f"n_executors must be >= 1, "
                                 f"got {rcfg.n_executors}")
        self.server = server
        self.rcfg = rcfg or RuntimeConfig()
        self.clock = clock or WallClock()
        self.telemetry = server.telemetry
        if self.rcfg.obs is not None:
            # runtime-level override: rebuild the shared hub so engine,
            # ingress, and executor spans land in ONE event stream
            server.engine.obs = Obs(self.rcfg.obs)
        self.obs = server.obs
        self.stats: List[ServingStepStats] = []
        self._ingress = _StampedIngress(server.queue, server.device)
        self._handoff = _Handoff(self.rcfg.handoff_depth)
        self._subs: List[Subscription] = []
        self._stop_now = threading.Event()     # abort: drop in-flight work
        self._stop_ingest = threading.Event()  # any stop: halt/wake pacing
        self._threads: List[threading.Thread] = []
        self._graph: Optional[DynamicGraph] = None
        self._exc: List[BaseException] = []
        self.n_checkpoints = 0
        # closed-loop plumbing: knob indirection + ack accounting always
        # exist (inert without acking subscribers / closed-loop workloads);
        # the controller only when asked for — mode='off' constructs
        # nothing that could perturb the runtime
        self.knobs = RuntimeKnobs(server)
        self.acks = AckLedger(slo_s=self.rcfg.control.slo_e2e_s)
        self._last_service_s = 0.0     # clock-time of the last device step
        self._n_batches = 0
        self.controller = None
        # freshness / watchdog / ops surface — all
        # host-side, all off by default; ocfg is the runtime-level
        # ObsConfig override when given, else the engine hub's
        ocfg = self.rcfg.obs if self.rcfg.obs is not None else self.obs.cfg
        self.obs_cfg = ocfg
        self.freshness: Optional[FreshnessLedger] = None
        if ocfg.freshness:
            self.freshness = FreshnessLedger.from_engine(
                server.engine, t0=self.clock.now(),
                telemetry=self.telemetry, slo_s=ocfg.freshness_slo_s,
                fast_window_s=ocfg.freshness_fast_s,
                slow_window_s=ocfg.freshness_slow_s)
            # completion (every expected ack or forfeit in) is the ONE
            # moment per-query frontiers may advance — ride the ack path
            self.acks.on_complete = self.freshness.complete
        self.health: Optional[HealthMonitor] = None
        if ocfg.watchdog:
            self.health = HealthMonitor(
                clock=self.clock, period_s=ocfg.watchdog_period_s,
                stall_after_s=ocfg.stall_after_s,
                queue_high_frac=ocfg.queue_high_frac,
                queue_dwell_periods=ocfg.queue_dwell_periods,
                partition_near_frac=ocfg.partition_near_frac,
                burn_degraded=ocfg.burn_degraded,
                obs=self.obs, freshness=self.freshness)
            self.health.attach_queue(
                lambda: min(len(self.server.queue)
                            / max(self.knobs.queue_depth, 1), 1.0))
            self.health.attach_partition(server.engine.partition_occupancy)
            self.health.attach_pending(
                lambda: len(self._ingress) + len(self._handoff))
        self.ops = None                # OpsServer, bound at start()
        if self.rcfg.control.mode != "off":
            from repro_torch.control import ServingController  # no cycle
            self.controller = ServingController(
                server, self.knobs, self.acks, self.rcfg.control,
                freshness=self.freshness)
            server.engine.control = self.controller

    # -- subscriptions --------------------------------------------------------

    def subscribe(self, query: Optional[str] = None,
                  ack: bool = False) -> Subscription:
        """Stream ``(step, MatchDelta)`` pairs; ``query`` filters by
        standing-query name (None = all). ``ack=True`` makes it an
        *acking* subscription: the consumer must :meth:`Subscription.ack`
        each item exactly once, and the runtime's delivered-lag frontier
        waits on it (closed-loop semantics)."""
        sub = Subscription(query, self.rcfg.subscriber_depth,
                           ledger=self.acks if ack else None,
                           sub_id=len(self._subs), clock=self.clock)
        self._subs.append(sub)
        return sub

    # -- lifecycle ------------------------------------------------------------

    def start(self, workload: Workload) -> None:
        if self._threads:
            raise RuntimeError("runtime already started")
        # re-read the server's queue/telemetry: MatchServer.reset()
        # rebinds both, and a runtime constructed before a reset must not
        # keep feeding the orphaned pre-reset queue (the drop counters
        # would silently desync from the one step_packed reads)
        self._ingress = _StampedIngress(self.server.queue, self.server.device)
        self.telemetry = self.server.telemetry
        if self.freshness is not None:
            self.freshness.telemetry = self.telemetry
        self.knobs.apply()  # re-assert knob state on the (maybe new) queue
        self._start_obs_services()
        if self.controller is not None:
            self.controller.begin_episode()
        if workload.scenario.closed_loop:
            self.acks.slo_s = workload.scenario.ack_slo_s
            self.acks.telemetry = self.telemetry
        self._graph = workload.graph
        # multi-executor scale-out: the single rt-executor
        # thread keeps the staged-handoff/step ordering, but fans each
        # step's independent per-bucket matches across an engine-level
        # pool — results join in bucket order before subscriber delivery,
        # so the store stays bit-identical to n_executors=1
        self.server.engine.set_executor_pool(self.rcfg.n_executors)
        t_in = threading.Thread(target=self._guard, name="rt-ingress",
                                args=(self._ingress_main, workload))
        t_ex = threading.Thread(target=self._guard, name="rt-executor",
                                args=(self._executor_main,))
        self._threads = [t_in, t_ex]
        for t in self._threads:
            t.start()

    def serve(self, workload: Workload) -> List[ServingStepStats]:
        """Blocking convenience: start, replay the whole workload, drain,
        checkpoint (when configured), join. Returns the per-step stats."""
        self.start(workload)
        if not self.join(timeout=self.rcfg.drain_timeout_s
                         + workload.scenario.duration_s):
            self.stop(drain=False)
            raise TimeoutError("serving runtime did not finish the workload")
        return self.stats

    def stop(self, drain: bool = True) -> bool:
        """Stop serving. ``drain=True`` flushes every accepted event
        through the pipeline first (bounded by ``drain_timeout_s``), then
        checkpoints; ``drain=False`` aborts in place."""
        if drain:
            self._stop_ingest.set()
            if self.join(timeout=self.rcfg.drain_timeout_s):
                return True
        self._stop_now.set()
        self._stop_ingest.set()
        # even an abort must wait out the one in-flight device step, which
        # cannot be interrupted
        return self.join(timeout=self.rcfg.drain_timeout_s)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for both threads; True when the runtime fully stopped."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            t.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
        alive = any(t.is_alive() for t in self._threads)
        if not alive:
            # fully stopped: record freshness rollups, then take down the
            # monitor/ops threads (a stalled runtime keeps both up — the
            # ops surface is most valuable exactly then)
            self._stop_obs_services()
            if self._exc:
                raise self._exc[0]
        return not alive

    def _start_obs_services(self) -> None:
        ocfg = self.obs_cfg
        if self.health is not None and ocfg.watchdog_period_s > 0 \
                and self.health._thread is None:
            self.health.start()
        if self.ops is None and ocfg.metrics_port >= 0:
            from repro_torch.obs.serve import OpsServer  # http only if used
            self.ops = OpsServer(
                snapshot=self.ops_snapshot,
                health=(self.health.status
                        if self.health is not None else None),
                freshness=((lambda: self.freshness.snapshot(
                    self.clock.now()))
                    if self.freshness is not None else None),
                flight=lambda: self.obs.flight_dump(reason="ops"),
                port=ocfg.metrics_port).start()

    def _stop_obs_services(self) -> None:
        if self.freshness is not None and self.telemetry is not None:
            self.telemetry.record_counters(self.freshness.counters())
        if self.health is not None:
            self.health.close()
        if self.ops is not None:
            self.ops.close()
            self.ops = None

    def ops_snapshot(self) -> Dict[str, float]:
        """Telemetry snapshot + live ``freshness_*`` counters — what the
        ``/metrics`` scrape renders."""
        snap = dict(self.telemetry.snapshot())
        if self.freshness is not None:
            snap.update(self.freshness.counters())
        return snap

    @property
    def graph(self) -> Optional[DynamicGraph]:
        return self._graph

    # -- thread bodies --------------------------------------------------------

    def _guard(self, fn, *args) -> None:
        try:
            fn(*args)
        except BaseException as e:  # surface thread crashes to join()
            self._exc.append(e)
            self._stop_now.set()
            self._stop_ingest.set()
            self._handoff.close()
            try:
                # post-mortem: dump the flight ring before anything else
                # tears down (no-op unless tracing + flight configured)
                self.obs.flight_dump(
                    reason=f"crash:{type(e).__name__}: {e}", triggered=True)
            except Exception:
                pass  # never let the post-mortem mask the real crash

    def _flush(self, block: bool) -> None:
        """Assemble pending events into packed batches while the handoff
        (and lockstep policy) allows. Reads the micro-batch window from
        the live knobs; the controller's decision hook runs here, on the
        ingress thread, at batch boundaries."""
        obs = self.obs
        while len(self._ingress) > 0 and not self._stop_now.is_set():
            # handoff occupancy: in lockstep this span IS the time the
            # ingress spent blocked on a busy executor
            with obs.span("ingress/handoff_wait", staged=len(self._handoff)):
                ok = self._handoff.wait_space(block, self._stop_now)
            if not ok:
                return
            with obs.span("ingress/assemble", pending=len(self._ingress)):
                item = self._ingress.assemble(self.knobs.window,
                                              self.server.u_max,
                                              self.clock.now())
            if item is None:
                return
            obs.instant("ingress/packed", batch=item.batch_id,
                        n_events=item.n_events)
            self._handoff.push(item)
            self._n_batches += 1
            if self.controller is not None:
                self.controller.on_batch(item.n_events,
                                         self._last_service_s,
                                         self.clock.now())

    def _ingress_main(self, workload: Workload) -> None:
        lockstep = self.rcfg.ingress == "lockstep"
        sc = workload.scenario
        if sc.closed_loop:
            # closed loop: ticks are generated online, throttled by the
            # delivered-lag frontier (clients back off a laggy server)
            src = ClosedLoopSource(workload)
            self.closed_src = src
            self.acks.closed_src = src   # the binding run_closed_loop uses
            for i in range(sc.n_ticks):
                if self._stop_ingest.is_set():
                    break
                self.clock.wait_until(i * sc.tick_s, self._stop_ingest)
                if self._stop_ingest.is_set():
                    break
                if self.health is not None:
                    self.health.beat("ingress", self.clock.now())
                lag = self.acks.lag(
                    self.clock.now(),
                    pending=len(self._ingress) + len(self._handoff))
                events = src.emit(i, lag)
                with self.obs.span("ingress/offer", n_events=len(events),
                                   lag_ms=1e3 * lag):
                    for ev in events:
                        self._ingress.offer(ev, i * sc.tick_s)
                self._flush(block=lockstep)
                if src.exhausted:
                    break
        else:
            for tick in workload.ticks:
                if self._stop_ingest.is_set():
                    break
                self.clock.wait_until(tick.t, self._stop_ingest)
                if self._stop_ingest.is_set():
                    break
                if self.health is not None:
                    self.health.beat("ingress", self.clock.now())
                with self.obs.span("ingress/offer",
                                   n_events=len(tick.events)):
                    for ev in tick.events:
                        # nominal arrival stamp: open-loop arrivals, so a
                        # late ingress can't hide queueing delay (no
                        # coordinated omission)
                        self._ingress.offer(ev, tick.t)
                self._flush(block=lockstep)
        # graceful drain: everything still pending goes through, with
        # blocking pushes (the executor is consuming; stop(drain=False)
        # interrupts via _stop_now)
        if not self._stop_now.is_set():
            self._flush(block=True)
        if self.controller is not None and not self._stop_now.is_set():
            self.controller.end_episode(self.clock.now())
        self._handoff.close()
        if self.health is not None:   # clean exit: drained ≠ stalled
            self.health.set_inactive("ingress")

    def _executor_main(self) -> None:
        srv = self.server
        obs = self.obs
        g = self._graph
        every = self.rcfg.checkpoint_every
        while not self._stop_now.is_set():
            if self.health is not None:
                self.health.beat("executor", self.clock.now())
            item = self._handoff.pop(timeout=0.05)
            if item is None:
                if self._handoff.closed and len(self._handoff) == 0:
                    break
                continue
            with obs.context(batch=item.batch_id):
                t_exec0 = self.clock.now()
                with obs.span("executor/step", n_events=item.n_events):
                    g, st = srv.step_packed(g, item.upd, item.n_events)
                self._graph = g
                t_done = self.clock.now()
                self._last_service_s = t_done - t_exec0
                _record_batch_latencies(self.telemetry, item, t_done)
                if obs.enabled and item.arrivals:
                    obs.observe_e2e(1e3 * (t_done - min(item.arrivals)))
                with obs.span("executor/fanout", n_deltas=len(st.deltas),
                              n_subs=len(self._subs)):
                    self.stats.append(st)
                    # register expected acks BEFORE fan-out: an acking
                    # subscriber (or its eviction forfeit) may respond
                    # the moment an item lands in its buffer
                    expected: Dict[int, int] = {}
                    for sub in self._subs:
                        if sub.acking:
                            n = sum(1 for d in st.deltas
                                    if sub.query is None
                                    or sub.query == d.query)
                            if n:
                                expected[sub.sub_id] = n
                    if self.freshness is not None:
                        # the per-query fan-out of this batch, recorded
                        # BEFORE deliver: expected={} completes inside it
                        self.freshness.deliver(
                            st.step, [d.query for d in st.deltas])
                    self.acks.deliver(st.step, item.arrivals, t_done,
                                      expected)
                    for sub in self._subs:
                        for d in st.deltas:
                            if sub.query is None or sub.query == d.query:
                                sub._put(st.step, d)
            if every > 0 and self.rcfg.checkpoint_dir \
                    and len(self.stats) % every == 0:
                srv.save(self.rcfg.checkpoint_dir)
                self.n_checkpoints += 1
        if (not self._stop_now.is_set() and self.rcfg.checkpoint_dir
                and srv._state is not None):
            # drain checkpoint: the whole engine (graph, banks, PEM/DQN,
            # stores) via Engine.save — a restarted runtime resumes here
            srv.save(self.rcfg.checkpoint_dir)
            self.n_checkpoints += 1
        srv.engine.set_executor_pool(1)  # drain the match fan-out pool
        if self.health is not None:
            self.health.set_inactive("executor")

    def closed_summary(self, workload: Workload) -> Dict[str, float]:
        """Goodput / SLO-violation rollup of a closed-loop run (plus the
        source's offered/throttled accounting when available)."""
        out = self.acks.summary(workload.scenario.duration_s)
        src = getattr(self, "closed_src", None)
        if src is not None:
            out["events_offered"] = float(src.n_offered)
            out["events_throttled"] = float(src.n_throttled)
        return out


def run_workload_sync(server: MatchServer, workload: Workload,
                      clock: Optional[Clock] = None, ingest: str = "open"
                      ) -> Tuple[DynamicGraph, List[ServingStepStats]]:
    """The synchronous reference runner: identical workload replay, event
    stamps, chunking rule, queue bound, and ``step_packed`` entry point —
    but ingress and device execution interleave on ONE thread.

    ``ingest`` picks which single-threaded server this models:

    * ``"open"`` — between device steps, every tick whose nominal time
      has passed is offered into the bounded queue, where coalescing and
      the depth bound shed overload exactly as they do for the async
      runtime (a poll-between-steps server). The strongest sync baseline:
      same queue bound, same window chunking over whatever is pending
      (under backlog both it and the shed-mode runtime pack batches that
      span ticks) — what it lacks is only the ingress/execution overlap.
    * ``"closed"`` — the pre-runtime ``MatchServer`` serving loop: each
      tick is ingested only once the whole prior backlog has been
      processed, so the server never *sees* arrivals while it is busy.
      Overload therefore accumulates as unbounded pacing lag the queue
      bound cannot shed — the structural deficiency the async runtime
      exists to fix, kept here as the historical baseline the benchmark
      quotes.

    Under a ``VirtualClock`` the two modes coincide (time only advances
    when the queue runs dry), and batch composition is per-tick
    deterministic — identical to the lockstep async runtime's, the
    property the bit-identical tests build on."""
    if ingest not in ("open", "closed"):
        raise ValueError(f"unknown ingest mode {ingest!r}")
    clock = clock or VirtualClock()
    ingress = _StampedIngress(server.queue, server.device)
    window = server.serving.microbatch_window
    never = threading.Event()
    tel = server.telemetry
    g = workload.graph
    stats: List[ServingStepStats] = []
    ticks = workload.ticks
    ti = 0
    while ti < len(ticks) or len(ingress) > 0:
        if ti < len(ticks) and len(ingress) == 0:
            clock.wait_until(ticks[ti].t, never)   # idle until next arrival
        if ingest == "open":
            now = clock.now()
            while ti < len(ticks) and ticks[ti].t <= now:
                for ev in ticks[ti].events:
                    ingress.offer(ev, ticks[ti].t)
                ti += 1
        elif len(ingress) == 0:    # closed: one tick at a time, backlog
            for ev in ticks[ti].events:   # first (already waited above)
                ingress.offer(ev, ticks[ti].t)
            ti += 1
        if len(ingress) == 0:
            continue
        item = ingress.assemble(window, server.u_max, clock.now())
        g, st = server.step_packed(g, item.upd, item.n_events)
        _record_batch_latencies(tel, item, clock.now())
        stats.append(st)
    return g, stats


def sim_service_model(base_s: float = 0.15, per_event_s: float = 6.6e-4):
    """Deterministic per-batch service-time model for simulated closed
    loops: ``t(batch) = base_s + per_event_s · n_events`` — a fixed
    per-step engine cost (shared sweeps over the whole graph) plus a
    per-event increment. The defaults are calibrated from wall-clock
    measurements of the JAX package's n=512 serving benchmark on a CPU
    (window-256 capacity ≈ 800 events/s, window-32 ≈ 185/s), kept
    unchanged so simulated runs of the two packages agree."""
    def model(n_events: int) -> float:
        return base_s + per_event_s * max(int(n_events), 0)
    return model


def run_closed_loop(server: MatchServer, workload: Workload,
                    clock: Optional[Clock] = None,
                    controller=None,
                    knobs: Optional[RuntimeKnobs] = None,
                    ledger: Optional[AckLedger] = None,
                    service_model=None,
                    freshness: Optional[FreshnessLedger] = None
                    ) -> Tuple[DynamicGraph, List[ServingStepStats],
                               AckLedger]:
    """Single-threaded closed-loop reference runner.

    Ticks are generated online by a :class:`~repro_torch.runtime.scenarios.
    ClosedLoopSource` — arrivals throttle on delivered lag — and every
    executed batch is delivered and immediately acked (prompt-consumer
    semantics, the ``expected={}`` auto-ack path of :class:`AckLedger`).
    The optional ``controller`` (a ``repro_torch.control.
    ServingController``) gets the same ``on_batch``/``end_episode`` hooks
    the threaded runtime's ingress gives it, so training and deterministic
    evaluation both run here: under a ``VirtualClock`` the whole run — lag
    sequence, Poisson draws, observations, frozen-policy actions — is a
    pure function of the seeds, which is what the replay-repeatability
    tests pin. Under a ``WallClock`` lag is real and the goodput/SLO summary
    (returned via the ledger) is the closed-loop benchmark metric.

    ``service_model`` (optional, requires a :class:`VirtualClock`): a
    ``n_events -> seconds`` callable (e.g. :func:`sim_service_model`);
    after each executed batch the clock is advanced by the modeled
    service time, so queueing dynamics — backlog, delivered lag,
    throttling, SLO violations — unfold deterministically against a
    fixed service-rate model instead of this machine's noisy wall
    clock. That is what the control benchmark gates on: scores become
    a pure function of the seeds and the model, reproducible across
    runs and machines.

    ``freshness`` (optional): a :class:`~repro_torch.obs.freshness.
    FreshnessLedger` to feed — per-batch query fan-out recorded before
    delivery, completion via the ledger's ``on_complete`` hook — giving
    deterministic per-query staleness traces under a ``VirtualClock``
    (what ``serving_bench``'s freshness rows and the oracle tests use).

    Returns ``(graph, stats, ledger)``.
    """
    sc = workload.scenario
    clock = clock or VirtualClock()
    if service_model is not None and not isinstance(clock, VirtualClock):
        raise ValueError("service_model requires a VirtualClock (the "
                         "model drives time; a wall clock would fight it)")
    knobs = knobs or RuntimeKnobs(server)
    knobs.apply()
    if controller is not None:
        controller.begin_episode()
    if ledger is None:
        ledger = AckLedger(slo_s=sc.ack_slo_s)
    ledger.telemetry = server.telemetry
    if freshness is not None:
        freshness.telemetry = server.telemetry
        ledger.on_complete = freshness.complete
    src = ClosedLoopSource(workload)
    ledger.closed_src = src
    ingress = _StampedIngress(server.queue, server.device)
    never = threading.Event()
    g = workload.graph
    stats: List[ServingStepStats] = []
    i = 0
    while i < sc.n_ticks or len(ingress) > 0:
        if len(ingress) == 0 and i < sc.n_ticks:
            clock.wait_until(i * sc.tick_s, never)
        now = clock.now()
        while i < sc.n_ticks and i * sc.tick_s <= now:
            lag = ledger.lag(clock.now(), pending=len(ingress))
            for ev in src.emit(i, lag):
                ingress.offer(ev, i * sc.tick_s)
            i += 1
        if len(ingress) == 0:
            continue
        item = ingress.assemble(knobs.window, server.u_max, clock.now())
        t0 = clock.now()
        g, st = server.step_packed(g, item.upd, item.n_events)
        if service_model is not None:
            clock.advance_to(t0 + float(service_model(item.n_events)))
        t1 = clock.now()
        _record_batch_latencies(server.telemetry, item, t1)
        if freshness is not None:
            freshness.deliver(st.step, [d.query for d in st.deltas])
        ledger.deliver(st.step, item.arrivals, t1, expected={})
        stats.append(st)
        if controller is not None:
            controller.on_batch(item.n_events, t1 - t0, clock.now())
    if controller is not None:
        controller.end_episode(clock.now())
    return g, stats, ledger
