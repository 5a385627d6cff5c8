"""Per-standing-query freshness ledger.

The :class:`~repro_torch.runtime.runtime.AckLedger` tracks ONE delivered-lag
frontier for the whole runtime; this module extends the same ack
machinery to the per-query staleness surface a continuous-query serving
system quotes ("how stale is each standing query's match set right
now"):

* every registered standing query — including exact-duplicate *aliases*
  — belongs to a **frontier group**. An alias joins its primary's group
  and therefore shares the primary's frontier exactly (the engine
  evaluates one device row per distinct signature and fans the same
  per-row result to every alias, so their delivered frontiers cannot
  differ — the ledger encodes that as shared state instead of duplicated
  bookkeeping that could drift).
* the executor registers each delivered batch with :meth:`deliver`
  (which queries were fanned out); the batch *completes* through the
  same path the AckLedger uses — immediately when no acking subscribers
  exist, otherwise when every expected ack (or eviction forfeit) has
  arrived. Completion advances the frontier of every group delivered in
  that batch to the batch's newest nominal arrival stamp. Wiring goes
  through ``AckLedger.on_complete``, so freshness semantics are
  definitionally consistent with the closed loop's goodput accounting:
  a batch is "fresh" for a query exactly when its events count toward
  the ack frontier.
* **staleness** of a query at ``now`` is ``now − frontier`` — the age of
  the newest event all of whose induced match-set changes have been
  delivered AND consumed for that query.
* a per-group **SLO burn** integrator accounts, exactly and
  event-driven, the time spent with staleness above ``slo_s`` —
  staleness grows linearly between completions, so the over-SLO span of
  any interval is closed-form — into fast/slow rolling windows.
  ``burn_fast``/``burn_slow`` ∈ [0, 1] are the fraction of the window
  spent over the SLO (the classic fast/slow burn-rate alerting pair:
  fast trips on acute breaches, slow on smolder).

Times are injected (the ledger owns no clock), so under a
``VirtualClock`` every staleness and burn value is a pure function of
the event stream — which is what the oracle tests pin. All state is
host-side; enabling freshness cannot perturb engine stores (pinned
bitwise by the tests).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, NamedTuple, Optional,
                    Set, Tuple)


class QueryFreshness(NamedTuple):
    """One query's freshness snapshot row."""

    qid: str
    primary: str          # frontier-group owner (== qid unless an alias)
    frontier: float       # newest fully-delivered nominal arrival stamp
    staleness_s: float    # now − frontier
    burn_fast: float      # over-SLO fraction of the fast window, [0, 1]
    burn_slow: float      # over-SLO fraction of the slow window, [0, 1]
    n_completed: int      # batches completed against this group


class _Group:
    """Shared frontier + burn accounting for one alias group."""

    __slots__ = ("primary", "frontier", "acct_t", "n_completed",
                 "members", "_burn")

    def __init__(self, primary: str, t0: float):
        self.primary = primary
        self.frontier = t0
        self.acct_t = t0              # burn integrated through here
        self.n_completed = 0
        self.members: Set[str] = set()
        # (t_end, over_slo_seconds) segments, newest last; trimmed to the
        # slow window (the longer one) — both burn rates read from it
        self._burn: Deque[Tuple[float, float]] = deque()

    def account(self, t: float, slo_s: float, slow_window_s: float) -> None:
        """Integrate over-SLO time for (acct_t, t] under the CURRENT
        frontier (call before advancing it)."""
        if t <= self.acct_t:
            return
        crossed = self.frontier + slo_s       # staleness > slo beyond here
        over = t - max(self.acct_t, crossed)
        if over > 0.0:
            self._burn.append((t, over))
        self.acct_t = t
        horizon = t - slow_window_s
        while self._burn and self._burn[0][0] <= horizon:
            self._burn.popleft()

    def burn(self, now: float, window_s: float) -> float:
        lo = now - window_s
        tot = sum(d for (te, d) in self._burn if te > lo)
        return min(tot / max(window_s, 1e-9), 1.0)


class FreshnessLedger:
    """Per-standing-query staleness + freshness-SLO burn (module doc).

    ``resolver`` (optional) maps qid → primary qid for lazy registration:
    a qid first seen at :meth:`deliver` time joins the group the resolver
    names (the runtime wires ``engine.alias_groups``), inheriting that
    group's frontier — mid-stream registrations need no extra plumbing.
    Thread-safe; every method taking a time expects the injected clock's.
    """

    def __init__(self, slo_s: float = 0.5, fast_window_s: float = 5.0,
                 slow_window_s: float = 60.0,
                 telemetry=None,
                 resolver: Optional[Callable[[], Dict[str, str]]] = None,
                 t0: float = 0.0):
        if slow_window_s < fast_window_s:
            raise ValueError(
                f"slow window {slow_window_s} < fast window {fast_window_s}")
        self.slo_s = float(slo_s)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.telemetry = telemetry
        self._resolver = resolver
        self._t0 = float(t0)
        self._lock = threading.Lock()
        self._group_of: Dict[str, _Group] = {}
        self._groups: Dict[str, _Group] = {}     # primary qid → group
        # step → groups delivered in that step (popped exactly once at
        # completion; a duplicate completion for a step is an error)
        self._pending: Dict[int, List[_Group]] = {}
        self.n_breaches = 0     # completions that landed over the SLO

    # -- membership -----------------------------------------------------------

    @classmethod
    def from_engine(cls, engine, t0: float = 0.0, telemetry=None,
                    slo_s: float = 0.5, fast_window_s: float = 5.0,
                    slow_window_s: float = 60.0) -> "FreshnessLedger":
        """Ledger pre-registered with the engine's standing queries,
        alias groups shared per the engine's dedup table, and lazy
        resolution for queries registered later."""
        led = cls(slo_s=slo_s, fast_window_s=fast_window_s,
                  slow_window_s=slow_window_s, telemetry=telemetry,
                  resolver=engine.alias_groups, t0=t0)
        for qid, primary in engine.alias_groups().items():
            led.register(qid, primary=primary, t=t0)
        return led

    def register(self, qid: str, primary: Optional[str] = None,
                 t: Optional[float] = None) -> None:
        """Register a standing query. ``primary`` names the alias group
        to join (an alias inherits — shares — the primary's frontier);
        omitted or self, the query owns a fresh group whose frontier
        starts at ``t``."""
        t = self._t0 if t is None else float(t)
        with self._lock:
            if qid in self._group_of:
                raise ValueError(f"qid {qid!r} already registered")
            self._register_locked(qid, primary, t)

    def _register_locked(self, qid: str, primary: Optional[str],
                         t: float) -> None:
        key = primary if primary is not None else qid
        group = self._groups.get(key)
        if group is None:
            group = _Group(key, t)
            self._groups[key] = group
        group.members.add(qid)
        self._group_of[qid] = group

    def retire(self, qid: str) -> None:
        with self._lock:
            group = self._group_of.pop(qid, None)
            if group is None:
                raise KeyError(f"unknown qid {qid!r}")
            group.members.discard(qid)
            if not group.members:
                del self._groups[group.primary]

    @property
    def qids(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._group_of))

    @property
    def n_groups(self) -> int:
        with self._lock:
            return len(self._groups)

    # -- delivery / completion ------------------------------------------------

    def deliver(self, step: int, qids: List[str]) -> None:
        """Record one executed batch's query fan-out (called by the
        executor right before ``AckLedger.deliver``; completion arrives
        via :meth:`complete`, wired to ``AckLedger.on_complete``)."""
        with self._lock:
            if step in self._pending:
                raise ValueError(f"step {step} already delivered")
            resolved = None
            groups: List[_Group] = []
            seen: Set[int] = set()
            for qid in qids:
                group = self._group_of.get(qid)
                if group is None:   # lazy mid-stream registration
                    if resolved is None:
                        resolved = self._resolver() if self._resolver else {}
                    self._register_locked(qid, resolved.get(qid), self.acct_floor())
                    group = self._group_of[qid]
                if id(group) not in seen:
                    seen.add(id(group))
                    groups.append(group)
            self._pending[step] = groups

    def acct_floor(self) -> float:
        """Registration stamp for lazily-registered queries: the newest
        accounting time any group has reached (0-cost approximation of
        'now' without owning a clock)."""
        return max((g.acct_t for g in self._groups.values()),
                   default=self._t0)

    def complete(self, step: int, arrivals: Tuple[float, ...],
                 t: float) -> None:
        """A delivered batch fully completed (all acks / forfeits in) at
        time ``t``: advance the frontier of every group it touched to
        the batch's newest arrival stamp (exactly once per step)."""
        with self._lock:
            groups = self._pending.pop(step, None)
            if groups is None:
                return   # batch predates the ledger (or freshness off)
            newest = max(arrivals) if arrivals else None
            worst = 0.0
            breach = False
            for g in groups:
                g.account(t, self.slo_s, self.slow_window_s)
                if newest is not None:
                    g.frontier = max(g.frontier, newest)
                g.n_completed += 1
                stal = max(t - g.frontier, 0.0)
                worst = max(worst, stal)
                breach = breach or stal > self.slo_s
            if breach:
                self.n_breaches += 1
            tel = self.telemetry
        if tel is not None and groups:
            tel.record_latency("freshness_staleness", worst)

    # -- views ----------------------------------------------------------------

    def staleness(self, qid: str, now: float) -> float:
        with self._lock:
            group = self._group_of.get(qid)
            if group is None:
                raise KeyError(f"unknown qid {qid!r}")
            return max(now - group.frontier, 0.0)

    def idle_snap(self, now: float, pending: int) -> None:
        """With nothing arrived-but-undelivered anywhere and no batch in
        flight, every query is fully caught up: snap frontiers to ``now``
        (the per-query twin of ``AckLedger.lag``'s idle rule)."""
        with self._lock:
            if pending > 0 or self._pending:
                return
            for g in self._groups.values():
                g.account(now, self.slo_s, self.slow_window_s)
                g.frontier = max(g.frontier, now)

    def worst(self, now: float) -> Tuple[float, float]:
        """(worst staleness, worst fast-window burn) across groups —
        the pair the 2-dim ControllerEnv extension observes."""
        with self._lock:
            stal = max((now - g.frontier for g in self._groups.values()),
                       default=0.0)
            burn = max((g.burn(now, self.fast_window_s)
                        for g in self._groups.values()), default=0.0)
            return max(stal, 0.0), burn

    def snapshot(self, now: float) -> List[QueryFreshness]:
        """Per-query freshness rows, sorted stalest-first then by qid."""
        with self._lock:
            rows = [QueryFreshness(
                qid=qid, primary=g.primary, frontier=g.frontier,
                staleness_s=max(now - g.frontier, 0.0),
                burn_fast=g.burn(now, self.fast_window_s),
                burn_slow=g.burn(now, self.slow_window_s),
                n_completed=g.n_completed)
                for qid, g in self._group_of.items()]
        rows.sort(key=lambda r: (-r.staleness_s, r.qid))
        return rows

    def counters(self) -> Dict[str, Any]:
        """``freshness_*`` telemetry counters (absolutes)."""
        with self._lock:
            return {
                "freshness_queries": len(self._group_of),
                "freshness_groups": len(self._groups),
                "freshness_breaches": self.n_breaches,
                "freshness_pending_batches": len(self._pending),
            }

    def reset(self, t0: float = 0.0) -> None:
        """Clear frontiers/burn back to ``t0`` keeping the membership
        (episode reuse, mirroring ``AckLedger.reset``)."""
        with self._lock:
            self._t0 = float(t0)
            self._pending.clear()
            self.n_breaches = 0
            for g in self._groups.values():
                g.frontier = g.acct_t = self._t0
                g.n_completed = 0
                g._burn.clear()
