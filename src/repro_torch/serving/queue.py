"""Bounded, coalescing update queue — the serving loop's ingress.

Producers offer individual update events (edge add/remove, vertex
relabel); the serving loop drains them in micro-batches and packs one
:class:`~repro_torch.core.graph.UpdateBatch` per step. Two pieces of policy live
here (DESIGN.md §3):

  * back-pressure — the pending window is bounded at ``depth`` events;
    past that ``drop_oldest`` evicts the stalest pending event (freshness
    wins) or ``drop_newest`` rejects the offer (history wins). Either way
    the device never sees an unbounded batch.
  * coalescing — an ``add`` and a ``remove`` of the same arc that meet in
    the pending window annihilate: flapping edges cost zero device work.
    A later relabel of the same vertex supersedes an earlier one.

Everything is host-side and O(1) per event; the queue never touches the device.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, List, NamedTuple, Tuple

import numpy as np

from repro_torch.core.graph import UpdateBatch, to_numpy

ADD = "add"
REMOVE = "remove"
RELABEL = "relabel"


class UpdateEvent(NamedTuple):
    """One stream event. ``add``/``remove`` carry an undirected edge
    (u, v); ``relabel`` carries vertex ``u`` and its new label ``value``."""

    kind: str
    u: int
    v: int = -1
    value: int = -1


class UpdateQueue:
    def __init__(self, depth: int = 4096, policy: str = "drop_oldest",
                 coalesce: bool = True):
        if policy not in ("drop_oldest", "drop_newest"):
            raise ValueError(f"unknown drop policy {policy!r}")
        self.depth = depth
        self.policy = policy
        self.coalesce = coalesce
        self._pending: Deque[UpdateEvent] = deque()
        # live-arc multiplicity of pending add/remove events, for annihilation
        self._edge_balance: Dict[Tuple[int, int], int] = {}
        self._dead: set = set()  # annihilated event identities
        self.n_offered = 0
        self.n_dropped = 0    # total back-pressure casualties (= ev + rej)
        self.n_evicted = 0    # drop_oldest: stale pending events pushed out
        self.n_rejected = 0   # drop_newest: offered events turned away
        self.n_coalesced = 0

    def __len__(self) -> int:
        return len(self._pending) - len(self._dead)

    def _adjust(self, key: Tuple[int, int], delta: int) -> None:
        """Move an edge's pending balance, dropping zeroed entries so the
        dict tracks only edges with in-flight imbalance (bounded by the
        queue depth, not by every edge ever offered)."""
        bal = self._edge_balance.get(key, 0) + delta
        if bal:
            self._edge_balance[key] = bal
        else:
            self._edge_balance.pop(key, None)

    # -- ingress -------------------------------------------------------------

    def offer(self, ev: UpdateEvent) -> bool:
        """Enqueue one event. Returns False iff the event was rejected or
        evicted another (i.e. back-pressure engaged)."""
        self.n_offered += 1
        if self.coalesce and ev.kind in (ADD, REMOVE):
            key = (min(ev.u, ev.v), max(ev.u, ev.v))
            bal = self._edge_balance.get(key, 0)
            if ev.kind == REMOVE and bal > 0:
                # annihilate the youngest pending add of this edge
                self._annihilate(key, ADD)
                self._adjust(key, -1)
                self.n_coalesced += 2
                return True
            if ev.kind == ADD and bal < 0:
                self._annihilate(key, REMOVE)
                self._adjust(key, 1)
                self.n_coalesced += 2
                return True
            self._adjust(key, 1 if ev.kind == ADD else -1)

        accepted = True
        if len(self) >= self.depth:
            self.n_dropped += 1
            if self.policy == "drop_newest":
                self.n_rejected += 1
                self._unbalance(ev)
                return False
            self.n_evicted += 1
            self._evict_oldest()
            accepted = False
        self._pending.append(ev)
        return accepted

    def _unbalance(self, ev: UpdateEvent) -> None:
        if self.coalesce and ev.kind in (ADD, REMOVE):
            key = (min(ev.u, ev.v), max(ev.u, ev.v))
            self._adjust(key, -1 if ev.kind == ADD else 1)

    def _evict_oldest(self) -> None:
        while self._pending:
            ev = self._pending.popleft()
            if id(ev) in self._dead:
                self._dead.discard(id(ev))
                continue
            self._unbalance(ev)
            return

    def _annihilate(self, key: Tuple[int, int], kind: str) -> None:
        """Mark the youngest pending ``kind`` event of edge ``key`` dead."""
        for ev in reversed(self._pending):
            if (ev.kind == kind and id(ev) not in self._dead
                    and (min(ev.u, ev.v), max(ev.u, ev.v)) == key):
                self._dead.add(id(ev))
                return

    # -- egress --------------------------------------------------------------

    def drain(self, window: int) -> List[UpdateEvent]:
        """Pop up to ``window`` live events in arrival order."""
        out: List[UpdateEvent] = []
        while self._pending and len(out) < window:
            ev = self._pending.popleft()
            if id(ev) in self._dead:
                self._dead.discard(id(ev))
                continue
            out.append(ev)
        for ev in out:
            self._unbalance(ev)
        return out

    @staticmethod
    def pack(events: List[UpdateEvent], u_max: int,
             undirected: bool = True, device="cuda") -> UpdateBatch:
        """Coalesced events → one padded UpdateBatch (both arcs per edge)."""
        a_s = [e.u for e in events if e.kind == ADD]
        a_d = [e.v for e in events if e.kind == ADD]
        r_s = [e.u for e in events if e.kind == REMOVE]
        r_d = [e.v for e in events if e.kind == REMOVE]
        # last relabel per vertex wins within the batch
        lab: "OrderedDict[int, int]" = OrderedDict()
        for e in events:
            if e.kind == RELABEL:
                lab[e.u] = e.value
                lab.move_to_end(e.u)
        return UpdateBatch.mixed(
            device=device,
            add_src=np.asarray(a_s, np.int32),
            add_dst=np.asarray(a_d, np.int32),
            rem_src=np.asarray(r_s, np.int32),
            rem_dst=np.asarray(r_d, np.int32),
            lab_ids=np.asarray(list(lab.keys()), np.int32),
            lab_vals=np.asarray(list(lab.values()), np.int32),
            u_max=u_max, undirected=undirected)

    def stats(self) -> Dict[str, int]:
        return {"pending": len(self), "offered": self.n_offered,
                "dropped": self.n_dropped, "evicted": self.n_evicted,
                "rejected": self.n_rejected, "coalesced": self.n_coalesced}


def batch_to_events(upd: UpdateBatch) -> List[UpdateEvent]:
    """Unpack a padded :class:`UpdateBatch` into the stream events that
    would reproduce it. The two arcs of one undirected edge pair up into
    ONE event (multiplicity-aware: a genuinely duplicated edge stays two
    events); relabels pass through. This is the inverse of :meth:`
    UpdateQueue.pack` and the shared ingress path of ``MatchServer.
    submit_update`` and the workload scenario generator."""
    out: List[UpdateEvent] = []
    pending: Dict[Tuple[int, int], int] = {}
    for kind, ss, dd, mm in ((ADD, upd.add_src, upd.add_dst, upd.add_mask),
                             (REMOVE, upd.rem_src, upd.rem_dst,
                              upd.rem_mask)):
        ss, dd, mm = to_numpy(ss), to_numpy(dd), to_numpy(mm)
        pending.clear()
        for u, v in zip(ss[mm], dd[mm]):
            key = (min(int(u), int(v)), max(int(u), int(v)))
            if pending.get(key, 0) > 0:
                pending[key] -= 1  # mirrored arc of an earlier event
                continue
            pending[key] = pending.get(key, 0) + 1
            out.append(UpdateEvent(kind, int(u), int(v)))
    li, lv, lm = (to_numpy(upd.lab_ids), to_numpy(upd.lab_vals),
                  to_numpy(upd.lab_mask))
    for i, val in zip(li[lm], lv[lm]):
        out.append(UpdateEvent(RELABEL, int(i), value=int(val)))
    return out
