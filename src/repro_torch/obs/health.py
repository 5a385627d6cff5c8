"""Health watchdog — heartbeats, stall/saturation detectors, readiness.

The flight recorder makes failures explainable *post mortem*; this
module makes them visible *live*. A low-rate monitor evaluates four
detectors against state the serving threads already maintain:

* **executor/ingress stall** — each runtime thread stamps a heartbeat
  once per loop iteration; a registered-active heartbeat older than
  ``stall_after_s`` flips readiness to ``stalled`` (a wedged device
  step, a deadlocked handoff, a hung ingress). Threads deregister on
  clean exit, so a drained runtime is not a stalled one.
* **queue-saturation dwell** — instantaneous queue fill is normal under
  bursts; the detector only fires after the fill fraction has stayed
  above ``queue_high_frac`` for ``queue_dwell_periods`` consecutive
  checks (sustained saturation = back-pressure is losing).
* **partition-overflow proximity** — live slice occupancy of the
  edge-partitioned storage vs its static per-slice capacity
 . ``PartitionOverflowError`` is loud but terminal;
  this warns at ``partition_near_frac`` while there is still headroom
  to act (retire queries, shed load, re-shard).
* **freshness-SLO burn** — the :class:`~repro_torch.obs.freshness.
  FreshnessLedger`'s worst fast-window burn rate above
  ``burn_degraded`` (some standing query spent that fraction of the
  recent window staler than its SLO).

Detector transitions emit structured :class:`HealthEvent`s into a
bounded ring and — for ``stalled`` and freshness-burn events — trigger
the existing flight-recorder dump path, so the post-mortem that
explains the incident is written the moment the watchdog sees it, not
when a human asks. Composite readiness is ``stalled`` > ``degraded`` >
``ok`` (what ``/health`` serves; see ``repro_torch.obs.serve``).

The monitor runs either as a daemon thread (``start()``, wall-paced at
``period_s``) or by explicit :meth:`check` calls — the deterministic
mode the ``VirtualClock`` tests drive.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, NamedTuple, Optional,
                    Tuple)

OK, DEGRADED, STALLED = "ok", "degraded", "stalled"


class HealthEvent(NamedTuple):
    """One detector transition."""

    kind: str        # stall | queue_saturation | partition_pressure |
                     # freshness_burn | recovered
    severity: str    # ok | degraded | stalled
    t: float
    detail: Dict[str, Any]


class HealthMonitor:
    """Watchdog over one serving runtime (module docstring).

    Suppliers are zero-arg callables returning the current value of a
    signal (``None`` = signal not applicable right now); heartbeats are
    stamped by the watched threads themselves. Everything is host-side
    and lock-guarded; :meth:`check` is cheap enough for sub-second
    periods.
    """

    def __init__(self, clock=None, period_s: float = 0.25,
                 stall_after_s: float = 2.0,
                 queue_high_frac: float = 0.9,
                 queue_dwell_periods: int = 3,
                 partition_near_frac: float = 0.9,
                 burn_degraded: float = 0.5,
                 obs=None, freshness=None, max_events: int = 256):
        self.clock = clock
        self.period_s = float(period_s)
        self.stall_after_s = float(stall_after_s)
        self.queue_high_frac = float(queue_high_frac)
        self.queue_dwell_periods = int(queue_dwell_periods)
        self.partition_near_frac = float(partition_near_frac)
        self.burn_degraded = float(burn_degraded)
        self.obs = obs
        self.freshness = freshness
        self._lock = threading.Lock()
        self._hb: Dict[str, float] = {}
        self._active: Dict[str, bool] = {}
        self._queue_fill: Optional[Callable[[], Optional[float]]] = None
        self._partition: Optional[Callable[[], Optional[float]]] = None
        self._pending: Optional[Callable[[], int]] = None
        self._dwell = 0
        self._state = OK
        self._alarms: Dict[str, Dict[str, Any]] = {}  # kind → live detail
        self._live: Dict[str, Dict[str, Any]] = {}    # previous check's
        self.events: Deque[HealthEvent] = deque(maxlen=max_events)
        self.n_checks = 0
        self.n_dumps_triggered = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- wiring ---------------------------------------------------------------

    def beat(self, name: str, t: float) -> None:
        """Heartbeat from a watched thread (marks it active)."""
        with self._lock:
            self._hb[name] = t
            self._active[name] = True

    def set_inactive(self, name: str) -> None:
        """Clean thread exit: stop watching this heartbeat."""
        with self._lock:
            self._active[name] = False

    def attach_queue(self, fn: Callable[[], Optional[float]]) -> None:
        """Supplier of the ingress-queue fill fraction ∈ [0, 1]."""
        self._queue_fill = fn

    def attach_partition(self, fn: Callable[[], Optional[float]]) -> None:
        """Supplier of the worst live-slice occupancy fraction (None =
        storage not partitioned)."""
        self._partition = fn

    def attach_pending(self, fn: Callable[[], int]) -> None:
        """Supplier of arrived-but-undelivered work (drives the
        freshness ledger's idle snap)."""
        self._pending = fn

    # -- evaluation -----------------------------------------------------------

    def _raise_alarm(self, kind: str, severity: str, now: float,
                     detail: Dict[str, Any], fired: List[str]) -> None:
        # rising edge = not live at the previous check; re-raised alarms
        # refresh their detail but emit no new event (the event ring
        # records transitions, not state)
        if kind not in self._live and kind not in self._alarms:
            fired.append(kind)
            self.events.append(HealthEvent(kind, severity, now, detail))
        self._alarms[kind] = dict(detail, severity=severity)

    def check(self, now: Optional[float] = None) -> str:
        """Run every detector once; returns the composite readiness."""
        if now is None:
            now = self.clock.now()
        fired: List[str] = []
        with self._lock:
            self.n_checks += 1
            before = self._state
            self._live = dict(self._alarms)
            self._alarms = {}

            for name, t_hb in self._hb.items():
                if self._active.get(name) and now - t_hb > self.stall_after_s:
                    self._raise_alarm(
                        "stall", STALLED, now,
                        {"thread": name, "age_s": now - t_hb,
                         "stall_after_s": self.stall_after_s}, fired)

            fill = self._queue_fill() if self._queue_fill else None
            if fill is not None and fill >= self.queue_high_frac:
                self._dwell += 1
            else:
                self._dwell = 0
            if self._dwell >= self.queue_dwell_periods:
                self._raise_alarm(
                    "queue_saturation", DEGRADED, now,
                    {"fill": fill, "dwell_periods": self._dwell,
                     "high_frac": self.queue_high_frac}, fired)

            occ = self._partition() if self._partition else None
            if occ is not None and occ >= self.partition_near_frac:
                self._raise_alarm(
                    "partition_pressure", DEGRADED, now,
                    {"occupancy": occ,
                     "near_frac": self.partition_near_frac}, fired)

            if self.freshness is not None:
                pending = self._pending() if self._pending else 1
                self.freshness.idle_snap(now, pending)
                stal, burn = self.freshness.worst(now)
                if burn >= self.burn_degraded:
                    self._raise_alarm(
                        "freshness_burn", DEGRADED, now,
                        {"burn_fast": burn, "worst_staleness_s": stal,
                         "slo_s": self.freshness.slo_s}, fired)

            sev = [a["severity"] for a in self._alarms.values()]
            self._state = (STALLED if STALLED in sev
                           else DEGRADED if sev else OK)
            if before != OK and self._state == OK:
                self.events.append(HealthEvent(
                    "recovered", OK, now, {"was": before}))
            state = self._state
            dump_worthy = [k for k in fired
                           if self._alarms.get(k, {}).get("severity")
                           == STALLED or k == "freshness_burn"]
        if dump_worthy and self.obs is not None:
            path = self.obs.flight_dump(
                reason="watchdog:" + ",".join(sorted(dump_worthy)),
                triggered=True)
            if path is not None:
                self.n_dumps_triggered += 1
        return state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/health`` document: readiness + live alarms + recent
        transitions + heartbeat ages."""
        if now is None:
            now = self.clock.now() if self.clock is not None else 0.0
        with self._lock:
            return {
                "state": self._state,
                "alarms": {k: dict(v) for k, v in self._alarms.items()},
                "heartbeats": {
                    name: {"age_s": now - t,
                           "active": bool(self._active.get(name))}
                    for name, t in self._hb.items()},
                "n_checks": self.n_checks,
                "n_dumps_triggered": self.n_dumps_triggered,
                "events": [
                    {"kind": e.kind, "severity": e.severity, "t": e.t,
                     "detail": e.detail}
                    for e in list(self.events)[-16:]],
            }

    # -- monitor thread -------------------------------------------------------

    def start(self) -> None:
        """Run :meth:`check` every ``period_s`` on a daemon thread
        (wall-paced; deterministic tests call ``check`` directly)."""
        if self._thread is not None:
            raise RuntimeError("monitor already started")
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.period_s):
                try:
                    self.check()
                except Exception:   # a broken supplier must not kill the
                    pass            # watchdog; next period retries

        self._thread = threading.Thread(target=_loop, name="rt-watchdog",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
