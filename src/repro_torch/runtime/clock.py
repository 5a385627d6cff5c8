"""Injected clocks — the runtime's only notion of time.

Every timing-driven decision in the serving runtime (workload pacing,
latency stamps, drain timeouts) reads the injected clock, never
``time.*`` directly. ``WallClock`` is production; ``VirtualClock`` makes
time a plain counter the workload replay advances itself, so a
deterministic test run involves no sleeping and no real-time races — the
determinism contract ("threading changes *when* work runs, never *what*
it computes") is checkable because *when* collapses to a seeded constant.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Interface: ``now()`` in seconds and an interruptible wait."""

    def now(self) -> float:
        raise NotImplementedError

    def wait_until(self, t: float, interrupt: threading.Event) -> None:
        """Block until ``now() >= t`` or ``interrupt`` is set."""
        raise NotImplementedError


class WallClock(Clock):
    """Monotonic wall time, zeroed at construction."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def wait_until(self, t: float, interrupt: threading.Event) -> None:
        while not interrupt.is_set():
            dt = t - self.now()
            if dt <= 0:
                return
            interrupt.wait(min(dt, 0.05))


class VirtualClock(Clock):
    """Deterministic time: ``wait_until`` *advances* the clock instead of
    sleeping, so a replay under VirtualClock is as fast as the compute and
    every latency stamp is a pure function of the event sequence."""

    def __init__(self, t0: float = 0.0):
        self._now = t0
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance_to(self, t: float) -> None:
        with self._lock:
            self._now = max(self._now, t)

    def wait_until(self, t: float, interrupt: threading.Event) -> None:
        self.advance_to(t)
