"""Serving telemetry — latency percentiles and throughput counters.

A ring of the last ``window`` samples per *channel* gives p50/p99/p999
without unbounded memory; throughput counters (updates, patterns,
recompute fraction, back-pressure drop/evict/reject) accumulate over the
server's lifetime. Everything is host-side numpy; ``snapshot()`` is what
the CLI prints and the benchmark serializes.

Channels (DESIGN.md §6): ``step`` is the classic serving-step latency the
sync loop records; the async runtime adds per-event ``queue_wait`` (offer
→ packed into a micro-batch), per-batch ``assembly`` (drain + pack host
time), and per-event ``e2e`` (offer → match delta fanned out) — the
end-to-end latency an SLO is written against, so tails run out to p999.
The tracing layer (DESIGN.md §8) feeds per-stage engine span durations
into ``stage_*`` channels, which is how ``snapshot()`` grows a stage
breakdown without a second metrics pipeline.

Percentile credibility: a pXX estimate interpolated from fewer than
``1/(1-XX/100)`` samples (2 for p50, 100 for p99, 1000 for p999) is
noise, so ``snapshot()`` *omits* the key and ``latency_percentile(...,
strict=True)`` returns NaN until the channel has seen enough samples.
Ring windows are per-channel configurable; ``e2e`` defaults to a window
wide enough (4096) for p999 to ever become credible. The ``step``
channel's ``p50_step_ms``/``p99_step_ms`` keys are schema-stable — they
are always present (benches and the CLI index them unconditionally) and
use the relaxed estimate.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

# channels whose tails matter more than their memory: give them a window
# where p999 can become credible (>= 1000 samples resident)
DEFAULT_CHANNEL_WINDOWS: Dict[str, int] = {"e2e": 4096, "queue_wait": 4096,
                                           "ack_lag": 4096}

# snapshot() keys owned by Telemetry itself; free-form counters may not
# shadow them (satellite: `snap.update(self.counters)` used to clobber)
RESERVED_KEYS = frozenset({
    "steps", "p50_step_ms", "p99_step_ms", "updates_per_s",
    "patterns_per_s", "recompute_frac", "dropped_events",
    "evicted_events", "rejected_events",
})

_PERCENTILE_PREFIXES = ("p50_", "p99_", "p999_")


def percentile_min_count(q: float) -> int:
    """Samples needed before a pXX estimate is credible: ``1/(1-q/100)``
    rounded up — 2 for p50, 100 for p99, 1000 for p999."""
    if q >= 100.0:
        return 1
    # the 1e-9 guards float dust: 1/(1-99.9/100) is 1000.0000000002,
    # which must ceil to 1000, not 1001
    return max(1, int(math.ceil(1.0 / (1.0 - q / 100.0) - 1e-9)))


def _is_percentile_key(key: str) -> bool:
    return key.endswith("_ms") and key.startswith(_PERCENTILE_PREFIXES)


class _Ring:
    """Bounded latency-sample ring with percentile views."""

    def __init__(self, window: int):
        self.window = window
        self._buf = np.zeros(window, np.float64)
        self._fill = 0
        self._cursor = 0
        self.count = 0

    def add(self, sample_s: float) -> None:
        self._buf[self._cursor] = sample_s
        self._cursor = (self._cursor + 1) % self.window
        self._fill = min(self._fill + 1, self.window)
        self.count += 1

    def extend(self, samples_s: Iterable[float]) -> None:
        for s in samples_s:
            self.add(float(s))

    def credible(self, q: float) -> bool:
        return self._fill >= percentile_min_count(q)

    def percentile(self, q: float, strict: bool = False) -> float:
        if strict and not self.credible(q):
            return float("nan")
        if self._fill == 0:
            return 0.0
        return float(np.percentile(self._buf[: self._fill], q))


class Telemetry:
    def __init__(self, window: int = 512,
                 channel_windows: Optional[Mapping[str, int]] = None):
        self.window = window
        self._windows: Dict[str, int] = dict(DEFAULT_CHANNEL_WINDOWS)
        if channel_windows:
            self._windows.update(channel_windows)
        self._chan: Dict[str, _Ring] = {"step": self._new_ring("step")}
        self.n_steps = 0
        self.n_updates = 0
        self.n_patterns = 0
        self.n_dropped = 0
        self.n_evicted = 0
        self.n_rejected = 0
        self._recompute_sum = 0.0
        self._t0: Optional[float] = None
        # free-form monotone counters (e.g. the engine's storm seed-cache
        # hit/miss counts) — merged into snapshot(), collisions rejected
        self.counters: Dict[str, int] = {}

    def _new_ring(self, channel: str) -> _Ring:
        return _Ring(self._windows.get(channel, self.window))

    def channel_window(self, channel: str) -> int:
        ring = self._chan.get(channel)
        return ring.window if ring is not None else self._windows.get(
            channel, self.window)

    def record_counters(self, counters: Dict[str, int]) -> None:
        """Absorb a counter snapshot (values are absolutes, not deltas).

        Counter names may not shadow snapshot built-ins or percentile
        keys — a counter named ``steps`` or ``p99_e2e_ms`` would silently
        corrupt the exported metrics, so that's an error here."""
        for key in counters:
            if key in RESERVED_KEYS or _is_percentile_key(key):
                raise ValueError(
                    f"counter name {key!r} collides with a reserved "
                    "telemetry snapshot key")
        self.counters.update(counters)

    def record_latency(self, channel: str, *samples_s: float) -> None:
        """Append latency samples to a named channel (created on first
        use); the snapshot reports its percentiles once credible."""
        ring = self._chan.get(channel)
        if ring is None:
            ring = self._chan[channel] = self._new_ring(channel)
        ring.extend(samples_s)

    def record_drops(self, n_dropped: int = 0, n_evicted: int = 0,
                     n_rejected: int = 0) -> None:
        """Accumulate back-pressure casualties (deltas, not absolutes)."""
        self.n_dropped += n_dropped
        self.n_evicted += n_evicted
        self.n_rejected += n_rejected

    def record_step(self, latency_s: float, n_updates: int,
                    n_new_patterns: int, recompute_frac: float,
                    n_dropped: int = 0, n_evicted: int = 0,
                    n_rejected: int = 0) -> None:
        if self._t0 is None:
            # wall clock spans from the START of the first recorded step,
            # so small step counts don't inflate the throughput rates
            self._t0 = time.perf_counter() - latency_s
        self._chan["step"].add(latency_s)
        self.n_steps += 1
        self.n_updates += n_updates
        self.n_patterns += n_new_patterns
        self.record_drops(n_dropped, n_evicted, n_rejected)
        self._recompute_sum += recompute_frac

    # -- views ---------------------------------------------------------------

    def latency_percentile(self, q: float, channel: str = "step",
                           strict: bool = False) -> float:
        ring = self._chan.get(channel)
        if ring is None:
            return float("nan") if strict else 0.0
        return ring.percentile(q, strict=strict)

    def channel_count(self, channel: str) -> int:
        ring = self._chan.get(channel)
        return ring.count if ring is not None else 0

    def snapshot(self) -> Dict[str, float]:
        wall = (time.perf_counter() - self._t0) if self._t0 else 0.0
        steps = max(self.n_steps, 1)
        snap = {
            "steps": self.n_steps,
            "p50_step_ms": 1e3 * self.latency_percentile(50),
            "p99_step_ms": 1e3 * self.latency_percentile(99),
            "updates_per_s": self.n_updates / wall if wall > 0 else 0.0,
            "patterns_per_s": self.n_patterns / wall if wall > 0 else 0.0,
            "recompute_frac": self._recompute_sum / steps,
            "dropped_events": self.n_dropped,
            "evicted_events": self.n_evicted,
            "rejected_events": self.n_rejected,
        }
        for name, ring in self._chan.items():
            if name == "step" or ring.count == 0:
                continue
            for q, label in ((50, "p50"), (99, "p99"), (99.9, "p999")):
                if ring.credible(q):
                    snap[f"{label}_{name}_ms"] = 1e3 * ring.percentile(q)
        for key, val in self.counters.items():
            if key in snap:  # belt and braces vs. late-added builtins
                raise ValueError(
                    f"counter {key!r} collides with snapshot key")
            snap[key] = val
        return snap
