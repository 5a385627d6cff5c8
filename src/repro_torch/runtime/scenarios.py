"""Workload scenarios — seeded arrival processes over temporal streams.

The port's copy of ``repro.runtime.scenarios``: the same scenario and
seeds give ticks holding the same events as the JAX package's, while the
stream's graph and batches are tensors on the requested device.

A *scenario* layers an arrival process on a
:class:`~repro_torch.data.temporal.TemporalGraphSpec` stream: the stream decides
WHAT the events are (edge adds/removes with the paper's graph structure,
churn, hotspot content), the arrival process decides WHEN they reach the
serving runtime. Time quantizes into ``tick_s`` quanta; each tick carries
the events the (seeded) arrival process emits in that quantum, so a
workload is a deterministic list of ``Tick(t, events)`` the ingress thread
replays against the injected clock — identical across runs and identical
for the sync and async runners. :func:`deal` applies an arrival process
to a stream built elsewhere (a published-size twin, say) without
regenerating it.

The four shipped shapes target the serving regimes the tail-latency SLOs
are written against (continuous-query serving):

  * ``poisson``      — steady state: events ~ Poisson(rate · tick_s).
  * ``flash_crowd``  — baseline Poisson with periodic bursts of
    ``burst_amplitude``× the rate whose *content* is a hotspot stream
    (every burst lands in one small vertex region) — the back-pressure
    sizing scenario.
  * ``diurnal``      — the rate rides a day-cycle ramp between ~25% and
    100% of ``rate`` (capacity planning: the runtime must not queue up
    at the peak of the ramp).
  * ``churn_heavy``  — steady arrivals, but every step deletes as many
    live edges as it adds (store pruning + coalescing under fire).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple

import numpy as np

from repro_torch.data.temporal import (TemporalGraphSpec, TemporalStream,
                                       generate_stream)
from repro_torch.serving.queue import UpdateEvent, batch_to_events


@dataclass(frozen=True)
class ScenarioConfig:
    """One workload scenario: arrival process + underlying stream shape."""

    name: str
    kind: str                    # poisson | flash_crowd | diurnal | churn_heavy
    rate: float = 20_000.0       # mean event arrivals per second
    tick_s: float = 0.01         # arrival-process integration quantum
    n_ticks: int = 64
    seed: int = 0
    # flash crowd
    burst_amplitude: float = 8.0
    burst_period: int = 16       # ticks between burst onsets
    burst_len: int = 4           # ticks a burst lasts
    # diurnal
    diurnal_periods: float = 1.0  # day cycles across the run
    # underlying stream shape
    n_vertices: int = 256
    graph_kind: str = "sparse_dense"
    churn: float = 0.0
    hotspot: bool = False
    # closed loop: subscribers ACK delivered MatchDeltas and
    # the arrival process throttles on delivered lag — clients back off a
    # laggy server, so the run measures goodput/SLO-violation curves
    # instead of open-loop tails. ``lag_ref_s`` is the delivered lag at
    # which the offered rate halves (rate / (1 + lag/lag_ref));
    # ``ack_slo_s`` is the ack-latency SLO goodput is counted against.
    closed_loop: bool = False
    lag_ref_s: float = 0.2
    ack_slo_s: float = 0.25

    @property
    def duration_s(self) -> float:
        return self.n_ticks * self.tick_s


class Tick(NamedTuple):
    """Events the arrival process emits in one quantum, at time ``t``."""

    t: float
    events: List[UpdateEvent]


class Workload(NamedTuple):
    scenario: ScenarioConfig
    spec: TemporalGraphSpec
    stream: TemporalStream       # carries the warmed-up starting graph
    ticks: List[Tick]
    n_events: int

    @property
    def graph(self):
        return self.stream.graph


def _tick_rates(sc: ScenarioConfig) -> np.ndarray:
    """Mean arrivals per tick, per the scenario's rate shape."""
    base = sc.rate * sc.tick_s
    t = np.arange(sc.n_ticks, dtype=np.float64)
    if sc.kind in ("poisson", "churn_heavy"):
        return np.full(sc.n_ticks, base)
    if sc.kind == "flash_crowd":
        in_burst = (t % sc.burst_period) < sc.burst_len
        return np.where(in_burst, sc.burst_amplitude * base, base)
    if sc.kind == "diurnal":
        phase = 2.0 * np.pi * sc.diurnal_periods * t / max(sc.n_ticks, 1)
        # ramp between ~25% and 100% of the configured rate
        return base * (0.25 + 0.75 * 0.5 * (1.0 - np.cos(phase)))
    raise ValueError(f"unknown scenario kind {sc.kind!r}")


def build_workload(sc: ScenarioConfig, n_max: int | None = None,
                   e_max: int | None = None,
                   u_max: int = 512, device="cuda") -> Workload:
    """Materialize a scenario: seeded per-tick arrival counts, then the
    matching number of stream events (in stream order) dealt out tick by
    tick. Everything downstream of the two seeds is deterministic; the
    stream's graph lands on ``device``."""
    counts = _tick_counts(sc)
    need = int(counts.sum())

    churn = 1.0 if sc.kind == "churn_heavy" else sc.churn
    hotspot = sc.kind == "flash_crowd" or sc.hotspot
    # additions the measured stream must carry (removals ride along at
    # `churn` per addition and count as events too)
    need_adds = max(int(np.ceil(need / (1.0 + churn))), 1)
    per_step = u_max // 2
    if churn > 0:
        per_step = min(per_step, int(u_max / (2.0 * churn)))
    n_meas = int(np.ceil(need_adds / max(per_step, 1))) + 1
    n_edges = max(8 * sc.n_vertices, 4 * need_adds)
    # keep edges_per_step ≥ the per-step cap so every measured batch is full
    n_steps = max(4, n_edges // (2 * per_step))
    spec = TemporalGraphSpec(
        sc.name, sc.graph_kind, n_vertices=sc.n_vertices, n_edges=n_edges,
        n_steps=n_steps, seed=sc.seed, churn=churn, hotspot=hotspot,
        hotspot_period=1 if sc.kind == "flash_crowd" else 4)
    stream = generate_stream(spec, n_max=n_max, e_max=e_max,
                             n_measured_steps=n_meas, u_max=u_max,
                             device=device)
    return deal(sc, stream, counts)


def _tick_counts(sc: ScenarioConfig) -> np.ndarray:
    """The seeded arrival count of every tick."""
    rng = np.random.default_rng(sc.seed + 1)
    return rng.poisson(_tick_rates(sc)).astype(np.int64)


def deal(sc: ScenarioConfig, stream: TemporalStream,
         counts: np.ndarray | None = None) -> Workload:
    """Deal ``stream``'s measured batches, as events in stream order, into
    the ticks of ``sc``'s arrival process (``counts`` per tick, drawn from
    the scenario's seed when omitted). Ticks past the stream's last event
    carry none."""
    counts = _tick_counts(sc) if counts is None else counts
    flat: List[UpdateEvent] = []
    for upd in stream.updates:
        flat.extend(batch_to_events(upd))

    ticks: List[Tick] = []
    cursor = 0
    for i, k in enumerate(counts):
        take = min(int(k), len(flat) - cursor)
        ticks.append(Tick(t=i * sc.tick_s,
                          events=flat[cursor:cursor + take]))
        cursor += take
    return Workload(sc, stream.spec, stream, ticks, cursor)


class ClosedLoopSource:
    """Lag-throttled event source for closed-loop runs.

    Draws each tick's arrival count ``Poisson(rate_i · tick_s · m(lag))``
    online, where ``m(lag) = 1 / (1 + lag / lag_ref_s)`` models clients
    backing off a laggy server (delivered lag is the runtime's ack
    frontier, see ``repro_torch.runtime.AckLedger``). Events come from the SAME
    deterministic pool the open-loop workload deals out, in the same
    stream order — throttling only changes how much of it is offered, so
    a closed-loop run is comparable to its open-loop twin. Exhausting the
    pool ends emission (``exhausted``).

    Determinism: the Poisson draw sequence is a pure function of the seed
    and the lag sequence; under a ``VirtualClock`` the lag sequence is
    deterministic, so whole closed-loop replays are too.
    """

    def __init__(self, workload: Workload):
        sc = workload.scenario
        if not sc.closed_loop:
            raise ValueError(
                f"scenario {sc.name!r} is not closed-loop "
                "(build it with closed_loop=True)")
        self.sc = sc
        self._rates = _tick_rates(sc)
        self._pool = [ev for tick in workload.ticks for ev in tick.events]
        self._cursor = 0
        self._rng = np.random.default_rng(sc.seed + 2)
        self.n_offered = 0
        self.n_throttled = 0  # events the modulation held back

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self._pool)

    def emit(self, i: int, lag_s: float) -> List[UpdateEvent]:
        """Events arriving in tick ``i`` given current delivered lag."""
        lam = float(self._rates[i % len(self._rates)])
        mult = 1.0 / (1.0 + max(float(lag_s), 0.0) / self.sc.lag_ref_s)
        k = int(self._rng.poisson(lam * mult))
        # demand held back by the modulation itself (NOT Poisson noise):
        # deterministic given the lag, and exactly 0 at zero lag — so
        # virtual-clock runs, where lag is always 0, count none
        self.n_throttled += int(round(lam * (1.0 - mult)))
        take = self._pool[self._cursor:self._cursor + k]
        self._cursor += len(take)
        self.n_offered += len(take)
        return take


# -- the shipped scenario shapes ----------------------------------------------

def poisson(**kw) -> ScenarioConfig:
    return ScenarioConfig(name="poisson", kind="poisson", **kw)


def flash_crowd(**kw) -> ScenarioConfig:
    return ScenarioConfig(name="flash_crowd", kind="flash_crowd", **kw)


def diurnal(**kw) -> ScenarioConfig:
    return ScenarioConfig(name="diurnal", kind="diurnal", **kw)


def churn_heavy(**kw) -> ScenarioConfig:
    return ScenarioConfig(name="churn_heavy", kind="churn_heavy", **kw)


SCENARIOS: Dict[str, Callable[..., ScenarioConfig]] = {
    "poisson": poisson,
    "flash_crowd": flash_crowd,
    "diurnal": diurnal,
    "churn_heavy": churn_heavy,
}
