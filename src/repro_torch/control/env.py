"""Controller environment — observations, knob-ladder actions, reward
(the port's ``repro.control.env``).

The environment is assembled from what the runtime already measures:
queue occupancy and back-pressure counters, the ``stage_*`` per-stage
latency percentiles (0.0 when tracing is off — ``Telemetry.
latency_percentile`` returns 0 for absent channels), the engine's
adaptive-RWR sweep counter, and the ``AckLedger``'s delivered-lag
frontier. Two normalization rules keep the vector well-behaved AND
deterministic under a ``VirtualClock``:

* every time-valued component is measured through the injected clock
  (delivered lag, clock-timed device service) or a latency channel that
  is absent in deterministic tests — never ``time.*`` directly;
* every component is a bounded ratio (occupancy fractions, per-event
  fractions, ladder positions), clipped where the underlying quantity is
  unbounded (lag).

The vector is built on the host in float32 in the JAX package's order, so
equal runtime state gives bitwise-equal observations in both packages.

Actions move one knob one rung along a bounded ladder per decision:
window ×2/÷2, shed threshold (queue depth) ×2/÷2, ``rwr_tol`` one rung
up/down its discrete ladder, plus no-op. Ladder bounds make every
reachable configuration a valid static config, so the learned policy's
advantage over static baselines is pure adaptivity.

The reward is the ledger's goodput curve, per event of *demand*
accounted in the decision interval::

    r = (Δgood − w·Δviol − Δdropped − Δthrottled)
        / max(Δgood + Δviol + Δdropped + Δthrottled, 1)

Good events (acked within the SLO) pay +1, SLO violations −w
(``ControlConfig.viol_weight``), and shed events −1 — so the controller
cannot game the SLO by shedding everything. Throttled demand — arrivals
clients held back because delivered lag was high — also pays −1, so
"lag so hard clients stop sending" is not reward-neutral. Open-loop runs
have no closed-loop source on the ledger and the term is 0; under a
``VirtualClock`` lag is always 0 so the term is 0 there too. r is bounded
in [−max(w, 1), 1].
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.config.base import ControlConfig
from repro_torch.runtime.runtime import AckLedger, RuntimeKnobs
from repro_torch.serving.server import MatchServer

OBS_DIM = 12
# extra dims appended when ControlConfig.freshness_obs is on: worst
# per-query staleness (in SLOs, clipped like lag) + worst fast-window
# burn rate — the FreshnessLedger's pair
FRESHNESS_OBS_DIM = 2
ACTION_NAMES: Tuple[str, ...] = (
    "noop", "window_up", "window_down", "depth_up", "depth_down",
    "tol_up", "tol_down")
N_ACTIONS = len(ACTION_NAMES)

_LAG_CLIP = 8.0  # lag is unbounded; clip at 8 SLOs


def obs_dim(ccfg: ControlConfig) -> int:
    """The observation width this config produces — 12 pinned dims, plus
    the freshness pair behind the flag (tests pin 12 with it off)."""
    return OBS_DIM + (FRESHNESS_OBS_DIM if ccfg.freshness_obs else 0)


def _ladder_from(value: int, floor: int = 8) -> Tuple[int, ...]:
    """Derive a ×2 ladder ending at the configured value (the static
    config is the ladder's top rung; the controller can only tighten)."""
    rungs: List[int] = []
    v = int(value)
    while v >= floor and len(rungs) < 4:
        rungs.append(v)
        v //= 2
    if not rungs:
        rungs = [int(value)]
    return tuple(sorted(rungs))


class ControllerEnv:
    """Observation/action surface between one server and its controller."""

    def __init__(self, server: MatchServer, knobs: RuntimeKnobs,
                 ledger: AckLedger, ccfg: ControlConfig,
                 freshness=None):
        self.server = server
        self.knobs = knobs
        self.ledger = ledger
        self.ccfg = ccfg
        # per-query FreshnessLedger (None = feature off or no ledger in
        # this runtime: the appended dims read as zeros, so the flagged
        # layout is still well-defined without one)
        self.freshness = freshness
        serving = server.serving
        self.window_ladder = (tuple(ccfg.window_ladder) or
                              _ladder_from(serving.microbatch_window))
        self.depth_ladder = (tuple(ccfg.depth_ladder) or
                             _ladder_from(serving.queue_depth, floor=32))
        base_tol = server.engine.cfg.rwr_tol
        if base_tol > 0:
            self.tol_ladder: Tuple[float, ...] = tuple(
                sorted(set(ccfg.tol_ladder) | {base_tol}))
        else:
            # exact fixed-iteration sweeps configured: the tol knob is
            # disabled rather than silently switching the engine onto
            # the adaptive path (a semantics change, not a tuning)
            self.tol_ladder = (0.0,)
        self.window_idx = self._nearest(self.window_ladder, knobs.window)
        self.depth_idx = self._nearest(self.depth_ladder, knobs.queue_depth)
        self.tol_idx = self._nearest(self.tol_ladder, knobs.rwr_tol)
        # the configured baseline (episode starts return here; see
        # reset_knobs) — derived from the serving CONFIG, not the live
        # knobs: a controller may be constructed (e.g. restored from a
        # checkpoint) while the knobs sit mid-ladder
        self._baseline_idx = (
            self._nearest(self.window_ladder, serving.microbatch_window),
            self._nearest(self.depth_ladder, serving.queue_depth),
            self._nearest(self.tol_ladder, base_tol))
        # interval accounting (deltas between observations)
        self._last = {"good": 0, "viol": 0, "dropped": 0, "throttled": 0,
                      "evicted": 0, "rejected": 0, "sweeps": 0,
                      "events": 0, "batches": 0}
        self._events = 0
        self._batches = 0
        self._service_ema = 0.0

    @staticmethod
    def _nearest(ladder: Tuple, value) -> int:
        return int(np.argmin([abs(float(r) - float(value)) for r in ladder]))

    # -- per-batch accounting -------------------------------------------------

    def reset_knobs(self) -> None:
        """Return every knob to the serving-config baseline — called at
        episode starts so (a) training episodes all start from the same
        operating point and are comparable, and (b) a frozen evaluation
        run starts exactly where a static baseline config would, so its
        score difference is pure adaptivity, not a head start from
        wherever the previous episode happened to leave the knobs."""
        self.window_idx, self.depth_idx, self.tol_idx = self._baseline_idx
        self.apply(0)  # re-assert via a noop move

    def rebaseline(self) -> None:
        """Re-anchor the interval baseline at the CURRENT counter values —
        called at episode starts, where the caller may have reset the
        server (fresh telemetry) or the ledger between episodes and the
        stale baseline would fabricate a huge first-interval delta."""
        led, tel = self.ledger, self.server.telemetry
        self._last.update(
            good=led.n_good, viol=led.n_viol, dropped=tel.n_dropped,
            throttled=self._throttled(), evicted=tel.n_evicted,
            rejected=tel.n_rejected,
            sweeps=self.server.engine.rwr_sweeps,
            events=self._events, batches=self._batches)

    def note_batch(self, n_events: int, service_clock_s: float) -> None:
        """Called at every micro-batch boundary. ``service_clock_s`` is
        the executor's last device-step duration measured through the
        injected clock (0 under a ``VirtualClock`` — deterministic)."""
        self._events += n_events
        self._batches += 1
        self._service_ema = 0.8 * self._service_ema + 0.2 * service_clock_s

    # -- observation ----------------------------------------------------------

    def observation(self, now: float) -> np.ndarray:
        tel = self.server.telemetry
        queue = self.server.queue
        slo = max(self.ledger.slo_s, 1e-6)
        lag = self.ledger.lag(now, pending=len(queue))
        d_events = max(self._events - self._last["events"], 1)
        # counter resets (server.reset between episodes) can only lower
        # the raw counters; clamp so the obs stays in [0, 1] regardless
        d_evicted = max(tel.n_evicted - self._last["evicted"], 0)
        d_rejected = max(tel.n_rejected - self._last["rejected"], 0)
        sweeps = self.server.engine.rwr_sweeps
        d_batches = max(self._batches - self._last["batches"], 1)
        d_sweeps = max(sweeps - self._last["sweeps"], 0)
        sweep_cap = max(self.server.engine.cfg.rwr_iters, 1)
        p50 = lambda ch: tel.latency_percentile(50, ch)  # noqa: E731
        step_p50 = p50("stage_rwr") + p50("stage_gray") + p50("stage_merge")
        obs = np.array([
            len(queue) / max(self.knobs.queue_depth, 1),
            min(d_evicted / d_events, 1.0),
            min(d_rejected / d_events, 1.0),
            min(lag / slo, _LAG_CLIP) / _LAG_CLIP,
            min(self._service_ema / slo, _LAG_CLIP) / _LAG_CLIP,
            min(d_events / (d_batches * max(self.knobs.window, 1)), 1.0),
            min(d_sweeps / (d_batches * sweep_cap), 1.0),
            min(p50("stage_rwr") / max(step_p50, 1e-9), 1.0),
            min(p50("stage_merge") / max(step_p50, 1e-9), 1.0),
            self.window_idx / max(len(self.window_ladder) - 1, 1),
            self.depth_idx / max(len(self.depth_ladder) - 1, 1),
            self.tol_idx / max(len(self.tol_ladder) - 1, 1),
        ], np.float32)
        if self.ccfg.freshness_obs:
            if self.freshness is not None:
                stal, burn = self.freshness.worst(now)
            else:
                stal, burn = 0.0, 0.0
            obs = np.concatenate([obs, np.array([
                min(stal / slo, _LAG_CLIP) / _LAG_CLIP,
                min(max(burn, 0.0), 1.0),
            ], np.float32)])
        return obs

    # -- reward ---------------------------------------------------------------

    def _throttled(self) -> int:
        """Demand the closed-loop source's lag modulation held back so
        far (0 on open-loop runs, which have no source on the ledger)."""
        src = getattr(self.ledger, "closed_src", None)
        return int(src.n_throttled) if src is not None else 0

    def reward(self, mark: bool = True) -> float:
        """Goodput reward over the interval since the last call (module
        docstring); ``mark`` advances the interval baseline."""
        led, tel = self.ledger, self.server.telemetry
        thr = self._throttled()
        d_good = led.n_good - self._last["good"]
        d_viol = led.n_viol - self._last["viol"]
        d_drop = tel.n_dropped - self._last["dropped"]
        d_thr = max(thr - self._last["throttled"], 0)
        if mark:
            self._last.update(
                good=led.n_good, viol=led.n_viol, dropped=tel.n_dropped,
                throttled=thr, evicted=tel.n_evicted,
                rejected=tel.n_rejected,
                sweeps=self.server.engine.rwr_sweeps,
                events=self._events, batches=self._batches)
        denom = max(d_good + d_viol + d_drop + d_thr, 1)
        return float((d_good - self.ccfg.viol_weight * d_viol - d_drop
                      - d_thr) / denom)

    # -- actions --------------------------------------------------------------

    def apply(self, action: int) -> None:
        name = ACTION_NAMES[action]
        if name == "window_up":
            self.window_idx = min(self.window_idx + 1,
                                  len(self.window_ladder) - 1)
        elif name == "window_down":
            self.window_idx = max(self.window_idx - 1, 0)
        elif name == "depth_up":
            self.depth_idx = min(self.depth_idx + 1,
                                 len(self.depth_ladder) - 1)
        elif name == "depth_down":
            self.depth_idx = max(self.depth_idx - 1, 0)
        elif name == "tol_up":
            self.tol_idx = min(self.tol_idx + 1, len(self.tol_ladder) - 1)
        elif name == "tol_down":
            self.tol_idx = max(self.tol_idx - 1, 0)
        self.knobs.set_window(self.window_ladder[self.window_idx])
        self.knobs.set_queue_depth(self.depth_ladder[self.depth_idx])
        if self.tol_ladder != (0.0,):
            self.knobs.set_rwr_tol(self.tol_ladder[self.tol_idx])

    # -- persistence ----------------------------------------------------------

    def knob_state(self) -> Dict[str, int]:
        return {"window_idx": self.window_idx, "depth_idx": self.depth_idx,
                "tol_idx": self.tol_idx}

    def load_knob_state(self, sd: Dict[str, int]) -> None:
        self.window_idx = int(np.clip(int(sd["window_idx"]), 0,
                                      len(self.window_ladder) - 1))
        self.depth_idx = int(np.clip(int(sd["depth_idx"]), 0,
                                     len(self.depth_ladder) - 1))
        self.tol_idx = int(np.clip(int(sd["tol_idx"]), 0,
                                   len(self.tol_ladder) - 1))
        self.apply(0)  # re-assert the restored knob positions (noop move)
