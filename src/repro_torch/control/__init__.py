"""Closed-loop RL serving controller (the port's ``repro.control``).

A :class:`ControllerEnv` turns the runtime's telemetry (queue occupancy,
back-pressure counters, per-stage percentiles, RWR sweep counts,
delivered lag) into a bounded observation vector and exposes a discrete
knob-ladder action space over the live ``RuntimeKnobs`` (micro-batch
window, shed threshold, ``rwr_tol``); a :class:`ServingController` wraps
the double-DQN + n-step learner of ``repro_torch.core.dqn`` around it,
trained against a goodput/SLO-violation reward from the ``AckLedger``,
deciding at micro-batch boundaries on the ingress side.
``mode='frozen'`` is pure greedy inference (replayable); ``mode='off'``
builds nothing at all.
"""

from repro_torch.control.agent import ServingController
from repro_torch.control.env import (ACTION_NAMES, FRESHNESS_OBS_DIM,
                                     N_ACTIONS, OBS_DIM, ControllerEnv,
                                     obs_dim)

__all__ = [
    "ACTION_NAMES", "N_ACTIONS", "OBS_DIM", "FRESHNESS_OBS_DIM", "obs_dim",
    "ControllerEnv", "ServingController",
]
