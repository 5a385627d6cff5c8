"""The serving controller — upgraded DQN over the knob-ladder env (the
port's ``repro.control.agent``).

``ServingController`` composes a :class:`~repro_torch.control.env.
ControllerEnv` with the port's ``core.dqn`` learner (double-DQN + n-step
returns, see ``DQNSpec``) on the server's device, and runs the decision
loop the runtime hooks call at micro-batch boundaries on the ingress side:

* every ``ControlConfig.decide_every`` batches: observe → credit the
  reward for the *previous* action (train mode) → pick the next action
  (ε-greedy in ``train``, pure greedy in ``frozen``) → move the knobs.
* ``end_episode`` closes the MDP episode (final ``done`` transition,
  flushing the learner's n-step window) so multi-episode training over
  workload replays is well-formed.

Frozen mode consumes no exploration RNG and never learns — given the
same observations it replays the same decisions. The controller
checkpoints through ``Engine.save/load`` alongside the PEM agent (the
engine carries an optional ``control`` attachment whose ``state_dict``
lands in the same checkpoint tree, in the JAX package's layout, so either
package restores the other's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config.base import ControlConfig
from repro_torch.control.env import N_ACTIONS, ControllerEnv, obs_dim
from repro_torch.core.dqn import DQNAgent, Transition
from repro_torch.runtime.runtime import AckLedger, RuntimeKnobs
from repro_torch.serving.server import MatchServer


class ServingController:
    """Decision loop + learner; see module docstring."""

    def __init__(self, server: MatchServer, knobs: RuntimeKnobs,
                 ledger: AckLedger, ccfg: ControlConfig,
                 freshness=None):
        if ccfg.mode not in ("train", "frozen"):
            raise ValueError(f"unknown control mode {ccfg.mode!r} "
                             "(off-mode builds no controller)")
        self.ccfg = ccfg
        self.mode = ccfg.mode
        self.env = ControllerEnv(server, knobs, ledger, ccfg,
                                 freshness=freshness)
        # the env fixes the interface shape (12 dims, +2 when the
        # freshness flag is on); the spec's other fields
        # (double/n_step/lr/...) stay caller-configurable
        spec = dataclasses.replace(ccfg.dqn, obs_dim=obs_dim(ccfg),
                                   n_actions=N_ACTIONS)
        self.agent = DQNAgent(spec, seed=ccfg.seed, device=server.device)
        self._batches = 0
        self._prev: Optional[Tuple[np.ndarray, int]] = None
        self.n_decisions = 0
        self.n_episodes = 0
        self.losses: List[float] = []
        # (obs, action, reward-credited-this-decision) — the replayable
        # decision log the determinism tests compare
        self.history: List[Tuple[Tuple[float, ...], int, float]] = []

    def freeze(self) -> None:
        """Switch to pure greedy inference (train-then-freeze runs)."""
        self.mode = "frozen"
        self._prev = None

    # -- runtime hooks --------------------------------------------------------

    def begin_episode(self) -> None:
        """Episode start: knobs return to the configured baseline (every
        episode — training or frozen evaluation — starts from the same
        operating point the static config would) and the env's interval
        baseline re-anchors (the caller may have reset the server or
        ledger since the last episode)."""
        self.env.reset_knobs()
        self.env.rebaseline()
        self._prev = None
        self._batches = 0

    def on_batch(self, n_events: int, service_clock_s: float,
                 now: float) -> None:
        """Micro-batch boundary hook (ingress thread / sync runner)."""
        self.env.note_batch(n_events, service_clock_s)
        self._batches += 1
        if self._batches % self.ccfg.decide_every:
            return
        obs = self.env.observation(now)
        reward = self.env.reward(mark=True)
        if self.mode == "train" and self._prev is not None:
            p_obs, p_act = self._prev
            self.losses.append(self.agent.observe(
                Transition(p_obs, p_act, reward, obs, False)))
        action = self.agent.act(obs, greedy=self.mode == "frozen")
        self.env.apply(action)
        self._prev = (obs, action)
        self.n_decisions += 1
        self.history.append((tuple(float(x) for x in obs), action, reward))

    def end_episode(self, now: float) -> None:
        """Close the episode: final ``done`` transition (train mode) and
        interval reset, so back-to-back workload replays are separate
        MDP episodes."""
        if self.mode == "train" and self._prev is not None:
            obs = self.env.observation(now)
            reward = self.env.reward(mark=True)
            p_obs, p_act = self._prev
            self.losses.append(self.agent.observe(
                Transition(p_obs, p_act, reward, obs, True)))
        else:
            self.env.reward(mark=True)  # reset the interval baseline
        self._prev = None
        self._batches = 0
        self.n_episodes += 1

    # -- persistence (Engine.save/load rides this) ----------------------------

    def state_dict(self) -> Dict:
        ks = self.env.knob_state()
        return {
            "agent": self.agent.state_dict(),
            "knobs": {k: np.asarray(v, np.int64) for k, v in ks.items()},
            "n_decisions": np.asarray(self.n_decisions, np.int64),
            "n_episodes": np.asarray(self.n_episodes, np.int64),
        }

    def load_state_dict(self, sd: Dict) -> None:
        self.agent.load_state_dict(sd["agent"])
        self.env.load_knob_state({k: int(v)
                                  for k, v in sd["knobs"].items()})
        self.n_decisions = int(sd["n_decisions"])
        self.n_episodes = int(sd["n_episodes"])
        self._prev = None
