"""DQN (Mnih et al. 2015) — PEM's reinforcement-learning sub-component.

Exactly the paper's shape (§III-C-3): 2-d observation (graph density,
fraction of affected communities), two fully-connected hidden layers of four
units, 2-action output (increment / decrement the minimum community size),
ε-greedy with ε = 0.5 (§IV-C). The network is an :class:`MLP` module on the
engine's device; the TD loss goes through ``torch.autograd`` and Adam is
written out in the JAX package's order, so a state loaded from either
package trains on the same numbers up to float rounding.

Two upgrades, both off for the PEM agent:

- **double-DQN** (van Hasselt et al. 2016): action selection by the online
  net, evaluation by the target net.
- **n-step returns**: transitions are aggregated over an n-deep pending
  window before they reach the replay ring; each stored transition carries
  its own bootstrap discount γ^k (k ≤ n, shorter at episode ends), so the
  TD target is ``R_n + γ^k max_a' Q(s_{t+k}, a')``.

Construct with :class:`~repro_torch.config.base.DQNSpec` to opt in;
constructing with :class:`~repro_torch.config.base.IGPMConfig` keeps the
paper's vanilla 1-step agent.

The replay ring and the exploration draws stay host-side numpy, seeded as
in the JAX package. The initial weights come from a ``torch.Generator``
and so differ from the JAX package's draws; ``load_state_dict`` takes the
state tree of either package.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Dict, NamedTuple, Sequence, Union

import numpy as np
import torch
from torch import nn

from repro_torch.config.base import DQNSpec, IGPMConfig
from repro_torch.core.graph import check_device

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


class MLP(nn.Module):
    """``x @ w{i} + b{i}`` with ReLU between layers; ``w{i}`` is (in, out),
    the JAX package's parameter layout. He-normal weights from ``gen``."""

    def __init__(self, sizes: Sequence[int], gen: torch.Generator):
        super().__init__()
        self.n_layers = len(sizes) - 1
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            w = torch.randn((a, b), generator=gen) * float(np.sqrt(2.0 / a))
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(b)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x


class Transition(NamedTuple):
    obs: np.ndarray
    action: int
    reward: float
    next_obs: np.ndarray
    done: bool


class ReplayBuffer:
    """Host-side ring buffer (data pipeline component, not device state).

    ``discounts`` stores the per-transition bootstrap discount γ^k: plain γ
    for 1-step transitions, γ^n for n-step aggregates (γ^k, k < n, for the
    shortened tails flushed at episode ends).
    """

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 gamma: float = 0.9):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, bool)
        self.discounts = np.full(capacity, gamma, np.float32)
        self._gamma = gamma
        self.size = 0
        self.cursor = 0
        self._rng = np.random.default_rng(seed)

    def push(self, t: Transition, discount: float = None) -> None:
        if discount is None:
            discount = self._gamma
        i = self.cursor
        self.obs[i] = t.obs
        self.next_obs[i] = t.next_obs
        self.actions[i] = t.action
        self.rewards[i] = t.reward
        self.dones[i] = t.done
        self.discounts[i] = discount
        self.cursor = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, batch: int):
        idx = self._rng.integers(0, self.size, size=batch)
        return (self.obs[idx], self.actions[idx], self.rewards[idx],
                self.next_obs[idx], self.dones[idx], self.discounts[idx])


def _as_spec(cfg: Union[IGPMConfig, DQNSpec]) -> DQNSpec:
    if isinstance(cfg, DQNSpec):
        return cfg
    return DQNSpec(
        obs_dim=cfg.dqn_obs_dim, n_actions=cfg.dqn_n_actions,
        hidden=tuple(cfg.dqn_hidden), epsilon=cfg.epsilon, gamma=cfg.gamma,
        lr=cfg.dqn_lr, replay_capacity=cfg.replay_capacity,
        replay_batch=cfg.replay_batch,
        target_update_every=cfg.target_update_every,
        double=False, n_step=1)


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host copies (never views of the live tensors, which train on)."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            for k, v in tree.items()}


class DQNAgent:
    def __init__(self, cfg: Union[IGPMConfig, DQNSpec], seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        spec = _as_spec(cfg)
        self.spec = spec
        self.device = check_device(device)
        sizes = (spec.obs_dim,) + tuple(spec.hidden) + (spec.n_actions,)
        gen = torch.Generator().manual_seed(seed)
        self.net = MLP(sizes, gen).to(self.device)
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.m = {k: torch.zeros_like(p) for k, p in self._named()}
        self.v = {k: torch.zeros_like(p) for k, p in self._named()}
        self.t = 0
        self.replay = ReplayBuffer(spec.replay_capacity, spec.obs_dim,
                                   seed=seed, gamma=spec.gamma)
        self._pending: deque = deque()  # n-step aggregation window
        self._rng = np.random.default_rng(seed + 1)

    def _named(self):
        return self.net.named_parameters()

    def _sync_target(self) -> None:
        with torch.no_grad():
            for k, p in self.net.named_parameters():
                getattr(self.target_net, k).copy_(p)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self._named())

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.device)
            return self.net(x).cpu().numpy()

    @property
    def epsilon_now(self) -> float:
        """Exploration rate at the current training step: flat
        ``spec.epsilon`` unless ``epsilon_decay_steps > 0``, then a
        linear ramp to ``spec.epsilon_final`` over that many observes."""
        spec = self.spec
        if spec.epsilon_decay_steps <= 0:
            return spec.epsilon
        frac = min(self.t / spec.epsilon_decay_steps, 1.0)
        return spec.epsilon + (spec.epsilon_final - spec.epsilon) * frac

    def act(self, obs: np.ndarray, greedy: bool = False) -> int:
        """ε-greedy (paper §IV-C: ε = 0.5); ``greedy=True`` for a frozen
        policy (no exploration, no RNG consumption — replayable)."""
        if not greedy and self._rng.random() < self.epsilon_now:
            return int(self._rng.integers(self.spec.n_actions))
        return int(np.argmax(self.q_values(obs[None])[0]))

    # -- persistence (serving restarts) --------------------------------------

    def state_dict(self) -> Dict:
        """Learner state as a tree of host arrays — params, target net,
        Adam moments, step count, and the replay ring — in the JAX
        package's layout (``MatchServer.save_policy``). The n-step pending
        window is not saved: it spans an in-flight episode, and a restarted
        server starts a fresh one."""
        rb = self.replay
        return {
            "params": _host(self.params),
            "target_params": _host(dict(self.target_net.named_parameters())),
            "m": _host(self.m),
            "v": _host(self.v),
            "t": np.asarray(self.t, np.int64),
            "replay": {
                "obs": rb.obs.copy(), "next_obs": rb.next_obs.copy(),
                "actions": rb.actions.copy(), "rewards": rb.rewards.copy(),
                "dones": rb.dones.copy(),
                "discounts": rb.discounts.copy(),
                "size": np.asarray(rb.size, np.int64),
                "cursor": np.asarray(rb.cursor, np.int64),
            },
        }

    def load_state_dict(self, sd: Dict) -> None:
        """Restore the learner from :meth:`state_dict` output of either
        package (or its checkpoint round trip). The exploration RNG is not
        part of the state — a restarted server explores afresh.

        Raises ``ValueError`` if the replay ring of the state does not
        match the configured one: silently truncating or zero-padding a
        replay ring corrupts the learner's sample distribution."""
        rb, srb = self.replay, sd["replay"]
        ck_shape = tuple(np.asarray(srb["obs"]).shape)
        if ck_shape != rb.obs.shape:
            raise ValueError(
                f"replay ring mismatch: checkpoint has obs{ck_shape}, agent "
                f"configured for obs{rb.obs.shape} — construct the agent "
                "with the same replay_capacity/obs_dim as the checkpoint")

        def put(dst: Dict[str, torch.Tensor], src: Dict) -> None:
            with torch.no_grad():
                for k, t in dst.items():
                    t.copy_(torch.as_tensor(np.array(src[k], np.float32)))

        put(self.params, sd["params"])
        put(dict(self.target_net.named_parameters()), sd["target_params"])
        put(self.m, sd["m"])
        put(self.v, sd["v"])
        self.t = int(np.asarray(sd["t"]))
        rb.obs[:] = srb["obs"]
        rb.next_obs[:] = srb["next_obs"]
        rb.actions[:] = srb["actions"]
        rb.rewards[:] = srb["rewards"]
        rb.dones[:] = srb["dones"]
        # pre-discounts checkpoints restore as 1-step rings
        if "discounts" in srb:
            rb.discounts[:] = srb["discounts"]
        else:
            rb.discounts[:] = self.spec.gamma
        size, cursor = int(np.asarray(srb["size"])), int(
            np.asarray(srb["cursor"]))
        if size > rb.capacity or cursor >= rb.capacity:
            raise ValueError(
                f"replay ring mismatch: checkpoint size={size} "
                f"cursor={cursor} exceed capacity {rb.capacity}")
        rb.size = size
        rb.cursor = cursor
        self._pending.clear()

    # -- learning ------------------------------------------------------------

    def _emit_nstep(self, flush: bool) -> None:
        """Collapse the pending window into stored transitions. With
        ``flush`` (episode end) every suffix is emitted at its natural
        (shorter) horizon; otherwise only the oldest transition is emitted
        once the window holds n entries."""
        spec = self.spec
        while self._pending and (flush or len(self._pending) >= spec.n_step):
            r, disc = 0.0, 1.0
            for t in self._pending:
                r += disc * t.reward
                disc *= spec.gamma
            head = self._pending.popleft()
            tail_t = self._pending[-1] if self._pending else head
            agg = Transition(head.obs, head.action, r,
                             tail_t.next_obs, tail_t.done)
            self.replay.push(agg, discount=disc)
            if not flush:
                break

    def _td_loss(self, obs, actions, rewards, next_obs, dones,
                 discounts) -> torch.Tensor:
        """Mean squared TD error of the online net; the target (and the
        double-DQN action choice) carries no gradient."""
        q = self.net(obs)                                   # (B, A)
        q_sel = q.gather(1, actions[:, None])[:, 0]
        with torch.no_grad():
            q_tgt_next = self.target_net(next_obs)
            if self.spec.double:
                # double-DQN: online net picks the action, target scores it
                a_star = torch.argmax(self.net(next_obs), dim=1)
                q_next = q_tgt_next.gather(1, a_star[:, None])[:, 0]
            else:
                q_next = q_tgt_next.amax(dim=1)
            tgt = rewards + discounts * q_next * (1.0 - dones.float())
        return torch.mean((q_sel - tgt) ** 2)

    def _adam(self, t: int, lr: float) -> None:
        """One Adam step in the JAX package's order: moments, bias
        corrections (f32), then ``p - lr·m̂/(√v̂ + eps)``."""
        b1, b2, eps = _ADAM_B1, _ADAM_B2, _ADAM_EPS
        c1, c2 = (float(np.float32(1) - np.power(np.float32(b), np.float32(t),
                                                 dtype=np.float32))
                  for b in (b1, b2))
        with torch.no_grad():
            for k, p in self._named():
                g = p.grad
                m = b1 * self.m[k] + (1 - b1) * g
                v = b2 * self.v[k] + (1 - b2) * g * g
                mh = m / c1
                vh = v / c2
                p.copy_(p - lr * mh / (torch.sqrt(vh) + eps))
                self.m[k], self.v[k] = m, v
                p.grad = None

    def _learn(self) -> float:
        spec = self.spec
        if self.replay.size < spec.replay_batch:
            return 0.0
        obs, act, rew, nxt, done, disc = self.replay.sample(spec.replay_batch)
        dev = self.device
        as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        loss = self._td_loss(as_t(obs), as_t(act.astype(np.int64)),
                             as_t(rew), as_t(nxt), as_t(done), as_t(disc))
        loss.backward()
        self.t += 1
        self._adam(self.t, spec.lr)
        if self.t % spec.target_update_every == 0:
            self._sync_target()
        return float(loss.detach())

    def observe(self, t: Transition) -> float:
        """Push a transition and do one learning step. Returns TD loss.

        With ``n_step > 1`` the transition enters the pending window first;
        the stored transition is the γ-discounted n-step aggregate. A
        ``done`` transition flushes the whole window (shortened horizons)."""
        if self.spec.n_step <= 1:
            self.replay.push(t, discount=self.spec.gamma)
        else:
            self._pending.append(t)
            self._emit_nstep(flush=t.done)
        return self._learn()
