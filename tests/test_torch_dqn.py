"""The port's DQN (``repro_torch.core.dqn``) against the JAX package's.

Random draws do not carry across the frameworks, so every trajectory test
starts the port agent from the reference agent's ``state_dict`` (both built
with the same seed, which drives the replay sampling and exploration
draws). Then both see the same transitions and ``act`` calls. Actions,
replay rings, the step count and the target-sync steps must be equal;
Q-values, TD losses and the parameters and Adam moments after the last
step agree within 1e-5 relative / 1e-6 absolute (float rounding of two
autodiff engines). The other cases port ``tests/test_dqn.py``.
"""

import numpy as np
import pytest
import torch

from repro.config.base import DQNSpec as RSpec
from repro.config.base import IGPMConfig as RCfg
from repro.core.dqn import DQNAgent as RAgent
from repro.core.dqn import Transition as RTrans
from repro_torch.config.base import DQNSpec as TSpec
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.core.dqn import DQNAgent, ReplayBuffer, Transition

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
N_OBSERVE = 40

_SPECS = {
    "vanilla": lambda cls_cfg, cls_spec: cls_cfg(
        replay_batch=8, target_update_every=5),
    "double": lambda cls_cfg, cls_spec: cls_spec(
        obs_dim=2, n_actions=3, hidden=(8, 8), epsilon=0.3, gamma=0.8,
        lr=2e-2, replay_capacity=64, replay_batch=8, target_update_every=4,
        double=True, n_step=1),
    "nstep3": lambda cls_cfg, cls_spec: cls_spec(
        obs_dim=2, n_actions=2, hidden=(4, 4), epsilon=0.5, gamma=0.9,
        lr=1e-2, replay_capacity=32, replay_batch=8, target_update_every=6,
        double=False, n_step=3),
}


def _pair(kind, seed=0):
    ref = RAgent(_SPECS[kind](RCfg, RSpec), seed=seed)
    port = DQNAgent(_SPECS[kind](TCfg, TSpec), seed=seed, device=CPU)
    port.load_state_dict(ref.state_dict())
    return ref, port


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("kind", sorted(_SPECS))
def test_trajectory_matches_reference(kind):
    ref, port = _pair(kind)
    rng = np.random.default_rng(11)
    n_act = ref.spec.n_actions
    obs = rng.random(2).astype(np.float32)
    syncs_r, syncs_p = [], []
    for i in range(N_OBSERVE):
        a_r, a_p = ref.act(obs), port.act(obs)
        assert a_p == a_r
        # a greedy call consumes no draw in either package
        assert port.act(obs, greedy=True) == ref.act(obs, greedy=True)
        nxt = rng.random(2).astype(np.float32)
        done = kind == "nstep3" and i % 7 == 6
        reward = float(rng.normal())
        tgt_r = {k: np.asarray(v) for k, v in ref.target_params.items()}
        tgt_p = {k: v.detach().numpy().copy()
                 for k, v in port.target_net.named_parameters()}
        l_r = ref.observe(RTrans(obs, a_r % n_act, reward, nxt, done))
        l_p = port.observe(Transition(obs, a_p % n_act, reward, nxt, done))
        _close(l_p, l_r, f"loss at observe {i}")
        sd_r, sd_p = ref.state_dict(), port.state_dict()
        syncs_r.append(any((tgt_r[k] != sd_r["target_params"][k]).any()
                           for k in tgt_r))
        syncs_p.append(any((tgt_p[k] != sd_p["target_params"][k]).any()
                           for k in tgt_p))
        _close(port.q_values(nxt[None]), ref.q_values(nxt[None]),
               f"Q at observe {i}")
        obs = nxt
    assert syncs_p == syncs_r
    assert sum(syncs_r) >= 2
    sd_r, sd_p = ref.state_dict(), port.state_dict()
    assert int(sd_p["t"]) == int(sd_r["t"]) > 0
    for key in sd_r["replay"]:
        np.testing.assert_array_equal(sd_p["replay"][key],
                                      sd_r["replay"][key], err_msg=key)
    for part in ("params", "target_params", "m", "v"):
        assert sd_p[part].keys() == sd_r[part].keys()
        for k in sd_r[part]:
            _close(sd_p[part][k], sd_r[part][k], f"{part}/{k}")
            assert sd_p[part][k].dtype == np.float32


def test_state_dict_layout_matches_reference():
    ref, port = _pair("vanilla")
    sd_r, sd_p = ref.state_dict(), port.state_dict()
    assert sd_p.keys() == sd_r.keys()
    assert sd_p["replay"].keys() == sd_r["replay"].keys()
    for k, a in sd_r["params"].items():
        assert sd_p["params"][k].shape == np.asarray(a).shape
        np.testing.assert_array_equal(sd_p["params"][k], a)
    for k, a in sd_r["replay"].items():
        assert sd_p["replay"][k].dtype == np.asarray(a).dtype, k
    # and back: the reference loads the port's tree
    ref2 = RAgent(RCfg(replay_batch=8, target_update_every=5), seed=3)
    ref2.load_state_dict(sd_p)
    np.testing.assert_array_equal(np.asarray(ref2.params["w1"]),
                                  sd_p["params"]["w1"])


def test_replay_ring_buffer():
    buf = ReplayBuffer(capacity=4, obs_dim=2)
    for i in range(6):
        buf.push(Transition(np.array([i, i], np.float32), i % 2, float(i),
                            np.array([i + 1, i + 1], np.float32), False))
    assert buf.size == 4
    obs, act, rew, nxt, done, disc = buf.sample(8)
    assert obs.shape == (8, 2)
    assert rew.min() >= 2.0  # oldest two evicted
    assert disc.shape == (8,)
    np.testing.assert_allclose(disc, 0.9)  # default gamma rides every push


def test_dqn_learns_bandit():
    cfg = TCfg(epsilon=0.2, dqn_lr=5e-2, replay_batch=16, gamma=0.0,
               target_update_every=5)
    agent = DQNAgent(cfg, seed=0, device=CPU)
    obs = np.array([0.5, 0.5], np.float32)
    for _ in range(300):
        a = agent.act(obs)
        agent.observe(Transition(obs, a, 1.0 if a == 1 else 0.0, obs, True))
    q = agent.q_values(obs[None])[0]
    assert q[1] > q[0]


def test_epsilon_one_is_uniform():
    agent = DQNAgent(TCfg(epsilon=1.0), seed=0, device=CPU)
    acts = {agent.act(np.zeros(2, np.float32)) for _ in range(50)}
    assert acts == {0, 1}


def test_igpm_config_maps_to_vanilla_spec():
    """Constructing from IGPMConfig keeps the paper's 1-step vanilla DQN,
    with the reference's spec field for field."""
    agent = DQNAgent(TCfg(), seed=0, device=CPU)
    ref = RAgent(RCfg(), seed=0)
    assert agent.spec.double is False
    assert agent.spec.n_step == 1
    for f in RSpec.__dataclass_fields__:
        assert getattr(agent.spec, f) == getattr(ref.spec, f), f
    assert [p.device.type for p in agent.net.parameters()] == [CPU] * 6


def test_load_state_dict_rejects_replay_ring_mismatch():
    big = RAgent(RSpec(obs_dim=2, n_actions=2, replay_capacity=64), seed=0)
    small = DQNAgent(TSpec(obs_dim=2, n_actions=2, replay_capacity=32),
                     seed=0, device=CPU)
    with pytest.raises(ValueError, match="replay ring mismatch"):
        small.load_state_dict(big.state_dict())
    wide = DQNAgent(TSpec(obs_dim=3, n_actions=2, replay_capacity=64),
                    seed=0, device=CPU)
    with pytest.raises(ValueError, match="replay ring mismatch"):
        wide.load_state_dict(big.state_dict())
    sd = big.state_dict()
    sd["replay"]["cursor"] = np.asarray(64, np.int64)
    same = DQNAgent(TSpec(obs_dim=2, n_actions=2, replay_capacity=64),
                    seed=0, device=CPU)
    with pytest.raises(ValueError, match="replay ring mismatch"):
        same.load_state_dict(sd)


def test_load_state_dict_restores_missing_discounts_as_gamma():
    """Pre-discounts checkpoints (older layout) restore as 1-step rings."""
    spec = RSpec(obs_dim=2, n_actions=2, gamma=0.7, replay_capacity=16)
    a = RAgent(spec, seed=0)
    a.replay.push(RTrans(np.zeros(2, np.float32), 0, 1.0,
                         np.ones(2, np.float32), False), discount=0.123)
    sd = a.state_dict()
    del sd["replay"]["discounts"]
    b = DQNAgent(TSpec(obs_dim=2, n_actions=2, gamma=0.7,
                       replay_capacity=16), seed=1, device=CPU)
    b.load_state_dict(sd)
    np.testing.assert_allclose(b.replay.discounts, 0.7)
    assert b.replay.size == 1


def test_nstep_aggregation_matches_reference():
    """A 3-step window stores the γ-discounted 3-step reward with bootstrap
    discount γ³; a done flushes the suffixes at shorter horizons — the
    port's ring equals the reference's."""
    kw = dict(obs_dim=1, n_actions=2, hidden=(4,), epsilon=0.0, gamma=0.5,
              lr=1e-3, replay_capacity=64, replay_batch=64,
              target_update_every=10, double=False, n_step=3)
    ref = RAgent(RSpec(**kw), seed=0)
    port = DQNAgent(TSpec(**kw), seed=0, device=CPU)
    o = lambda v: np.array([v], np.float32)  # noqa: E731
    for i in range(4):
        ref.observe(RTrans(o(i), 0, float(i + 1), o(i + 1), done=(i == 3)))
        port.observe(Transition(o(i), 0, float(i + 1), o(i + 1),
                                done=(i == 3)))
    np.testing.assert_allclose(port.replay.rewards[0], 1 + 0.5 * 2 + 0.25 * 3)
    for f in ("obs", "next_obs", "actions", "rewards", "dones", "discounts"):
        np.testing.assert_array_equal(getattr(port.replay, f),
                                      getattr(ref.replay, f), err_msg=f)
    assert port.replay.size == ref.replay.size == 4
    assert len(port._pending) == 0
