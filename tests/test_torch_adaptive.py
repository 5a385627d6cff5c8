"""The paper's adaptive system (IGPM-PEM) in the port against the JAX
package: PEM feedback, the adaptive ``MatchServer`` and the igpm branch of
the port's serve CLI (``test_torch_checkpoint.py`` holds checkpoints and
policy persistence, ``test_torch_matcher.py`` the three matcher facades).

Two things cannot carry across the frameworks and are pinned instead: the
DQN's initial weights (the port agent loads the reference agent's
``state_dict`` before step 0; both are built with the same seed, which
drives the replay sampling and exploration draws) and the wall time that
the PEM's reward reads (both PEMs' ``feedback`` get one seeded ``elapsed``
schedule). Then deltas, community sizes, recompute sets and stores must be
equal step for step — store keys, counts and exact flags bitwise, the
stored goodness within 1e-5 relative — and TD losses agree within 1e-5.
"""

import numpy as np
import pytest
import torch

import repro.data.temporal as rdata
import repro_torch.data.temporal as tdata
from repro.config.base import IGPMConfig as RCfg
from repro.config.base import ServingConfig as RServCfg
from repro.config.registry import get_arch as r_get_arch
from repro.core.pem import PartialExecutionManager as RPem
from repro.core.query import query_zoo as r_zoo
from repro.launch import serve as rserve
from repro.serving.server import MatchServer as RServer
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.config.base import ServingConfig as TServCfg
from repro_torch.core.pem import PartialExecutionManager as TPem
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.launch import serve as tserve
from repro_torch.serving.server import MatchServer as TServer

torch.set_num_threads(1)
CPU = "cpu"
GOOD_RTOL = 1e-5
LOSS_RTOL = 1e-5
N_STEPS = 8


def _cfg(cls, backend="coo"):
    # replay_batch 4 / target sync every 2: learning and target syncs
    # happen within the stream
    return cls(n_max=512, e_max=16384, rwr_iters=12, rwr_iters_incremental=4,
               top_k_patterns=8, init_community_size=32, ell_width=16,
               backend=backend, replay_batch=4, target_update_every=2)


_SPEC = dict(name="toy", kind="sparse_dense", n_vertices=512, n_edges=4096,
             n_steps=40, seed=7)


@pytest.fixture(scope="module")
def streams():
    ref = rdata.generate_stream(rdata.TemporalGraphSpec(**_SPEC),
                                n_measured_steps=N_STEPS, u_max=128)
    port = tdata.generate_stream(tdata.TemporalGraphSpec(**_SPEC),
                                 n_measured_steps=N_STEPS, u_max=128,
                                 device=CPU)
    return ref, port


def seeded_elapsed(pem, seed=3):
    """Replace the wall time the PEM's reward reads with a seeded schedule
    (one draw per feedback call)."""
    rng = np.random.default_rng(seed)
    feedback = pem.feedback

    def fb(g, frac, elapsed):
        return feedback(g, frac, float(rng.uniform(0.02, 0.2)))

    pem.feedback = fb


def share_agent(ref_pem, port_pem):
    port_pem.agent.load_state_dict(ref_pem.agent.state_dict())


def _stores_equal(ref_stores, port_stores):
    assert len(ref_stores) == len(port_stores)
    for a, b in zip(ref_stores, port_stores):
        assert sorted(a._patterns) == sorted(b._patterns)
        for key, (good, exact) in a._patterns.items():
            assert b._patterns[key][1] == exact
            np.testing.assert_allclose(b._patterns[key][0], good,
                                       rtol=GOOD_RTOL)
        assert (a.total, a.exact) == (b.total, b.exact)


def _steps_equal(ref_stats, port_stats):
    assert len(ref_stats) == len(port_stats)
    for a, b in zip(ref_stats, port_stats):
        assert b.deltas == a.deltas
        assert (b.community_size, b.n_recompute, b.subgraph_nodes,
                b.subgraph_edges) == (a.community_size, a.n_recompute,
                                      a.subgraph_nodes, a.subgraph_edges)
        np.testing.assert_allclose(b.rl_loss, a.rl_loss, rtol=LOSS_RTOL)


# -- PEM feedback -------------------------------------------------------------

def test_pem_feedback_matches_reference(streams):
    ref_s, port_s = streams
    rc, tc = _cfg(RCfg), _cfg(TCfg)
    pr, pt = RPem(rc, adaptive=True), TPem(tc, adaptive=True, device=CPU)
    share_agent(pr, pt)
    rng = np.random.default_rng(5)
    losses = []
    for i in range(12):
        g_r, g_p = ref_s.graph, port_s.graph
        frac, elapsed = float(rng.random()), float(rng.uniform(0.01, 0.3))
        np.testing.assert_array_equal(pt.observation(g_p, frac),
                                      pr.observation(g_r, frac))
        c_r, l_r = pr.feedback(g_r, frac, elapsed)
        c_p, l_p = pt.feedback(g_p, frac, elapsed)
        assert c_p == c_r
        np.testing.assert_allclose(l_p, l_r, rtol=LOSS_RTOL)
        losses.append(l_r)
    assert sum(l > 0 for l in losses) >= 6     # learning started
    assert pt._reward_ema == pytest.approx(pr._reward_ema, rel=1e-12)


def test_pem_clips_community_size():
    pem = TPem(TCfg(init_community_size=2, min_community_size=2,
                    max_community_size=3, epsilon=1.0), device=CPU)
    g = tdata.generate_stream(tdata.TemporalGraphSpec(**_SPEC),
                              n_measured_steps=1, device=CPU).graph
    seen = {pem.feedback(g, 0.5, 0.1)[0] for _ in range(40)}
    assert seen == {2, 3}


# -- the adaptive server -------------------------------------------------------

@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_adaptive_server_matches_reference(streams, backend):
    ref_s, port_s = streams
    ref = RServer(_cfg(RCfg, backend), r_zoo(4), RServCfg(adaptive=True))
    port = TServer(_cfg(TCfg, backend), t_zoo(4), TServCfg(adaptive=True),
                   device=CPU)
    share_agent(ref.pem, port.pem)
    seeded_elapsed(ref.pem)
    seeded_elapsed(port.pem)
    _, ref_stats = ref.run(ref_s.graph, ref_s.updates)
    _, port_stats = port.run(port_s.graph, port_s.updates)
    assert len(port_stats) == N_STEPS
    _steps_equal(ref_stats, port_stats)
    assert len({s.community_size for s in port_stats}) > 1
    assert sum(s.rl_loss > 0 for s in port_stats) >= 3
    assert port.pem.agent.t == ref.pem.agent.t >= 3
    _stores_equal(ref.stores, port.stores)


def test_default_serving_config_is_adaptive_and_keeps_its_policy_on_reset(
        streams):
    _, port_s = streams
    srv = TServer(_cfg(TCfg), t_zoo(2), device=CPU)
    assert srv.pem.adaptive and srv.pem.agent is not None
    _, stats = srv.run(port_s.graph, port_s.updates[:3])
    c, t = srv.pem.c, srv.pem.agent.t
    w = srv.pem.agent.params["w0"].detach().clone()
    srv.reset()
    assert (srv.pem.c, srv.pem.agent.t) == (c, t)
    assert torch.equal(srv.pem.agent.params["w0"], w)
    assert [s.community_size for s in stats][-1] == c


# -- the port CLI's igpm branch ---------------------------------------------------

def test_cli_serves_and_restores_its_policy(tmp_path, capsys):
    argv = ["--arch", "igpm-pem", "--steps", "3", "--bank", "2",
            "--device", "cpu", "--policy-dir", str(tmp_path),
            "--register", "1:square"]
    tserve.main(argv)
    first = capsys.readouterr().out
    assert "no policy in" in first and "saved PEM policy" in first
    assert "registered square" in first
    tserve.main(argv)
    second = capsys.readouterr().out
    assert f"restored PEM policy from {tmp_path} (step 3" in second
    assert second.count("[serve] step ") == 3 + 1


@pytest.mark.parametrize("flag", [
    ["--async"], ["--trace"], ["--trace-out", "x"], ["--checkpoint-dir", "x"],
    ["--closed-loop"], ["--control", "train"], ["--metrics-port", "0"]],
    ids=lambda f: f[0])
def test_cli_refuses_flags_of_unported_features(flag):
    """Every igpm flag of the reference CLI is ported: each parses. Only
    ``--control`` has a precondition, ``--async --closed-loop``, and
    without it exits with the reference's message (the runs are in
    test_torch_obs.py, test_torch_runtime.py and test_torch_control.py)."""
    argv = ["--arch", "igpm-pem", "--device", "cpu"] + flag
    tserve.parser().parse_args(argv)
    if flag[0] == "--control":
        with pytest.raises(SystemExit) as ref_exit:
            rserve.serve_igpm_async(r_get_arch("igpm-pem", smoke=True),
                                    "flash_crowd", 4000.0, 6, 2,
                                    control="train", closed_loop=False)
        with pytest.raises(SystemExit) as port_exit:
            tserve.main(argv + ["--async"])
        assert str(port_exit.value) == str(ref_exit.value)
