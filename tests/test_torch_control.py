"""The port's serving controller (``repro_torch.control``) against the JAX
package's ``repro.control``.

At the reference control tests' toy (n_max 128, ``rwr_tol`` 1e-4 so every
label-RWR runs the residual-adaptive loop and all seven actions are live,
``query_zoo(2)``, a closed-loop flash crowd of 8 ticks of 10 ms at 2,000
events/s): with one set of controller weights (the reference controller's
``state_dict`` loaded into the port's; JAX's and torch's initial draws
differ), one PEM agent and one seeded PEM ``elapsed`` schedule, both
packages' ``run_closed_loop`` under ``VirtualClock`` — with and without
the shared ``sim_service_model`` — give equal decision histories (obs
bitwise as float32, actions, rewards), equal graphs and equal stores
(goodness within ``GOOD_RTOL``); in train mode equal decisions and TD
losses within 1e-5 relative. The port-only tests mirror
``tests/test_control.py``; checkpoints with a ``control`` entry restore
across the packages in both directions; the engine at ``rwr_tol`` 1e-4
counts the reference's sweeps and skipped columns step for step; the CLI
takes ``--control``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.config.base import ControlConfig as RCtlCfg
from repro.config.base import EngineConfig as REngCfg
from repro.config.base import IGPMConfig as RCfg
from repro.config.base import ServingConfig as RServCfg
from repro.control import ServingController as RCtl
from repro.control.env import _ladder_from as r_ladder_from
from repro.core.query import query_zoo as r_zoo
from repro.engine import Engine as REngine
from repro.config.registry import get_arch as r_get_arch
from repro.control.env import ControllerEnv as RControllerEnv
from repro.launch import serve as rserve
from repro.obs.freshness import FreshnessLedger as RFresh
from repro.runtime import VirtualClock as RVClock
from repro.runtime import build_workload as r_build
from repro.runtime import flash_crowd as r_flash
from repro.runtime import run_closed_loop as r_closed
from repro.runtime import sim_service_model as r_model
from repro.runtime.runtime import AckLedger as RLedger
from repro.runtime.runtime import RuntimeKnobs as RKnobs
from repro.serving import MatchServer as RServer
from repro_torch.config.base import ControlConfig as TCtlCfg
from repro_torch.config.base import EngineConfig as TEngCfg
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.config.base import RuntimeConfig
from repro_torch.config.base import ServingConfig as TServCfg
from repro_torch.control import (ACTION_NAMES, N_ACTIONS, OBS_DIM,
                                 ControllerEnv, ServingController, obs_dim)
from repro_torch.control.env import _ladder_from
from repro_torch.core.graph import to_numpy
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.engine import Engine as TEngine
from repro_torch.launch import serve as tserve
from repro_torch.obs.freshness import FreshnessLedger
from repro_torch.runtime import (ServingRuntime, VirtualClock,
                                 build_workload, flash_crowd,
                                 run_closed_loop, run_workload_sync,
                                 sim_service_model)
from repro_torch.runtime.runtime import AckLedger, RuntimeKnobs
from repro_torch.serving import MatchServer as TServer
from test_torch_adaptive import _stores_equal, seeded_elapsed

torch.set_num_threads(1)
CPU = "cpu"
LOSS_RTOL = 1e-5
RWR_RTOL = 1e-6
# learning within one 8-tick episode: a 4-transition batch, target sync
# every 4 learning steps, decisions at every micro-batch
TRAIN_DQN = dict(replay_batch=4, target_update_every=4)


def _cfg(cls, backend="coo", **kw):
    base = dict(n_max=128, e_max=8192, ell_width=8, rwr_iters=6,
                rwr_iters_incremental=2, top_k_patterns=4,
                init_community_size=32, backend=backend, rwr_tol=1e-4)
    base.update(kw)
    return cls(**base)


def _ccfg(cls, mode, **kw):
    ccfg = cls(mode=mode, decide_every=1, **kw)
    return dataclasses.replace(ccfg,
                               dqn=dataclasses.replace(ccfg.dqn, **TRAIN_DQN))


_SC = dict(rate=2000.0, tick_s=0.01, n_ticks=8, n_vertices=128, seed=3,
           closed_loop=True)


def _ref_server(backend="coo"):
    srv = RServer(_cfg(RCfg, backend), r_zoo(2),
                  RServCfg(microbatch_window=64), seed=0)
    seeded_elapsed(srv.pem)
    return srv


def _port_server(backend="coo", pem_state=None):
    srv = TServer(_cfg(TCfg, backend), t_zoo(2),
                  TServCfg(microbatch_window=64), seed=0, device=CPU)
    if pem_state is not None:
        srv.pem.agent.load_state_dict(pem_state)
    seeded_elapsed(srv.pem)
    return srv


def _run_ref(ccfg, state=None, backend="coo", model=False,
             freshness=False):
    srv = _ref_server(backend)
    srv.pem_init = srv.pem.agent.state_dict()   # the port's PEM starts here
    knobs, ledger = RKnobs(srv), RLedger(slo_s=0.25)
    fresh = (RFresh.from_engine(srv.engine, slo_s=0.25) if freshness
             else None)
    ctl = RCtl(srv, knobs, ledger, ccfg, freshness=fresh)
    if state is not None:
        ctl.load_state_dict(state)
    wl = r_build(r_flash(**_SC), u_max=256)
    g, stats, _ = r_closed(srv, wl, clock=RVClock(), controller=ctl,
                           knobs=knobs, ledger=ledger,
                           service_model=r_model() if model else None,
                           freshness=fresh)
    return srv, ctl, g, stats


def _run_port(ccfg, state=None, backend="coo", model=False,
              freshness=False, pem_state=None):
    srv = _port_server(backend, pem_state)
    knobs, ledger = RuntimeKnobs(srv), AckLedger(slo_s=0.25)
    fresh = (FreshnessLedger.from_engine(srv.engine, slo_s=0.25)
             if freshness else None)
    ctl = ServingController(srv, knobs, ledger, ccfg, freshness=fresh)
    if state is not None:
        ctl.load_state_dict(state)
    wl = build_workload(flash_crowd(**_SC), u_max=256, device=CPU)
    g, stats, _ = run_closed_loop(srv, wl, clock=VirtualClock(),
                                  controller=ctl, knobs=knobs,
                                  ledger=ledger,
                                  service_model=(sim_service_model()
                                                 if model else None),
                                  freshness=fresh)
    return srv, ctl, g, stats


@pytest.fixture(scope="module")
def trained():
    """A reference controller trained for one closed-loop episode: the
    weights every frozen parity run starts from."""
    _, ctl, _, _ = _run_ref(_ccfg(RCtlCfg, "train"))
    assert sum(l > 0 for l in ctl.losses) >= 3
    return ctl.state_dict()


def _graphs_equal(g_port, g_ref):
    for f in g_ref._fields:
        np.testing.assert_array_equal(to_numpy(getattr(g_port, f)),
                                      np.asarray(getattr(g_ref, f)),
                                      err_msg=f)


def _pair(ccfg_kw, state, backend, model, freshness=False):
    ref = _run_ref(_ccfg(RCtlCfg, **ccfg_kw), state, backend, model,
                   freshness)
    port = _run_port(_ccfg(TCtlCfg, **ccfg_kw), state, backend, model,
                     freshness, pem_state=ref[0].pem_init)
    return ref, port


# -- parity with the reference ------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("model", [False, True], ids=["virtual", "sim_model"])
@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_frozen_history_matches_reference(trained, backend, model):
    (r_srv, r_ctl, r_g, r_st), (t_srv, t_ctl, t_g, t_st) = _pair(
        dict(mode="frozen"), trained, backend, model)
    assert len(t_ctl.history) == len(r_ctl.history) > 3
    assert t_ctl.history == r_ctl.history       # obs bitwise, actions, r
    env = t_ctl.env
    assert (env.window_idx, env.depth_idx, env.tol_idx) != env._baseline_idx
    assert t_ctl.losses == r_ctl.losses == []
    assert t_srv.engine.rwr_sweeps == r_srv.engine.rwr_sweeps
    assert [s.deltas for s in t_st] == [s.deltas for s in r_st]
    _graphs_equal(t_g, r_g)
    _stores_equal(r_srv.stores, t_srv.stores)
    assert t_ctl.env.knob_state() == r_ctl.env.knob_state()


@pytest.mark.slow
def test_frozen_history_matches_reference_with_freshness_obs():
    """``freshness_obs``: 14 dims, the last two read from each package's
    FreshnessLedger (worst staleness, fast burn) — still bitwise, under
    the service model so that staleness is not zero."""
    _, ctl, _, _ = _run_ref(_ccfg(RCtlCfg, "train", freshness_obs=True),
                            model=True, freshness=True)
    (_, r_ctl, _, _), (_, t_ctl, _, _) = _pair(
        dict(mode="frozen", freshness_obs=True), ctl.state_dict(), "coo",
        True, freshness=True)
    assert obs_dim(t_ctl.ccfg) == 14
    assert len(t_ctl.history) == len(r_ctl.history) > 3
    assert all(len(o) == 14 for o, _, _ in t_ctl.history)
    assert any(o[12] > 0 for o, _, _ in t_ctl.history)
    assert t_ctl.history == r_ctl.history


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_train_decisions_and_losses_match_reference(backend):
    """Train mode from one set of weights: ε draws come from
    ``np.random.default_rng(seed + 1)`` in both packages, so decisions
    match; TD losses within the accepted Adam divergence."""
    r_init = _ref_server(backend)
    ctl0 = RCtl(r_init, RKnobs(r_init), RLedger(slo_s=0.25),
                _ccfg(RCtlCfg, "train"))
    init = ctl0.state_dict()
    (r_srv, r_ctl, _, _), (t_srv, t_ctl, _, _) = _pair(
        dict(mode="train"), init, backend, False)
    assert [a for _, a, _ in t_ctl.history] == \
        [a for _, a, _ in r_ctl.history]
    assert t_ctl.history == r_ctl.history
    assert sum(l > 0 for l in r_ctl.losses) >= 3
    np.testing.assert_allclose(t_ctl.losses, r_ctl.losses, rtol=LOSS_RTOL)
    assert t_ctl.agent.t == r_ctl.agent.t
    for k, w in r_ctl.agent.params.items():
        np.testing.assert_allclose(t_ctl.agent.params[k].detach().numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    _stores_equal(r_srv.stores, t_srv.stores)


@pytest.mark.parametrize("backend", ["coo", "ell"])
@pytest.mark.parametrize("fgf", [0.5, -1.0], ids=["induced", "storm"])
def test_engine_at_rwr_tol_matches_reference(toy_stream, backend, fgf):
    """Residual-adaptive label RWR inside the engine: the sweep and
    skipped-column counts of every step equal the reference's, on induced
    subgraphs (cold) and on storm steps (warm-started from the last
    table, the full hard cap); the storm table within RWR_RTOL."""
    import repro_torch.data.temporal as tdata
    port_stream = tdata.generate_stream(
        tdata.TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                                n_edges=4096, n_steps=40, seed=7),
        n_measured_steps=4, u_max=128, device=CPU)
    kw = dict(n_max=512, e_max=16384, rwr_iters=30, rwr_iters_incremental=4,
              top_k_patterns=8, init_community_size=32, ell_width=16,
              backend=backend, rwr_tol=1e-4)
    ref = REngine(RCfg(**kw), REngCfg(adaptive=False, full_graph_frac=fgf))
    port = TEngine(TCfg(**kw), TEngCfg(adaptive=False, full_graph_frac=fgf),
                   device=CPU)
    for q in r_zoo(4):
        ref.register(q)
    for q in t_zoo(4):
        port.register(q)
    s_r = ref.init_state(toy_stream.graph)
    s_p = port.init_state(port_stream.graph)
    counts = []
    for u_r, u_p in zip(toy_stream.updates, port_stream.updates):
        s_r, o_r = ref.step(s_r, u_r)
        s_p, o_p = port.step(s_p, u_p)
        assert (o_p.storm, o_p.rwr_sweeps, o_p.rwr_cols_skipped) == \
            (o_r.storm, o_r.rwr_sweeps, o_r.rwr_cols_skipped)
        assert o_p.deltas == o_r.deltas
        counts.append(o_p.rwr_sweeps)
        if o_r.storm:
            np.testing.assert_allclose(s_p.r_lab.numpy(),
                                       np.asarray(s_r.r_lab), rtol=RWR_RTOL,
                                       atol=0)
    assert min(counts) < 30                      # the tolerance ended loops
    assert (port.rwr_sweeps, port.rwr_cols_skipped) == \
        (ref.rwr_sweeps, ref.rwr_cols_skipped)
    _stores_equal([ref.stores[q] for q in ref.qids],
                  [port.stores[q] for q in port.qids])


# -- port-only behaviour (tests/test_control.py's contract) -------------------

def _server(**serving_kw):
    serving_kw.setdefault("microbatch_window", 64)
    return TServer(_cfg(TCfg), t_zoo(2), TServCfg(**serving_kw), seed=0,
                   device=CPU)


def _closed_workload(**kw):
    return build_workload(flash_crowd(**dict(_SC, **kw)), u_max=256,
                          device=CPU)


def _controlled_run(ccfg, agent_state=None):
    srv = _server()
    knobs = RuntimeKnobs(srv)
    ledger = AckLedger(slo_s=0.25)
    ctl = ServingController(srv, knobs, ledger, ccfg)
    if agent_state is not None:
        ctl.agent.load_state_dict(agent_state)
    g, stats, _ = run_closed_loop(srv, _closed_workload(),
                                  clock=VirtualClock(), controller=ctl,
                                  knobs=knobs, ledger=ledger)
    return srv, ctl, g, stats


@pytest.mark.slow
def test_env_observation_and_actions_deterministic():
    ccfg = TCtlCfg(mode="train", decide_every=2)
    runs = [_controlled_run(ccfg) for _ in range(2)]
    h0, h1 = runs[0][1].history, runs[1][1].history
    assert len(h0) > 0
    assert h0 == h1
    for obs, action, reward in h0:
        assert len(obs) == OBS_DIM
        assert 0 <= action < N_ACTIONS
        assert all(0.0 <= x <= 1.0 for x in obs)
        assert -max(ccfg.viol_weight, 1.0) <= reward <= 1.0


@pytest.mark.slow
def test_control_off_is_bitwise_identical_to_sync_runner():
    wl = build_workload(flash_crowd(**dict(_SC, closed_loop=False)),
                        u_max=256, device=CPU)
    ref = _server()
    g_ref, st_ref = run_workload_sync(ref, wl, clock=VirtualClock())
    srv = _server()
    rcfg = RuntimeConfig(ingress="lockstep",
                         control=TCtlCfg(mode="off"))
    rt = ServingRuntime(srv, rcfg, clock=VirtualClock())
    st_rt = rt.serve(wl)
    assert rt.controller is None and srv.engine.control is None
    assert [s.n_events for s in st_rt] == [s.n_events for s in st_ref]
    for a, b in zip(ref.stores, srv.stores):
        assert a._patterns == b._patterns
    for f in g_ref._fields:
        np.testing.assert_array_equal(to_numpy(getattr(g_ref, f)),
                                      to_numpy(getattr(rt.graph, f)),
                                      err_msg=f)


@pytest.mark.slow
def test_frozen_policy_replay_is_repeatable():
    train_cfg = TCtlCfg(mode="train", decide_every=2)
    _, trained_ctl, _, _ = _controlled_run(train_cfg)
    frozen_cfg = dataclasses.replace(train_cfg, mode="frozen")
    state = trained_ctl.agent.state_dict()
    runs = [_controlled_run(frozen_cfg, agent_state=state)
            for _ in range(2)]
    h0, h1 = runs[0][1].history, runs[1][1].history
    assert len(h0) > 0
    assert h0 == h1
    assert runs[0][1].losses == [] and runs[1][1].losses == []
    assert [dict(s._patterns) for s in runs[0][0].stores] == \
        [dict(s._patterns) for s in runs[1][0].stores]


@pytest.mark.parametrize("mode", ["train", "frozen"])
def test_runtime_builds_and_drives_the_controller(mode):
    """``ServingRuntime`` with the controller on builds it, attaches it to
    the engine and calls its hooks: one decision per micro-batch at
    ``decide_every=1``, one episode per run."""
    srv = _server()
    rt = ServingRuntime(srv, RuntimeConfig(
        ingress="lockstep", control=TCtlCfg(mode=mode, decide_every=1)),
        clock=VirtualClock())
    ctl = rt.controller
    assert isinstance(ctl, ServingController)
    assert srv.engine.control is ctl and ctl.mode == mode
    assert ctl.agent.device == torch.device(CPU)
    stats = rt.serve(_closed_workload())
    assert ctl.n_decisions == len(ctl.history) == len(stats) > 0
    assert ctl.n_episodes == 1


@pytest.mark.slow
def test_every_delivered_delta_acked_exactly_once():
    srv = _server()
    rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep"),
                        clock=VirtualClock())
    sub = rt.subscribe(ack=True)
    rt.serve(_closed_workload())
    items = sub.drain()
    for item in items:
        sub.ack(item)
    assert rt.acks.n_delivered == len(items) + sub.n_evicted
    assert rt.acks.n_acked == rt.acks.n_delivered
    assert rt.acks.outstanding == 0
    assert rt.acks.n_events_acked > 0
    if items:
        with pytest.raises(ValueError, match="double"):
            sub.ack(items[-1])


def test_lag_monotone_while_executor_stalls():
    led = AckLedger(slo_s=0.1)
    led.deliver(step=0, arrivals=(1.0,), t=1.0, expected={0: 1})
    lags = [led.lag(t, pending=0) for t in (1.0, 2.0, 3.5, 10.0)]
    assert lags == sorted(lags)
    assert lags[-1] == pytest.approx(10.0)
    led.ack(0, 0, t=10.0)
    assert led.n_viol == 1 and led.n_good == 0
    assert led.lag(11.0, pending=0) == 0.0
    with pytest.raises(ValueError, match="double"):
        led.ack(0, 0, t=10.5)


def test_eviction_forfeits_ack_and_completes_batch():
    srv = _server()
    rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep",
                                           subscriber_depth=1),
                        clock=VirtualClock())
    sub = rt.subscribe(ack=True)
    rt.serve(_closed_workload())
    assert sub.n_evicted > 0
    for item in sub.drain():
        sub.ack(item)
    assert rt.acks.outstanding == 0
    assert rt.acks.n_acked == rt.acks.n_delivered


@pytest.mark.parametrize("rwr_tol", [0.0, 1e-4])
def test_action_space_is_the_documented_ladder(rwr_tol):
    assert ACTION_NAMES[0] == "noop"
    assert N_ACTIONS == len(ACTION_NAMES) == 7
    assert OBS_DIM == 12
    for v in (1, 7, 8, 9, 64, 100, 256, 4096, 5000):
        for floor in (8, 32):
            assert _ladder_from(v, floor) == r_ladder_from(v, floor)
    srv = TServer(_cfg(TCfg, rwr_tol=rwr_tol), t_zoo(2),
                  TServCfg(microbatch_window=64, queue_depth=2048),
                  seed=0, device=CPU)
    ref = RServer(_cfg(RCfg, rwr_tol=rwr_tol), r_zoo(2),
                  RServCfg(microbatch_window=64, queue_depth=2048), seed=0)
    env = ControllerEnv(srv, RuntimeKnobs(srv), AckLedger(),
                        TCtlCfg(mode="train"))
    r_env = RControllerEnv(ref, RKnobs(ref), RLedger(),
                           RCtlCfg(mode="train"))
    assert (env.window_ladder, env.depth_ladder, env.tol_ladder) == \
        (r_env.window_ladder, r_env.depth_ladder, r_env.tol_ladder)
    assert env.window_ladder == (8, 16, 32, 64)
    assert env.depth_ladder == (256, 512, 1024, 2048)
    if rwr_tol == 0:
        # exact fixed-iteration sweeps: the tol knob is off, and moving
        # it leaves the engine on the fixed-count path
        assert env.tol_ladder == (0.0,)
        env.apply(ACTION_NAMES.index("tol_up"))
        assert srv.engine.cfg.rwr_tol == 0.0
    else:
        assert env.tol_ladder == (1e-5, 1e-4, 1e-3, 1e-2)
        env.apply(ACTION_NAMES.index("tol_up"))
        assert srv.engine.cfg.rwr_tol == 1e-3
    env.apply(ACTION_NAMES.index("window_down"))
    assert env.knobs.window == 32
    env.reset_knobs()
    assert env.knobs.window == 64
    assert srv.engine.cfg.rwr_tol == rwr_tol


# -- checkpoints ----------------------------------------------------------------

def _probe():
    return np.linspace(0.0, 1.0, OBS_DIM, dtype=np.float32)


def _trained_port_runtime():
    ccfg = TCtlCfg(mode="train", decide_every=1)
    srv = _server()
    rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep", control=ccfg),
                        clock=VirtualClock())
    rt.serve(_closed_workload())
    return srv, rt.controller


@pytest.mark.slow
def test_controller_rides_engine_checkpoint(tmp_path):
    srv, ctl = _trained_port_runtime()
    assert ctl.n_decisions > 0 and srv.engine.control is ctl
    srv.save(str(tmp_path))
    srv2 = _server()
    rt2 = ServingRuntime(srv2, RuntimeConfig(
        ingress="lockstep", control=TCtlCfg(mode="train", decide_every=1)),
        clock=VirtualClock())
    ctl2 = rt2.controller
    srv2.load(_closed_workload().graph, str(tmp_path))
    assert (ctl2.n_decisions, ctl2.n_episodes) == \
        (ctl.n_decisions, ctl.n_episodes)
    assert ctl2.env.knob_state() == ctl.env.knob_state()
    for k, a in ctl.agent.params.items():
        assert torch.equal(a, ctl2.agent.params[k]), k
    np.testing.assert_array_equal(ctl.agent.replay.obs,
                                  ctl2.agent.replay.obs)
    assert ctl2.agent.replay.size == ctl.agent.replay.size
    np.testing.assert_array_equal(ctl2.agent.q_values(_probe()),
                                  ctl.agent.q_values(_probe()))


@pytest.mark.slow
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_control_checkpoint_restores_across_packages(tmp_path, writer):
    """A checkpoint whose tree carries ``control`` restores into the other
    package's server with its controller attached: Q-values on a probe
    obs equal (f32 matmuls of the same weights, within 1e-6), knob
    indices, counters and the replay ring equal."""
    wl_r = r_build(r_flash(**_SC), u_max=256)
    wl_t = _closed_workload()
    if writer == "reference":
        src = _ref_server()
        knobs, ledger = RKnobs(src), RLedger(slo_s=0.25)
        ctl = RCtl(src, knobs, ledger, RCtlCfg(mode="train", decide_every=1))
        src.engine.control = ctl
        r_closed(src, wl_r, clock=RVClock(), controller=ctl, knobs=knobs,
                 ledger=ledger)
    else:
        src, ctl = _trained_port_runtime()
    src.save(str(tmp_path))
    if writer == "reference":
        dst = _server()
        rt = ServingRuntime(dst, RuntimeConfig(
            control=TCtlCfg(mode="frozen", decide_every=1)),
            clock=VirtualClock())
        dst.load(wl_t.graph, str(tmp_path))
        q_dst = rt.controller.agent.q_values(_probe())
    else:
        dst = _ref_server()
        r_ctl = RCtl(dst, RKnobs(dst), RLedger(slo_s=0.25),
                     RCtlCfg(mode="frozen", decide_every=1))
        dst.engine.control = r_ctl
        dst.load(wl_r.graph, str(tmp_path))
        q_dst = np.asarray(r_ctl.agent.q_values(_probe()))
    got = dst.engine.control
    q_src = np.asarray(ctl.agent.q_values(_probe()))
    np.testing.assert_allclose(q_dst, q_src, rtol=1e-6, atol=1e-6)
    assert ctl.n_decisions > 0
    assert (got.n_decisions, got.n_episodes) == \
        (ctl.n_decisions, ctl.n_episodes)
    assert got.env.knob_state() == ctl.env.knob_state()
    np.testing.assert_array_equal(got.agent.replay.obs, ctl.agent.replay.obs)
    _stores_equal(src.stores, dst.stores)


def test_control_entry_without_a_controller_is_ignored(tmp_path):
    """As in the reference: a tree or checkpoint with ``control`` restores
    into an engine with no controller attached, the entry unread."""
    srv, _ = _trained_port_runtime()
    tree = srv.engine.state_dict(srv._state)
    assert "control" in tree
    srv.save(str(tmp_path))
    bare = _server()
    assert bare.engine.control is None
    bare.engine.load_state_dict(tree)
    bare.load(_closed_workload().graph, str(tmp_path))
    assert [dict(s._patterns) for s in bare.stores] == \
        [dict(s._patterns) for s in srv.stores]


# -- the CLI ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("mode", ["train", "frozen"])
def test_cli_runs_the_controller(capsys, mode):
    argv = ["--arch", "igpm-pem", "--device", "cpu", "--async",
            "--closed-loop", "--ticks", "6", "--bank", "2", "--control",
            mode]
    if mode == "frozen":
        argv += ["--control-episodes", "1"]
    tserve.main(argv)
    out = capsys.readouterr().out
    assert "[serve] closed loop: offered=" in out
    assert f"[serve] controller[{mode}]: " in out
    if mode == "frozen":
        assert "[serve] controller: trained 1 episodes" in out


def test_cli_control_wants_closed_loop():
    """``--control`` without ``--closed-loop`` exits with the reference's
    message; without ``--async`` too (the sync branch has no controller)."""
    with pytest.raises(SystemExit) as ref_exit:
        rserve.serve_igpm_async(r_get_arch("igpm-pem", smoke=True),
                                "flash_crowd", 4000.0, 6, 2,
                                control="train", closed_loop=False)
    with pytest.raises(SystemExit) as port_exit:
        tserve.main(["--arch", "igpm-pem", "--device", "cpu", "--async",
                     "--control", "train"])
    assert str(port_exit.value) == str(ref_exit.value)
    with pytest.raises(SystemExit, match="--control wants --async"):
        tserve.main(["--arch", "igpm-pem", "--device", "cpu", "--control",
                     "frozen"])
