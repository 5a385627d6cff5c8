"""The port's ``MatchServer`` end to end against the JAX package's.

The naive incremental matcher (``adaptive=False``) on both sweep backends,
over the toy stream with ``query_zoo(4)``: every per-step match delta and
the final pattern stores must equal the reference's — keys, counts and
exact flags bitwise, the stored goodness (a sum of log RWR values) within
1e-5 relative. ``test_torch_engine.py`` holds batch mode and the state
carried across. The JAX package is imported inside the tests that use it,
so the ``cuda`` test runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import repro_torch.data.temporal as tdata
from repro_torch.config.base import EngineConfig as TEngCfg
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.config.base import ObsConfig as TObsCfg
from repro_torch.config.base import ServingConfig as TServCfg
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.engine import Engine as TEngine
from repro_torch.serving.server import MatchServer as TServer

torch.set_num_threads(1)
CPU = "cpu"
GOOD_RTOL = 1e-5


def _cfg(cls, backend):
    return cls(n_max=512, e_max=16384, rwr_iters=12, rwr_iters_incremental=4,
               top_k_patterns=8, init_community_size=32, ell_width=16,
               backend=backend)


@pytest.fixture(scope="module")
def port_stream():
    return tdata.generate_stream(
        tdata.TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                                n_edges=4096, n_steps=40, seed=7),
        n_measured_steps=4, u_max=128, device=CPU)


def _stores_equal(ref_stores, port_stores):
    assert len(ref_stores) == len(port_stores)
    for a, b in zip(ref_stores, port_stores):
        assert sorted(a._patterns) == sorted(b._patterns)
        for key, (good, exact) in a._patterns.items():
            assert b._patterns[key][1] == exact
            np.testing.assert_allclose(b._patterns[key][0], good,
                                       rtol=GOOD_RTOL)
        assert (a.total, a.exact) == (b.total, b.exact)


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_inc_server_matches_reference(toy_stream, port_stream, backend):
    from repro.config.base import IGPMConfig as RCfg
    from repro.config.base import ServingConfig as RServCfg
    from repro.core.query import query_zoo as r_zoo
    from repro.serving.server import MatchServer as RServer
    ref = RServer(_cfg(RCfg, backend), r_zoo(4), RServCfg(adaptive=False))
    port = TServer(_cfg(TCfg, backend), t_zoo(4), TServCfg(adaptive=False),
                   device=CPU)
    _, ref_stats = ref.run(toy_stream.graph, toy_stream.updates)
    _, port_stats = port.run(port_stream.graph, port_stream.updates)
    assert len(ref_stats) == len(port_stats) == 4
    for a, b in zip(ref_stats, port_stats):
        assert b.deltas == a.deltas
        assert (b.n_recompute, b.subgraph_nodes, b.subgraph_edges,
                b.n_events, b.community_size) == (
            a.n_recompute, a.subgraph_nodes, a.subgraph_edges, a.n_events,
            a.community_size)
    assert sum(d.n_new for s in port_stats for d in s.deltas) > 0
    _stores_equal(ref.stores, port.stores)


def test_entry_points_refuse_a_missing_card_and_adaptive_mode(port_stream):
    """Without a card the CUDA default raises. Adaptive mode, once refused,
    is the default ``ServingConfig()`` and builds and steps on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(_cfg(TCfg, "ell"), TEngCfg(mode="batch"))
    with pytest.raises(RuntimeError, match="cuda"):
        TServer(_cfg(TCfg, "coo"), t_zoo(1))
    srv = TServer(_cfg(TCfg, "coo"), t_zoo(1), TServCfg(), device=CPU)
    assert srv.pem.adaptive and srv.serving.adaptive
    _, stats = srv.run(port_stream.graph, port_stream.updates[:2])
    assert [s.community_size for s in stats] != [32, 32]
    assert all(p.device.type == CPU for p in srv.pem.agent.net.parameters())


@pytest.mark.cuda
def test_cuda_adaptive_server_keeps_its_agent_on_the_card():
    """The default (adaptive) server on the card: the DQN's parameters,
    target net and Adam moments are CUDA tensors, it learns within the toy
    stream, and its steps equal a CPU server's under the CPU agent's state
    and one seeded elapsed schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TCfg(n_max=512, e_max=16384, rwr_iters=12, rwr_iters_incremental=4,
               top_k_patterns=8, init_community_size=32, backend="ell",
               ell_width=16, replay_batch=4, target_update_every=2)
    spec = tdata.TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                                   n_edges=4096, n_steps=40, seed=7)
    runs = {}
    for dev in ("cpu", "cuda"):
        st = tdata.generate_stream(spec, n_measured_steps=6, u_max=128,
                                   device=dev)
        srv = TServer(cfg, t_zoo(4), TServCfg(), device=dev)
        if dev == "cuda":
            srv.pem.agent.load_state_dict(runs["cpu"][2])
        agent_state = srv.pem.agent.state_dict()
        rng = np.random.default_rng(3)
        feedback = srv.pem.feedback
        srv.pem.feedback = lambda g, f, e: feedback(
            g, f, float(rng.uniform(0.02, 0.2)))
        _, stats = srv.run(st.graph, st.updates)
        runs[dev] = (stats, srv, agent_state)
    agent = runs["cuda"][1].pem.agent
    for tree in (agent.params, agent.m, agent.v,
                 dict(agent.target_net.named_parameters())):
        assert all(t.is_cuda for t in tree.values())
    assert agent.t > 0
    cpu, card = runs["cpu"][0], runs["cuda"][0]
    assert [s.deltas for s in card] == [s.deltas for s in cpu]
    assert [s.community_size for s in card] == [s.community_size for s in cpu]
    np.testing.assert_allclose([s.rl_loss for s in card],
                               [s.rl_loss for s in cpu], rtol=1e-5)


@pytest.mark.parametrize("entry", ["engine", "server"])
@pytest.mark.parametrize("knob", [
    ("graph_shard", "auto"), ("edge_partition", "on"),
    ("partition_headroom", 2.0), ("obs", TObsCfg(enabled=True))],
    ids=lambda k: k[0])
def test_entry_points_refuse_knobs_of_unported_features(entry, knob):
    """A knob whose feature waits is refused with the ROADMAP item, through
    both entry points, instead of giving an engine without it. Tracing
    (``obs``) is ported now: both entry points build with it on."""
    name, value = knob
    if name == "obs":
        eng = (TEngine(_cfg(TCfg, "coo"), TEngCfg(adaptive=False, obs=value),
                       device=CPU) if entry == "engine"
               else TServer(_cfg(TCfg, "coo"), t_zoo(1),
                            TServCfg(adaptive=False, obs=value),
                            device=CPU).engine)
        assert eng.obs.enabled and eng.obs.tracer.enabled
        return
    with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP"):
        if entry == "engine":
            TEngine(_cfg(TCfg, "coo"),
                    TEngCfg(adaptive=False, **{name: value}), device=CPU)
        else:
            TServer(_cfg(TCfg, "coo"), t_zoo(1),
                    TServCfg(adaptive=False, **{name: value}), device=CPU)


@pytest.mark.parametrize("shard", ["auto", "off"])
def test_both_query_axis_modes_run_the_single_device_path(shard):
    srv = TServer(_cfg(TCfg, "coo"), t_zoo(1),
                  TServCfg(adaptive=False, shard=shard), device=CPU)
    assert srv.engine.ecfg.shard == shard
    with pytest.raises(ValueError, match="shard"):
        TEngine(_cfg(TCfg, "coo"), TEngCfg(adaptive=False, shard="rows"),
                device=CPU)
