"""The port's ``Engine`` against the JAX package's: batch mode, and state
carried across.

``Engine(mode="batch")`` on both sweep backends over the toy stream with
``query_zoo(4)``: per-step deltas and final stores equal the reference's
(keys, counts, exact flags bitwise; goodness within 1e-5 relative). The
carry-over case hands a reference engine's ``state_dict`` to the port's
``load_state_dict`` and serves on from there on both sides.
"""

import numpy as np
import pytest
import torch

import repro_torch.data.temporal as tdata
from repro.config.base import EngineConfig as REngCfg
from repro.config.base import IGPMConfig as RCfg
from repro.core.query import query_zoo as r_zoo
from repro.engine import Engine as REngine
from repro_torch.config.base import EngineConfig as TEngCfg
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.engine import Engine as TEngine

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
def test_batch_engine_matches_reference(toy_stream, port_stream, backend):
    ref = REngine(_cfg(RCfg, backend), REngCfg(mode="batch"))
    port = TEngine(_cfg(TCfg, backend), TEngCfg(mode="batch"), device=CPU)
    for q in r_zoo(4):
        ref.register(q)
    for q in t_zoo(4):
        port.register(q)
    s_r = ref.init_state(toy_stream.graph)
    s_p = port.init_state(port_stream.graph)
    for u_r, u_p in zip(toy_stream.updates[:2], port_stream.updates[:2]):
        s_r, o_r = ref.step(s_r, u_r)
        s_p, o_p = port.step(s_p, u_p)
        assert o_p.deltas == o_r.deltas
        assert (o_p.storm, o_p.n_recompute, o_p.rwr_sweeps) == (
            o_r.storm, o_r.n_recompute, o_r.rwr_sweeps)
    _stores_equal([ref.stores[q] for q in ref.qids],
                  [port.stores[q] for q in port.qids])


def test_state_dict_carries_a_reference_engine_over(toy_stream, port_stream,
                                                    tmp_path):
    """Serve two steps on the reference, hand its state_dict to a fresh
    port engine, then serve two more steps on both. The reference goes
    through its own save/load so both sides restart from the same state
    (a restore drops the Louvain dendrogram and the seed memo)."""
    backend = "coo"
    ecfg = dict(mode="incremental", adaptive=False)
    ref = REngine(_cfg(RCfg, backend), REngCfg(**ecfg))
    zoo = r_zoo(4) + [r_zoo(4)[0]._replace(name="dup")]   # one dedup alias
    for q in zoo:
        ref.register(q)
    s_r = ref.init_state(toy_stream.graph)
    for u in toy_stream.updates[:2]:
        s_r, _ = ref.step(s_r, u)
    tree = ref.state_dict(s_r)
    ref.save(s_r, str(tmp_path))
    s_r, _ = ref.load(s_r, str(tmp_path))

    port = TEngine(_cfg(TCfg, backend), TEngCfg(**ecfg), device=CPU)
    for q in t_zoo(4) + [t_zoo(4)[0]._replace(name="dup")]:
        port.register(q)
    s_p = port.load_state_dict(tree)
    assert s_p.step_idx == s_r.step_idx == 2
    _stores_equal([ref.stores[q] for q in ref.qids],
                  [port.stores[q] for q in port.qids])
    for u_r, u_p in zip(toy_stream.updates[2:], port_stream.updates[2:]):
        s_r, o_r = ref.step(s_r, u_r)
        s_p, o_p = port.step(s_p, u_p)
        assert o_p.deltas == o_r.deltas
    _stores_equal([ref.stores[q] for q in ref.qids],
                  [port.stores[q] for q in port.qids])
    # the port's own state_dict has the reference's layout and values
    mine = port.state_dict(s_p)
    theirs = ref.state_dict(s_r)
    assert mine.keys() == theirs.keys()
    for f in theirs["graph"]:
        np.testing.assert_array_equal(mine["graph"][f], theirs["graph"][f])
    for b in theirs["buckets"]:
        for f in theirs["buckets"][b]:
            np.testing.assert_array_equal(mine["buckets"][b][f],
                                          theirs["buckets"][b][f])
    np.testing.assert_array_equal(mine["aliases"], theirs["aliases"])


def test_load_state_dict_requires_the_same_registry(toy_stream):
    ref = REngine(_cfg(RCfg, "coo"), REngCfg(adaptive=False))
    for q in r_zoo(4):
        ref.register(q)
    tree = ref.state_dict(ref.init_state(toy_stream.graph))
    port = TEngine(_cfg(TCfg, "coo"), TEngCfg(adaptive=False), device=CPU)
    for q in t_zoo(3):
        port.register(q)
    with pytest.raises((ValueError, KeyError)):
        port.load_state_dict(tree)
