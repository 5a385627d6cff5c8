"""The port's graph substrate, ELL mirror, stream generator and configs
against the JAX package.

Every graph and mirror array must be bitwise equal after the same updates:
the port runs the same integer/boolean bookkeeping (and exact integer-valued
float degrees), so no tolerance applies.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config.base as rcfg
import repro.core.graph as rg
import repro.data.temporal as rdata
import repro.sparse.ell as rell
import repro_torch.config.base as tcfg
import repro_torch.core.graph as tg
import repro_torch.data.temporal as tdata
import repro_torch.sparse.ell as tell
from repro_torch.configs import igpm_paper as t_paper

torch.set_num_threads(1)
CPU = "cpu"


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_graph_equal(g_ref, g_port):
    for f in rg.DynamicGraph._fields:
        np.testing.assert_array_equal(_np(getattr(g_port, f)),
                                      np.asarray(getattr(g_ref, f)), err_msg=f)


def _assert_mirror_equal(c_ref, c_port):
    for dev_f, host_f in (("_cols_d", "_cols_h"), ("_mask_d", "_mask_h"),
                          ("_row_ids_d", "_row_ids_h")):
        np.testing.assert_array_equal(_np(getattr(c_port, dev_f)),
                                      np.asarray(getattr(c_ref, dev_f)),
                                      err_msg=dev_f)
        np.testing.assert_array_equal(getattr(c_port, host_f),
                                      getattr(c_ref, host_f), err_msg=host_f)
    assert c_port._rows == c_ref._rows
    np.testing.assert_array_equal(c_port._fill, c_ref._fill)
    assert c_port._next_row == c_ref._next_row
    assert c_port._cursor == c_ref._cursor


def _spec(**kw):
    base = dict(name="toy", kind="sparse_dense", n_vertices=512,
                n_edges=4096, n_steps=40, seed=7)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [{}, {"churn": 0.5, "hotspot": True},
                                {"kind": "scale_free", "seed": 3}])
def test_stream_generator_gives_the_same_stream(kw):
    ref = rdata.generate_stream(rdata.TemporalGraphSpec(**_spec(**kw)),
                                n_measured_steps=4, u_max=128)
    port = tdata.generate_stream(tdata.TemporalGraphSpec(**_spec(**kw)),
                                 n_measured_steps=4, u_max=128, device=CPU)
    _assert_graph_equal(ref.graph, port.graph)
    assert ref.warmup_edges == port.warmup_edges
    np.testing.assert_array_equal(ref.labels, port.labels)
    assert len(ref.updates) == len(port.updates)
    for a, b in zip(ref.updates, port.updates):
        for f in rg.UpdateBatch._fields:
            np.testing.assert_array_equal(_np(getattr(b, f)),
                                          np.asarray(getattr(a, f)))


def test_toy_stream_replay_graph_and_mirror_bitwise(toy_stream):
    ref_stream = toy_stream
    port_stream = tdata.generate_stream(
        tdata.TemporalGraphSpec(**_spec()), n_measured_steps=4, u_max=128,
        device=CPU)
    n_max, e_max, k = 512, 16384, 8   # narrow rows: spill rows get used
    g_r = rg.new_graph(n_max, e_max, labels=ref_stream.labels,
                       senders=np.asarray(ref_stream.graph.senders)[
                           :int(ref_stream.graph.n_edges)],
                       receivers=np.asarray(ref_stream.graph.receivers)[
                           :int(ref_stream.graph.n_edges)])
    g_p = tg.new_graph(n_max, e_max, labels=port_stream.labels,
                       senders=_np(port_stream.graph.senders)[
                           :int(port_stream.graph.n_edges)],
                       receivers=_np(port_stream.graph.receivers)[
                           :int(port_stream.graph.n_edges)], device=CPU)
    _assert_graph_equal(g_r, g_p)
    c_r, c_p = rg.EllCache(n_max, e_max, k), tg.EllCache(n_max, e_max, k,
                                                         device=CPU)
    c_r.rebuild(g_r)
    c_p.rebuild(g_p)
    _assert_mirror_equal(c_r, c_p)
    rng = np.random.default_rng(5)
    for upd_r, upd_p in zip(ref_stream.updates, port_stream.updates):
        g_r = c_r.update(g_r, upd_r)
        g_p = c_p.update(g_p, upd_p)
        _assert_graph_equal(g_r, g_p)
        _assert_mirror_equal(c_r, c_p)
        # a mixed batch removing live arcs (and one absent arc) + relabels
        em = np.asarray(g_r.edge_mask)
        live = np.nonzero(em)[0]
        pick = rng.choice(live, size=20, replace=False)
        s = np.asarray(g_r.senders)[pick]
        d = np.asarray(g_r.receivers)[pick]
        s = np.append(s, 0)
        d = np.append(d, 511)
        add_s = rng.integers(0, n_max, 10)
        add_d = rng.integers(0, n_max, 10)
        lab_i = rng.choice(n_max, 5, replace=False)
        lab_v = rng.integers(0, 4, 5)
        kw = dict(add_src=add_s, add_dst=add_d, rem_src=s, rem_dst=d,
                  lab_ids=lab_i, lab_vals=lab_v, u_max=64, undirected=False)
        g_r = c_r.update(g_r, rg.UpdateBatch.mixed(**kw))
        g_p = c_p.update(g_p, tg.UpdateBatch.mixed(**kw, device=CPU))
        _assert_graph_equal(g_r, g_p)
        _assert_mirror_equal(c_r, c_p)
    assert c_p.n_rebuilds == c_r.n_rebuilds
    fresh_r, fresh_p = rg.ell_from_graph(g_r, k), tg.ell_from_graph(g_p, k)
    for f in ("cols", "vals", "row_ids", "mask"):
        np.testing.assert_array_equal(_np(getattr(fresh_p, f)),
                                      np.asarray(getattr(fresh_r, f)))


def test_mirror_overflow_compacts_like_the_reference():
    """Spill rows are not reclaimed on removal, so churn over ever new
    receivers runs the shared cursor out; the refresh then compacts with a
    full rebuild. A reduced row-block bound (set identically on both
    caches) makes that happen at toy size."""
    n_max, e_max, k = 64, 512, 4
    rng = np.random.default_rng(2)
    s0 = rng.integers(0, n_max, 40)
    d0 = rng.integers(0, n_max, 40)
    g_r = rg.new_graph(n_max, e_max, n_nodes=n_max, senders=s0, receivers=d0)
    g_p = tg.new_graph(n_max, e_max, n_nodes=n_max, senders=s0, receivers=d0,
                       device=CPU)
    c_r, c_p = rg.EllCache(n_max, e_max, k), tg.EllCache(n_max, e_max, k,
                                                         device=CPU)
    c_r.r_cap_block = c_p.r_cap_block = n_max + 10
    prev = None
    for t in range(12):
        src = rng.integers(0, n_max, 12)
        dst = np.full(12, t)            # 12 in-arcs → 2 spill rows for t
        kw = dict(add_src=src, add_dst=dst, u_max=16, undirected=False)
        if prev is not None:
            kw.update(rem_src=prev[0], rem_dst=prev[1])
        prev = (src, dst)
        g_r = c_r.update(g_r, rg.UpdateBatch.mixed(**kw))
        g_p = c_p.update(g_p, tg.UpdateBatch.mixed(**kw, device=CPU))
        _assert_graph_equal(g_r, g_p)
        _assert_mirror_equal(c_r, c_p)
    assert c_p.n_rebuilds == c_r.n_rebuilds > 1


@pytest.mark.parametrize("n_max", [512, 65_536])
def test_remove_edges_matches_both_reference_branches(n_max):
    """65,536 > the reference's int32-key bound, so it runs its sequential
    first-match loop there; the port's int64-keyed pass must agree with it
    and with the keyed branch at 512."""
    e_max = 256
    rng = np.random.default_rng(n_max)
    base_s = rng.integers(0, 40, 60) + (n_max - 64)
    base_d = rng.integers(0, 40, 60) + (n_max - 64)
    # duplicated arcs: some requests consume several copies
    s0 = np.concatenate([base_s, base_s[:20], base_s[:5]])
    d0 = np.concatenate([base_d, base_d[:20], base_d[:5]])
    g_r = rg.new_graph(n_max, e_max, n_nodes=n_max, senders=s0, receivers=d0)
    g_p = tg.new_graph(n_max, e_max, n_nodes=n_max, senders=s0, receivers=d0,
                       device=CPU)
    req = rng.choice(len(s0), 50)
    rs = np.concatenate([s0[req], [n_max - 1]])
    rd = np.concatenate([d0[req], [n_max - 2]])     # one absent arc
    mask = rng.random(len(rs)) < 0.8
    u = 64
    pad = lambda a, dt: np.pad(np.asarray(a, dt), (0, u - len(a)))  # noqa
    args_np = (pad(rs, np.int32), pad(rd, np.int32), pad(mask, bool))
    out_r = rg.remove_edges(g_r, *(jnp.asarray(a) for a in args_np))
    out_p = tg.remove_edges(g_p, *(torch.as_tensor(a) for a in args_np))
    _assert_graph_equal(out_r, out_p)
    assert int(np.asarray(out_r.edge_mask).sum()) < len(s0)


def test_update_helpers_match():
    g_r = rg.new_graph(32, 64, labels=np.arange(32) % 4,
                       senders=np.arange(10), receivers=np.arange(10)[::-1])
    g_p = tg.new_graph(32, 64, labels=np.arange(32) % 4,
                       senders=np.arange(10), receivers=np.arange(10)[::-1],
                       device=CPU)
    upd_r = rg.UpdateBatch.mixed(add_src=[1, 2], add_dst=[3, 4],
                                 rem_src=[0], rem_dst=[9], lab_ids=[5],
                                 lab_vals=[2], u_max=8)
    upd_p = tg.UpdateBatch.mixed(add_src=[1, 2], add_dst=[3, 4],
                                 rem_src=[0], rem_dst=[9], lab_ids=[5],
                                 lab_vals=[2], u_max=8, device=CPU)
    for f in rg.UpdateBatch._fields:
        np.testing.assert_array_equal(_np(getattr(upd_p, f)),
                                      np.asarray(getattr(upd_r, f)))
    a_r, a_p = rg.apply_update(g_r, upd_r), tg.apply_update(g_p, upd_p)
    _assert_graph_equal(a_r, a_p)
    for x, y in zip(rg.updated_vertices(a_r, upd_r, 64),
                    tg.updated_vertices(a_p, upd_p, 64)):
        np.testing.assert_array_equal(_np(y), np.asarray(x))
    np.testing.assert_array_equal(_np(tg.transition_weights(a_p)),
                                  np.asarray(rg.transition_weights(a_r)))
    pairs = [(rg.UpdateBatch.empty(8), tg.UpdateBatch.empty(8, device=CPU)),
             (rg.UpdateBatch.additions([1, 2], [5, 6], 8),
              tg.UpdateBatch.additions([1, 2], [5, 6], 8, device=CPU)),
             (rg.UpdateBatch.removals([3], [4], 8, undirected=False),
              tg.UpdateBatch.removals([3], [4], 8, undirected=False,
                                      device=CPU))]
    for b_r, b_p in pairs:
        for f in rg.UpdateBatch._fields:
            np.testing.assert_array_equal(_np(getattr(b_p, f)),
                                          np.asarray(getattr(b_r, f)))


def test_build_ell_and_capacities_match():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 50, 400)
    r = rng.integers(0, 50, 400)
    cap = rell.ell_row_capacity(64, 512, 16)
    assert tell.ell_row_capacity(64, 512, 16) == cap
    assert tell.ell_block_capacity(64, 512, 16, 2) == rell.ell_block_capacity(
        64, 512, 16, 2)
    a = rell.build_ell(r, s, 64, k=16, r_cap=cap)
    b = tell.build_ell(r, s, 64, k=16, r_cap=cap, device=CPU)
    for f in ("cols", "vals", "row_ids", "mask"):
        np.testing.assert_array_equal(_np(getattr(b, f)),
                                      np.asarray(getattr(a, f)))
    assert a.n == b.n


@pytest.mark.parametrize("name", ["IGPMConfig", "EngineConfig",
                                  "ServingConfig", "RuntimeConfig",
                                  "ControlConfig", "ObsConfig", "DQNSpec"])
def test_config_fields_and_defaults_match(name):
    ref_cls, port_cls = getattr(rcfg, name), getattr(tcfg, name)
    ref_f = [(f.name, f.type) for f in dataclasses.fields(ref_cls)]
    port_f = [(f.name, f.type) for f in dataclasses.fields(port_cls)]
    assert ref_f == port_f
    assert dataclasses.asdict(ref_cls()) == dataclasses.asdict(port_cls())


def test_full_config_and_backend_resolution():
    from repro.configs import igpm_paper as r_paper
    assert dataclasses.asdict(r_paper.FULL) == dataclasses.asdict(t_paper.FULL)
    assert dataclasses.asdict(r_paper.SMOKE) == dataclasses.asdict(
        t_paper.SMOKE)
    assert [s.dims for s in r_paper.SHAPES] == [s.dims for s in
                                                t_paper.SHAPES]
    assert tcfg.resolve_backend("auto", "cpu") == "coo"
    assert tcfg.resolve_backend("auto", "cuda") == "ell"
    assert tcfg.resolve_backend("coo", "cuda") == "coo"
    assert dataclasses.asdict(tcfg.ServingConfig(adaptive=False).engine()) \
        == dataclasses.asdict(rcfg.ServingConfig(adaptive=False).engine())
