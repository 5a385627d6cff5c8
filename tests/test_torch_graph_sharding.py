"""The port's graph axis: host layouts against the JAX package's, and the
split sweeps against the port's replicated ones.

The reference's host routers (``build_ell_sharded``, ``EllCache(n_shards,
partitioned)``, ``EdgePartition``) and its shard-count arithmetic run in
this process on its one device; their arrays must equal the port's
bitwise after the same seeded churn stream, and an overflowing slice must
raise ``PartitionOverflowError`` on the same update in both. The port's
sweeps over a graph axis of ``["cpu"] * 2`` and ``["cpu"] * 4`` — ``rwr``,
``label_rwr``, ``rwr_adaptive`` (table, sweeps and skipped columns), the
bounded BFS, on COO, plain ELL and partitioned storage — must equal its
replicated sweeps bitwise. Sizes are the reference's sharding tests' (n
256, K 8, e_max 4,096).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as rg
import repro.engine.sharding as rsh
import repro_torch.core.graph as tg
import repro_torch.engine.sharding as tsh
from repro.sparse.ell import build_ell_sharded as r_build_sharded
from repro_torch.core.gray import _bfs_reach_hops
from repro_torch.core.rwr import (label_rwr, label_rwr_adaptive,
                                  restart_onehot, rwr, rwr_adaptive)
from repro_torch.engine.sharding import ShardedSweep
from repro_torch.sparse.ell import build_ell_sharded as t_build_sharded

torch.set_num_threads(1)
CPU = "cpu"
N, K, E_MAX = 256, 8, 4096


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _graph(seed=0, ne=1500):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, N).astype(np.int32)
    s, r = rng.integers(0, N, ne), rng.integers(0, N, ne)
    return tg.new_graph(N, E_MAX, labels=labels, senders=s, receivers=r,
                        device=CPU), rng


def _churn(g, rng, n_add=40, n_rem=10, u_max=128, hot=None):
    """One mixed add/remove batch drawn against the live arcs of ``g``, as
    (port batch, reference batch)."""
    src = rng.integers(0, N, n_add)
    dst = rng.integers(0, N, n_add)
    if hot is not None:
        dst = dst % hot
    em = _np(g.edge_mask)
    ls, lr = _np(g.senders)[em], _np(g.receivers)[em]
    rem = (None, None)
    if len(ls) and n_rem:
        idx = rng.choice(len(ls), size=min(n_rem, len(ls)), replace=False)
        rem = (ls[idx], lr[idx])
    kw = dict(add_src=src, add_dst=dst, rem_src=rem[0], rem_dst=rem[1],
              u_max=u_max, undirected=False)
    return tg.UpdateBatch.mixed(**kw, device=CPU), rg.UpdateBatch.mixed(**kw)


def _cat(blocks):
    """The blocks as one host tile, in the reference's sharded layout."""
    return {f: np.concatenate([_np(getattr(b, f)) for b in blocks.blocks])
            for f in ("cols", "vals", "row_ids", "mask")}


def _ref_graph(g):
    return rg.DynamicGraph(*(jnp.asarray(_np(t)) for t in g))


# -- host layouts against the reference ---------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_build_ell_sharded_equals_reference(n_shards):
    g, _ = _graph(seed=n_shards)
    em = _np(g.edge_mask)
    s, r = _np(g.senders)[em], _np(g.receivers)[em]
    want = r_build_sharded(r, s, N, n_shards, k=K)
    got = t_build_sharded(r, s, N, n_shards, k=K, devices=[CPU] * n_shards)
    assert got.n_shards == n_shards
    assert all(b.n == want.n == N // n_shards for b in got.blocks)
    cat = _cat(got)
    for f in ("cols", "vals", "row_ids", "mask"):
        np.testing.assert_array_equal(cat[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    via_graph = _cat(tg.ell_from_graph(g, K, n_shards=n_shards))
    want = rg.ell_from_graph(_ref_graph(g), K, n_shards=n_shards)
    for f in ("cols", "row_ids", "mask"):
        np.testing.assert_array_equal(via_graph[f],
                                      np.asarray(getattr(want, f)))


def _assert_cache_equal(c_ref, c_port):
    for f in ("_cols_d", "_mask_d", "_row_ids_d"):
        np.testing.assert_array_equal(_np(getattr(c_port, f)),
                                      np.asarray(getattr(c_ref, f)),
                                      err_msg=f)
    for f in ("_cols_h", "_mask_h", "_row_ids_h", "_fill"):
        np.testing.assert_array_equal(getattr(c_port, f),
                                      getattr(c_ref, f), err_msg=f)
    assert c_port._rows == c_ref._rows
    assert c_port._next_row == c_ref._next_row
    assert c_port._cursor == c_ref._cursor
    assert c_port.n_rebuilds == c_ref.n_rebuilds
    assert c_port.occupancy() == c_ref.occupancy()


@pytest.mark.parametrize("partitioned", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_ell_cache_blocks_equal_reference_through_churn(n_shards,
                                                        partitioned):
    g, rng = _graph(seed=7, ne=600)
    g_r = _ref_graph(g)
    c_p = tg.EllCache(N, E_MAX, K, n_shards=n_shards,
                      partitioned=partitioned, devices=[CPU] * n_shards)
    c_r = rg.EllCache(N, E_MAX, K, n_shards=n_shards,
                      partitioned=partitioned)
    assert (c_p.r_cap_block, c_p.r_cap) == (c_r.r_cap_block, c_r.r_cap)
    for _ in range(5):
        upd_p, upd_r = _churn(g, rng)
        g = c_p.update(g, upd_p)
        g_r = c_r.update(g_r, upd_r)
        _assert_cache_equal(c_r, c_p)
    ell = c_p.ell
    assert ell.n_shards == n_shards
    assert all(b.n == N // n_shards for b in ell.blocks)
    assert all(b.cols.shape == (c_p.r_cap_block, K) for b in ell.blocks)


def _assert_partition_equal(p_ref, p_port):
    for f in ("_send_h", "_recv_h", "_mask_h"):
        np.testing.assert_array_equal(getattr(p_port, f),
                                      getattr(p_ref, f), err_msg=f)
    part_r, part_p = p_ref.part, p_port.part
    for f in ("senders", "receivers_loc", "mask"):
        np.testing.assert_array_equal(
            np.stack([_np(t) for t in getattr(part_p, f)]),
            np.asarray(getattr(part_r, f)), err_msg=f)
    assert (p_port._fill, p_port._live, p_port._cursor) == (
        p_ref._fill, p_ref._live, p_ref._cursor)
    assert (p_port.n_rebuilds, p_port.n_compactions) == (
        p_ref.n_rebuilds, p_ref.n_compactions)
    assert p_port.occupancy() == p_ref.occupancy()


@pytest.mark.parametrize("cap", [None, 64])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_edge_partition_equals_reference_through_churn(n_shards, cap):
    """Routed adds and removals, and (at a small slice capacity with all
    receivers in slice 0) order-keeping compactions, leave the same slices
    as the reference's router."""
    g, rng = _graph(seed=3, ne=20 if cap else 1500)
    g_r = _ref_graph(g)
    p_p = tg.EdgePartition(N, E_MAX, n_shards, e_cap_slice=cap,
                           devices=[CPU] * n_shards)
    p_r = rg.EdgePartition(N, E_MAX, n_shards, e_cap_slice=cap)
    assert p_p.slice_nbytes() == p_r.slice_nbytes()
    assert p_p.e_cap_slice == p_r.e_cap_slice
    for _ in range(8):
        upd_p, upd_r = _churn(g, rng, n_add=12 if cap else 40,
                              n_rem=12 if cap else 10,
                              hot=N // n_shards if cap else None)
        g = p_p.update(g, upd_p)
        g_r = p_r.update(g_r, upd_r)
        _assert_partition_equal(p_r, p_p)
    if cap:
        assert p_p.n_compactions > 0
    assert (tg.EdgePartition.replicated_nbytes(E_MAX)
            == rg.EdgePartition.replicated_nbytes(E_MAX))
    assert tg.partition_slice_capacity(4096, 4) == 1280


def _raises_at(make, updates):
    """Index of the update that raised PartitionOverflowError, and its
    message."""
    mirror, g = make()
    for i, upd in enumerate(updates):
        try:
            g = mirror.update(g, upd)
        except (tg.PartitionOverflowError, rg.PartitionOverflowError) as e:
            return i, str(e)
    return None, ""


@pytest.mark.parametrize("kind", ["edge_partition", "ell_partitioned"])
def test_overflow_raises_on_the_same_update(kind):
    """A stream that piles receivers into slice 0 overflows both packages'
    partitioned mirrors on the same update, with the same message (the
    slice, its receiver range and the overage)."""
    rng = np.random.default_rng(5)
    g0, _ = _graph(seed=5, ne=0)
    ups_p, ups_r = [], []
    g_probe = g0
    for _ in range(12):
        src = rng.integers(0, N, 40)
        dst = rng.integers(0, 8, 40)   # slice 0 of 4
        kw = dict(add_src=src, add_dst=dst, u_max=128, undirected=False)
        ups_p.append(tg.UpdateBatch.mixed(**kw, device=CPU))
        ups_r.append(rg.UpdateBatch.mixed(**kw))
        g_probe = tg.apply_update(g_probe, ups_p[-1])
    if kind == "edge_partition":
        mk_p = lambda: (tg.EdgePartition(N, E_MAX, 4, e_cap_slice=200,  # noqa
                                         devices=[CPU] * 4), g0)
        mk_r = lambda: (rg.EdgePartition(N, E_MAX, 4, e_cap_slice=200),  # noqa
                        _ref_graph(g0))
    else:
        mk_p = lambda: (tg.EllCache(N, 1024, K, n_shards=4,  # noqa: E731
                                    partitioned=True, devices=[CPU] * 4),
                        tg.new_graph(N, 1024, n_nodes=N, device=CPU))
        mk_r = lambda: (rg.EllCache(N, 1024, K, n_shards=4,  # noqa: E731
                                    partitioned=True),
                        rg.new_graph(N, 1024, n_nodes=N))
    at_p, msg_p = _raises_at(mk_p, ups_p)
    at_r, msg_r = _raises_at(mk_r, ups_r)
    assert at_p is not None and (at_p, msg_p) == (at_r, msg_r)
    assert "slice 0" in msg_p and "receivers [0, 64)" in msg_p


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_shard_counts_equal_reference(nd, monkeypatch):
    monkeypatch.setattr(rsh.jax, "devices", lambda *a: [None] * nd)
    for b_pad in (1, 2, 3, 4, 8, 16):
        for shard in ("auto", "off"):
            assert (tsh.query_shard_count(b_pad, shard, max_devices=nd)
                    == rsh.query_shard_count(b_pad, shard))
    for n_max in (6, 256, 262_144, 1000):
        for gs in ("auto", "off"):
            assert (tsh.graph_shard_count(n_max, gs, max_devices=nd)
                    == rsh.graph_shard_count(n_max, gs))
            for shard in ("auto", "off"):
                assert (tsh.device_split(shard, gs, n_max, nd)
                        == rsh.device_split(shard, gs, n_max))
    for bad in (lambda: tsh.query_shard_count(4, "rows"),
                lambda: tsh.graph_shard_count(N, "bogus")):
        with pytest.raises(ValueError):
            bad()


# -- split sweeps against the port's replicated sweeps ------------------------

def _mirrors(g, backend, nd):
    """(replicated ell, shard-local blocks, partitioned edges)."""
    if backend == "coo":
        return None, None, None
    if backend == "part":
        ep = tg.EdgePartition(N, E_MAX, nd, devices=[CPU] * nd)
        ep.rebuild(g)
        return None, None, ep.part
    blocks = tg.EllCache(N, E_MAX, K, n_shards=nd,
                         partitioned=backend == "ell_part",
                         devices=[CPU] * nd)
    blocks.rebuild(g)
    return tg.ell_from_graph(g, K), blocks.ell, None


BACKENDS = ["coo", "ell", "part", "ell_part"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nd", [2, 4])
def test_rwr_and_label_rwr_split_bitwise(nd, backend):
    g, _ = _graph()
    ell, blocks, part = _mirrors(g, backend, nd)
    sweeps = ShardedSweep([CPU] * nd)
    e = restart_onehot(torch.tensor([3, 77, 130]), N)
    want = rwr(g, e, iters=12, ell=ell)
    got, n, skipped = sweeps.run_rwr(g, e, 12, ell=blocks, part=part)
    assert (n, skipped) == (12, 0) and torch.equal(got, want)
    # warm-started sweeps distribute identically
    want_w = rwr(g, e, iters=4, r0=want, ell=ell)
    got_w, _, _ = sweeps.run_rwr(g, e, 4, r0=want, ell=blocks, part=part)
    assert torch.equal(got_w, want_w)
    want = label_rwr(g, 4, iters=10, ell=ell)
    got, n, _ = sweeps.label_table(g, 4, 10, 0.15, None, blocks, part=part)
    assert n == 10 and torch.equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nd", [2, 4])
def test_adaptive_rwr_split_bitwise_with_counts(nd, backend):
    g, _ = _graph(seed=1)
    ell, blocks, part = _mirrors(g, backend, nd)
    e = restart_onehot(torch.tensor([0, 9, 200]), N)
    want = rwr_adaptive(g, e, max_iters=40, tol=1e-5, ell=ell)
    got = ShardedSweep([CPU] * nd).run_rwr(g, e, 40, tol=1e-5, ell=blocks,
                                           part=part)
    assert got[1:] == want[1:] and 0 < got[1] < 40
    assert torch.equal(got[0], want[0])
    want = label_rwr_adaptive(g, 4, max_iters=30, tol=1e-5, ell=ell)
    got = ShardedSweep([CPU] * nd).label_table(g, 4, 30, 0.15, None, blocks,
                                               tol=1e-5, part=part)
    assert got[1:] == want[1:] and torch.equal(got[0], want[0])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nd", [2, 4])
def test_bfs_reach_split_bitwise(nd, backend):
    g, rng = _graph(seed=3)
    # kill some arcs so dead slots sit in the replicated arrays
    em = g.edge_mask.clone()
    em[::7] = False
    g = g._replace(edge_mask=em)
    ell, blocks, part = _mirrors(g, backend, nd)
    src = torch.as_tensor(rng.integers(0, N, 6).astype(np.int32))
    want = _bfs_reach_hops(g, src, 4, ell=ell)
    got = ShardedSweep([CPU] * nd).reach(g, src, 4, ell=blocks, part=part)
    assert torch.equal(got, want)


def test_partitioned_sweeps_read_no_replicated_edge():
    """With partitioned storage the sweeps read edges only from the slices:
    a node view of the graph, its edge tensors cut to width 1, gives the
    replicated result."""
    from repro_torch.engine import Engine
    from repro_torch.config.base import EngineConfig, IGPMConfig
    g, rng = _graph(seed=4)
    eng = Engine(IGPMConfig(n_max=N, e_max=E_MAX, backend="coo"),
                 EngineConfig(shard="off", graph_shard="auto",
                              edge_partition="on"),
                 device=CPU, devices=[CPU] * 4)
    assert eng.g_shards == 4 and eng.part_cache is not None
    eng.part_cache.rebuild(g)
    view = eng._node_view(g)
    assert view.senders.shape == view.receivers.shape == (1,)
    assert view.edge_mask.shape == (1,)
    for f in ("labels", "node_mask", "degree", "n_edges"):
        assert getattr(view, f) is getattr(g, f)
    part = eng._full_part
    e = restart_onehot(torch.tensor([5, 60]), N)
    got, _, _ = eng._sweeps.run_rwr(view, e, 8, part=part)
    assert torch.equal(got, rwr(g, e, iters=8))
    src = torch.as_tensor(rng.integers(0, N, 4).astype(np.int32))
    assert torch.equal(eng._sweeps.reach(view, src, 4, part=part),
                       _bfs_reach_hops(g, src, 4))
