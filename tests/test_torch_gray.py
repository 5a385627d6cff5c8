"""The port's queries, G-Ray bank matcher, subgraph extraction, Louvain and
PEM against the JAX package.

``BankGRayMatcher(memo=False)`` runs with the ``row_node`` plan of a query
bucket, as the engine drives it. ``matched``, ``hops``, ``exact`` and
``valid`` must be bitwise equal and ``goodness`` (a sum of log RWR values,
which differ in their last bits) within 1e-5. Both sides get the same
label-RWR table so the seed ranking is compared on equal inputs; the
expansion sweeps run on each side's own backend. Host-side modules
(queries, DAG plans, Louvain, extraction, PEM masks) must be bitwise equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as rg
import repro.core.query as rq
import repro.core.subgraph as rs
import repro_torch.core.graph as tg
import repro_torch.core.louvain as tl
import repro_torch.core.query as tq
import repro_torch.core.subgraph as ts
import repro_torch.data.temporal as tdata
from repro.config.base import IGPMConfig as RCfg
from repro.core.pem import PartialExecutionManager as RPem
from repro.engine.buckets import QueryBucket as RBucket
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.core.gray import (BankGRayMatcher, GRayMatcher,
                                   _find_seeds_arrays, gray_match)
from repro_torch.core.pem import PartialExecutionManager as TPem
from repro_torch.engine.buckets import QueryBucket as TBucket

rr = importlib.import_module("repro.core.rwr")
rgray = importlib.import_module("repro.core.gray")
# repro.core re-exports functions under these submodules' names
rl = importlib.import_module("repro.core.louvain")
torch.set_num_threads(1)
CPU = "cpu"


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def graphs(toy_stream):
    port = tdata.generate_stream(
        tdata.TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                                n_edges=4096, n_steps=40, seed=7),
        n_measured_steps=4, u_max=128, device=CPU)
    return toy_stream.graph, port.graph


def _cfgs(backend, **kw):
    base = dict(n_max=512, e_max=16384, rwr_iters=8, top_k_patterns=8,
                ell_width=16, backend=backend)
    base.update(kw)
    return RCfg(**base), TCfg(**base)


def _queries(kind):
    if kind == "zoo":
        idx = [0, 1, 4, 5, 9]              # triangles + squares: bucket 4x4
        return ([rq.query_zoo(12)[i] for i in idx],
                [tq.query_zoo(12)[i] for i in idx], (4, 4), 8)
    return rq.prefix_zoo(5), tq.prefix_zoo(5), (8, 16), 8


_BUCKETS = {}


def _buckets(kind, backend):
    """One reference/port bucket pair per (kind, backend), shared by the
    tests of this module so the reference compiles each matcher once."""
    if (kind, backend) not in _BUCKETS:
        _BUCKETS[kind, backend] = _new_buckets(kind, backend)
    return _BUCKETS[kind, backend]


def _new_buckets(kind, backend):
    rqs, tqs, (q, qe), b_pad = _queries(kind)
    rc, tc = _cfgs(backend)
    rb = RBucket(rc, q, qe, b_pad=b_pad, shard="off", node_cap=8 * q)
    tb = TBucket(tc, q, qe, b_pad=b_pad, node_cap=8 * q, device=CPU)
    for i, (a, b) in enumerate(zip(rqs, tqs)):
        rb.register(f"q{i}", a)
        tb.register(f"q{i}", b)
    # free a slot and re-use it: the plan's slot ids follow the history
    rb.retire("q1")
    tb.retire("q1")
    rb.register("q1b", rqs[1])
    tb.register("q1b", tqs[1])
    return rb, tb


@pytest.mark.parametrize("kind", ["zoo", "prefix"])
def test_query_helpers_and_dag_plans_match(kind):
    rqs, tqs, _, _ = _queries(kind)
    for a, b in zip(rqs, tqs):
        assert rq.query_signature(a) == tq.query_signature(b)
        assert rq.decompose(a) == tq.decompose(b)
        np.testing.assert_array_equal(tq.schedule_reads(b),
                                      rq.schedule_reads(a))
    rbank, tbank = rq.stack_queries(rqs), tq.stack_queries(tqs)
    for f in rq.QueryBank._fields[:-1]:
        np.testing.assert_array_equal(_np(getattr(tbank, f)),
                                      np.asarray(getattr(rbank, f)))
    assert rbank.names == tbank.names
    rb, tb = _buckets(kind, "coo")
    ra, ta = rb.bank_arrays(), tb.bank_arrays()
    assert ra.keys() == ta.keys()
    for key in ra:
        np.testing.assert_array_equal(ta[key], ra[key], err_msg=key)


@pytest.mark.parametrize("kind,backend,filtered", [
    ("zoo", "coo", False), ("zoo", "coo", True), ("zoo", "ell", False),
    ("zoo", "ell", True), ("prefix", "ell", True)])
def test_bank_match_with_row_node_plan(graphs, backend, kind, filtered):
    g_r, g_p = graphs
    rb, tb = _buckets(kind, backend)
    r_lab = rr.label_rwr(g_r, 4, iters=8)
    r_lab_t = torch.as_tensor(np.array(r_lab))
    ell_r = rg.ell_from_graph(g_r, 16) if backend == "ell" else None
    ell_p = tg.ell_from_graph(g_p, 16) if backend == "ell" else None
    sf = None
    if filtered:   # the storm path's recompute-mask seed filter
        sf = np.random.default_rng(4).random(512) < 0.5
    ref = rb.match(g_r, r_lab, seed_filter=None if sf is None
                   else jnp.asarray(sf), ell=ell_r)
    port = tb.match(g_p, r_lab_t, seed_filter=None if sf is None
                    else torch.as_tensor(sf), ell=ell_p)
    for f in ("matched", "hops", "exact", "valid"):
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(port.goodness.numpy(),
                               np.asarray(ref.goodness), rtol=1e-5, atol=0)
    assert np.asarray(ref.valid).any()


def test_seed_ties_below_k_rank_lower_ids_first():
    """Only 3 live vertices carry the anchor label but k = 8: the 5 −inf
    slots tie, and the ids must come out as lax.top_k orders them."""
    n = 64
    labels = np.zeros(n, np.int32)
    labels[[9, 30, 41]] = 3
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, 200)
    d = rng.integers(0, n, 200)
    g_r = rg.new_graph(n, 512, labels=labels, senders=s, receivers=d)
    g_p = tg.new_graph(n, 512, labels=labels, senders=s, receivers=d,
                       device=CPU)
    r_lab = np.asarray(rr.label_rwr(g_r, 4, iters=6))
    q_r = rq.triangle((3, 0, 1))
    q_t = tq.triangle((3, 0, 1))
    ids_r, ok_r = rgray._find_seeds_arrays(g_r, jnp.asarray(r_lab), 8, None,
                                           q_r.labels, q_r.mask, q_r.anchor)
    ids_t, ok_t = _find_seeds_arrays(g_p, torch.as_tensor(r_lab), 8, None,
                                     q_t.labels[None], q_t.mask[None],
                                     q_t.anchor[None])
    np.testing.assert_array_equal(ids_t[0].numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(ok_t[0].numpy(), np.asarray(ok_r))
    assert int(np.asarray(ok_r).sum()) == 3


def _assert_results_equal(port, ref):
    for f in ("matched", "hops", "exact", "valid"):
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      _np(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(_np(port.goodness), _np(ref.goodness),
                               rtol=1e-5, atol=0)


def test_memo_mode_is_refused(graphs):
    """Once refused, now ported: ``memo=True`` (the host-static memoized
    schedule, the reference's default) on a bank of queries of different
    schedule lengths and repeated sources (triangle, square, star-5,
    clique-4), COO and ELL, with and without a seed filter, against the
    reference's memo mode; and the port's own ``memo=False`` gives the same
    matches (goodness within 1e-5: its sweep blocks have other widths)."""
    g_r, g_p = graphs
    idx = [0, 1, 2, 3, 4]
    rbank = rq.stack_queries([rq.query_zoo(8)[i] for i in idx])
    tbank = tq.stack_queries([tq.query_zoo(8)[i] for i in idx])
    r_lab = rr.label_rwr(g_r, 4, iters=8)
    r_lab_t = torch.as_tensor(np.array(r_lab))
    sf = np.random.default_rng(2).random(512) < 0.6
    for backend in ("coo", "ell"):
        ell_r = rg.ell_from_graph(g_r, 16) if backend == "ell" else None
        ell_p = tg.ell_from_graph(g_p, 16) if backend == "ell" else None
        rm = rgray.BankGRayMatcher(rbank, 4, 8, rwr_iters=8, backend=backend,
                                   ell_width=16, memo=True)
        tm = BankGRayMatcher(tbank, 4, 8, rwr_iters=8, backend=backend,
                             ell_width=16, memo=True, device=CPU)
        assert tm.memo and tm.n_steps == rm.n_steps
        assert (tm.t_max, tm._new_pairs) == (rm.t_max, rm._new_pairs)
        for filt in (None, sf):
            ref = rm.match(g_r, r_lab, seed_filter=None if filt is None
                           else jnp.asarray(filt), ell=ell_r)
            port = tm.match(g_p, r_lab_t, seed_filter=None if filt is None
                            else torch.as_tensor(filt), ell=ell_p)
            _assert_results_equal(port, ref)
            assert np.asarray(ref.valid).any()
        plain = BankGRayMatcher(tbank, 4, 8, rwr_iters=8, backend=backend,
                                ell_width=16, memo=False, device=CPU)
        again = plain.match(g_p, r_lab_t, seed_filter=torch.as_tensor(sf),
                            ell=ell_p)
        _assert_results_equal(again, port)


@pytest.mark.parametrize("shape,backend", [
    ("triangle", "coo"), ("star5", "ell"), ("clique4", "coo"),
    ("square", "ell")])
def test_gray_matcher_and_gray_match_match_reference(graphs, shape,
                                                     backend):
    """``GRayMatcher`` (a bank of one) and the one-shot ``gray_match``."""
    g_r, g_p = graphs
    n = {"triangle": 3, "square": 4, "star5": 5, "clique4": 4}[shape]
    labels = (1, 0, 2, 3, 1)[:n]
    qr, qt = getattr(rq, shape)(labels), getattr(tq, shape)(labels)
    rm = rgray.GRayMatcher(qr, 4, 8, rwr_iters=8, backend=backend,
                           ell_width=16)
    tm = GRayMatcher(qt, 4, 8, rwr_iters=8, backend=backend, ell_width=16,
                     device=CPU)
    assert tm.schedule == rm.schedule
    ell_r = rg.ell_from_graph(g_r, 16) if backend == "ell" else None
    ell_p = tg.ell_from_graph(g_p, 16) if backend == "ell" else None
    r_lab = rm.label_table(g_r, ell=ell_r)
    r_lab_t = tm.label_table(g_p, ell=ell_p)
    np.testing.assert_allclose(r_lab_t.numpy(), np.asarray(r_lab),
                               rtol=1e-6, atol=0)
    r_lab_t = torch.as_tensor(np.array(r_lab))
    _assert_results_equal(tm.match(g_p, r_lab_t, ell=ell_p),
                          rm.match(g_r, r_lab, ell=ell_r))
    ref = rgray.gray_match(g_r, qr, 4, k=8, rwr_iters=8, r_lab=r_lab,
                           backend=backend)
    port = gray_match(g_p, qt, 4, k=8, rwr_iters=8, r_lab=r_lab_t,
                      backend=backend)
    _assert_results_equal(port, ref)


@pytest.mark.parametrize("ell_k", [None, 8])
def test_extract_induced_and_remap_match(graphs, ell_k):
    g_r, g_p = graphs
    mask = np.random.default_rng(1).random(512) < 0.3
    a = rs.extract_induced(g_r, mask, ell_k=ell_k)
    b = ts.extract_induced(g_p, mask, ell_k=ell_k)
    assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)
    np.testing.assert_array_equal(b.local_to_global, a.local_to_global)
    for f in rg.DynamicGraph._fields:
        np.testing.assert_array_equal(_np(getattr(b.graph, f)),
                                      np.asarray(getattr(a.graph, f)))
    if ell_k is not None:
        for f in ("cols", "vals", "row_ids", "mask"):
            np.testing.assert_array_equal(_np(getattr(b.ell, f)),
                                          np.asarray(getattr(a.ell, f)))
    m = np.array([[0, 3, -1], [5, 1, 2]])
    np.testing.assert_array_equal(ts.remap_matched(m, b.local_to_global),
                                  rs.remap_matched(m, a.local_to_global))


def test_louvain_partitions_match(graphs):
    g_r, _ = graphs
    em = np.asarray(g_r.edge_mask)
    s, r = np.asarray(g_r.senders)[em], np.asarray(g_r.receivers)[em]
    np.testing.assert_array_equal(tl.louvain(s, r, 512, seed=3),
                                  rl.louvain(s, r, 512, seed=3))
    np.testing.assert_array_equal(tl.louvain_constrained(s, r, 512, 16),
                                  rl.louvain_constrained(s, r, 512, 16))
    # capacity vertices past the live ones become singleton children
    a = rl.build_dendrogram(s, r, 1024, min_size=2, seed=1)
    b = tl.build_dendrogram(s, r, 1024, min_size=2, seed=1)
    np.testing.assert_array_equal(b.path_ids, a.path_ids)
    np.testing.assert_array_equal(b.path_sizes, a.path_sizes)
    for c in (2, 7, 32, 300):
        np.testing.assert_array_equal(b.cut(c), a.cut(c))


def test_pem_recompute_mask_matches_and_adaptive_is_refused(toy_stream,
                                                            graphs):
    """The recompute mask in both modes; adaptive mode (once refused, now
    ported) moves ``c`` as the reference does when the agents agree."""
    g_r, g_p = graphs
    rc, tc = _cfgs("coo", init_community_size=32)
    pr, pt = RPem(rc, adaptive=False), TPem(tc, adaptive=False)
    upd = np.asarray(toy_stream.updates[0].add_src)[:40].astype(np.int64)
    upd = np.concatenate([upd, [-1, -1]])
    mr, fr = pr.recompute_mask(g_r, upd)
    mt, ft = pt.recompute_mask(g_p, upd)
    np.testing.assert_array_equal(mt, mr)
    assert ft == fr
    assert pt.feedback(g_p, ft, 0.1) == pr.feedback(g_r, fr, 0.1)
    ar, at = RPem(rc, adaptive=True), TPem(tc, adaptive=True, device=CPU)
    at.agent.load_state_dict(ar.agent.state_dict())
    for elapsed in (0.1, 0.05, 0.2):
        mr, fr = ar.recompute_mask(g_r, upd)
        mt, ft = at.recompute_mask(g_p, upd)
        np.testing.assert_array_equal(mt, mr)
        assert at.feedback(g_p, ft, elapsed) == ar.feedback(g_r, fr, elapsed)
    assert at.c == ar.c != 32       # three ±1 moves from 32
