"""The matcher's smaller public functions in the port against the JAX
package, on the CPU: the ELL kernels' unreduced row phases and their
``_kernel``/``_graph`` wrappers, the ``sparse`` package's products,
``vertex_mask``, ``find_seeds``, ``QueryBucket.dag_key`` and
``Engine.dag_occupancy``.

Both sides get one ELL tile built from the same seeded arcs (vertices over
the width K spill into further rows, and isolated vertices own an empty
row) and the same seeded inputs. Sums (SpMM, row partials, degrees, the
dense adjacency) are held to rtol 1e-6 / atol 1e-6: the port sums each row
in ascending slot order, the reference by ``einsum`` and ``segment_sum``
in XLA's order. Maxima, masks, seeds and bucket keys are bitwise.
"""

import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.graph as rg  # noqa: E402
import repro.core.query as rq  # noqa: E402
import repro.kernels.spmv_ell as rk  # noqa: E402
import repro.kernels.spmv_ell.ref as rref  # noqa: E402
import repro.sparse as rsparse  # noqa: E402
import repro.sparse.ell as rell  # noqa: E402
import repro_torch.core.graph as tg  # noqa: E402
import repro_torch.core.query as tq  # noqa: E402
import repro_torch.kernels.spmv_ell as tk  # noqa: E402
import repro_torch.kernels.spmv_ell.ref as tref  # noqa: E402
import repro_torch.sparse as tsparse  # noqa: E402
import repro_torch.sparse.ell as tell  # noqa: E402
from repro.config.base import EngineConfig as REngCfg  # noqa: E402
from repro.config.base import IGPMConfig as RCfg  # noqa: E402
from repro.core.gray import find_seeds as r_find_seeds  # noqa: E402
from repro.engine import Engine as REngine  # noqa: E402
from repro.engine.buckets import QueryBucket as RBucket  # noqa: E402
from repro_torch.config.base import EngineConfig as TEngCfg  # noqa: E402
from repro_torch.config.base import IGPMConfig as TCfg  # noqa: E402
from repro_torch.core.gray import find_seeds as t_find_seeds  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine.buckets import QueryBucket as TBucket  # noqa: E402

# repro.core re-exports functions under its submodules' names
rr = importlib.import_module("repro.core.rwr")
torch.set_num_threads(1)
N, K, D = 96, 8, 5
SUM_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ells():
    """(reference EllGraph, port EllGraph) of one seeded arc list: heavy
    vertices spill over K, some vertices have no arcs, and the row axis is
    padded to a capacity past the allocated rows."""
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 2 * K, N)
    deg[rng.random(N) < 0.2] = 0
    deg[:3] = 3 * K + 1
    senders = np.repeat(np.arange(N), deg)
    receivers = rng.integers(0, N, senders.size)
    weights = rng.uniform(0.1, 1.0, senders.size).astype(np.float32)
    r_cap = tell.ell_row_capacity(N, senders.size, K) + 5
    ref = rell.build_ell(senders, receivers, N, weights=weights, k=K,
                         r_cap=r_cap)
    port = tell.build_ell(senders, receivers, N, weights=weights, k=K,
                          r_cap=r_cap, device="cpu")
    return ref, port


def _x(d=D, seed=1, indicator=False):
    rng = np.random.default_rng(seed)
    if indicator:
        return (rng.random((N, d)) < 0.3).astype(np.float32)
    return rng.standard_normal((N, d)).astype(np.float32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_ell_graph_k_and_r(ells):
    ref, port = ells
    assert (port.k, port.r) == (ref.k, ref.r) == (K, ref.cols.shape[0])


def test_ell_row_partials_ref_matches(ells):
    ref, port = ells
    x = _x()
    want = rref.ell_row_partials_ref(ref.cols, ref.vals, ref.mask,
                                     jnp.asarray(x))
    got = tref.ell_row_partials_ref(port.cols, port.vals, port.mask,
                                    torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **SUM_TOL)


def test_ell_row_maxima_ref_matches(ells):
    ref, port = ells
    x = _x(indicator=True)
    want = rref.ell_row_maxima_ref(ref.cols, ref.mask, jnp.asarray(x))
    got = tref.ell_row_maxima_ref(port.cols, port.mask, torch.as_tensor(x))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_ell_spmm_kernel_matches(ells):
    ref, port = ells
    x = _x()
    want = rk.ell_spmm_kernel(ref.cols, ref.vals, ref.mask, ref.row_ids,
                              jnp.asarray(x), N)
    got = tk.ell_spmm_kernel(port.cols, port.vals, port.mask, port.row_ids,
                             torch.as_tensor(x), N)
    np.testing.assert_allclose(_np(got), _np(want), **SUM_TOL)


def test_ell_spmm_graph_matches(ells):
    ref, port = ells
    x = _x(d=3, seed=2)
    want = rk.ell_spmm_graph(ref, jnp.asarray(x))
    got = tk.ell_spmm_graph(port, torch.as_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **SUM_TOL)


def test_ell_reach_kernel_matches(ells):
    ref, port = ells
    x = _x(indicator=True)
    want = rk.ell_reach_kernel(ref.cols, ref.mask, ref.row_ids,
                               jnp.asarray(x), N)
    got = tk.ell_reach_kernel(port.cols, port.mask, port.row_ids,
                              torch.as_tensor(x), N)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_ell_reach_graph_matches(ells):
    ref, port = ells
    x = _x(d=7, seed=3, indicator=True)
    want = rk.ell_reach_graph(ref, jnp.asarray(x))
    got = tk.ell_reach_graph(port, torch.as_tensor(x))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_sparse_ell_spmm_matches(ells):
    ref, port = ells
    x = _x(seed=4)
    np.testing.assert_allclose(
        _np(tell.ell_spmm(port, torch.as_tensor(x))),
        _np(rell.ell_spmm(ref, jnp.asarray(x))), **SUM_TOL)


def test_sparse_ell_spmv_matches(ells):
    ref, port = ells
    x = _x(seed=5)[:, 0]
    np.testing.assert_allclose(
        _np(tell.ell_spmv(port, torch.as_tensor(x))),
        _np(rell.ell_spmv(ref, jnp.asarray(x))), **SUM_TOL)


def test_sparse_ell_degree_matches(ells):
    ref, port = ells
    np.testing.assert_allclose(_np(tell.ell_degree(port)),
                               _np(rell.ell_degree(ref)), **SUM_TOL)


def test_sparse_dense_adj_matches(ells):
    ref, port = ells
    np.testing.assert_allclose(_np(tell.dense_adj(port)),
                               _np(rell.dense_adj(ref)), **SUM_TOL)


def test_sparse_package_exports_the_ported_names():
    """The reference's ``sparse`` exports that are ported; the segment,
    COO, embedding-bag and sampler exports wait for ROADMAP 13.3 / 13.4."""
    waiting = {"segment_sum", "segment_max", "segment_mean",
               "segment_softmax", "coo_spmm", "scatter_add",
               "embedding_bag", "NeighborSampler"}
    assert set(tsparse.__all__) == set(rsparse.__all__) - waiting
    assert tsparse.ell_spmm is tell.ell_spmm
    assert tsparse.EllGraph is tell.EllGraph


@pytest.mark.parametrize("n_max,width,seed", [(64, 40, 0), (300, 257, 1),
                                              (8, 30, 2)])
def test_vertex_mask_matches(n_max, width, seed):
    """Duplicated ids, masked slots (whatever id they hold) and ids at both
    ends of the range."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_max, width).astype(np.int32)
    ids[:2] = (0, n_max - 1)
    mask = rng.random(width) < 0.6
    want = rg.vertex_mask(jnp.asarray(ids), jnp.asarray(mask), n_max)
    got = tg.vertex_mask(torch.as_tensor(ids), torch.as_tensor(mask), n_max)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("k", [4, 16])
def test_find_seeds_matches(filtered, k):
    """One query's seeds and their validity, bitwise; only a few vertices
    carry the anchor's label, so at k 16 the tail ties at −inf and must
    come out in ascending id order."""
    n = 64
    rng = np.random.default_rng(k)
    labels = rng.integers(0, 4, n).astype(np.int32)
    labels[labels == 3] = 2
    labels[[5, 17, 33, 40, 41, 60]] = 3
    s, d = rng.integers(0, n, 300), rng.integers(0, n, 300)
    g_r = rg.new_graph(n, 1024, labels=labels, senders=s, receivers=d)
    g_p = tg.new_graph(n, 1024, labels=labels, senders=s, receivers=d,
                       device="cpu")
    r_lab = np.array(rr.label_rwr(g_r, 4, iters=6))
    filt = rng.random(n) < 0.7 if filtered else None
    q_r, q_p = rq.triangle((3, 0, 1)), tq.triangle((3, 0, 1))
    ids_r, ok_r = r_find_seeds(g_r, q_r, jnp.asarray(r_lab), k,
                               None if filt is None else jnp.asarray(filt))
    ids_p, ok_p = t_find_seeds(g_p, q_p, torch.as_tensor(r_lab), k,
                               None if filt is None else torch.as_tensor(filt))
    assert ids_p.dtype == torch.int32 and ids_p.shape == (k,)
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_r))
    n_ok = int(np.asarray(ok_r).sum())
    assert n_ok > 0 and (n_ok < k) == (k == 16)


@pytest.mark.parametrize("q_max,qe_max,b_pad,node_cap", [(4, 4, 8, None),
                                                         (8, 16, 4, 16)])
def test_query_bucket_dag_key_matches(q_max, qe_max, b_pad, node_cap):
    base = dict(n_max=64, e_max=256, ell_width=8)
    ref = RBucket(RCfg(**base), q_max, qe_max, b_pad=b_pad, shard="off",
                  node_cap=node_cap)
    port = TBucket(TCfg(**base), q_max, qe_max, b_pad=b_pad,
                   node_cap=node_cap, device="cpu")
    assert port.dag_key == ref.dag_key


def test_engine_dag_occupancy_matches():
    """Queries of two bucket shapes registered, one retired and one added
    back: the live sub-pattern nodes and node capacity per DAG bucket."""
    base = dict(n_max=512, e_max=4096, ell_width=16)
    ref = REngine(RCfg(**base), REngCfg(mode="batch"))
    port = TEngine(TCfg(**base), TEngCfg(mode="batch"), device="cpu")
    r_ids = [ref.register(q) for q in rq.query_zoo(10)]
    p_ids = [port.register(q) for q in tq.query_zoo(10)]
    assert r_ids == p_ids
    ref.retire(r_ids[1])
    port.retire(p_ids[1])
    ref.register(rq.prefix_zoo(3)[2])
    port.register(tq.prefix_zoo(3)[2])
    assert len(port.dag_occupancy()) > 1
    assert port.dag_occupancy() == ref.dag_occupancy()
