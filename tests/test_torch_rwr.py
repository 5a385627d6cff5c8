"""The port's RWR against the JAX package's, on both sweep backends.

Tables agree to rtol 1e-6 (sums taken in another order: COO index_add vs
segment_sum, plain ELL einsum vs the interpreted Pallas kernel). Sweep and
skipped-column counts of the residual-adaptive loops must be equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as rg
import repro_torch.core.graph as tg
import repro_torch.core.rwr as tr
import repro_torch.data.temporal as tdata

# repro.core re-exports the function ``rwr`` under the submodule's name
rr = importlib.import_module("repro.core.rwr")
torch.set_num_threads(1)
RTOL = 1e-6


@pytest.fixture(scope="module")
def graphs(toy_stream):
    port = tdata.generate_stream(
        tdata.TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                                n_edges=4096, n_steps=40, seed=7),
        n_measured_steps=4, u_max=128, device="cpu")
    g_r, g_p = toy_stream.graph, port.graph
    # one update on top so degrees and the mirror's spill rows move
    g_r = rg.apply_update(g_r, toy_stream.updates[0])
    g_p = tg.apply_update(g_p, port.updates[0])
    return g_r, g_p


def _ells(graphs, backend):
    if backend == "coo":
        return None, None
    g_r, g_p = graphs
    return rg.ell_from_graph(g_r, 16), tg.ell_from_graph(g_p, 16)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_label_rwr_matches(graphs, backend):
    g_r, g_p = graphs
    e_r, e_p = _ells(graphs, backend)
    ref = rr.label_rwr(g_r, 4, iters=12, c=0.15, ell=e_r)
    port = tr.label_rwr(g_p, 4, iters=12, c=0.15, ell=e_p)
    _close(port, ref)
    # warm start from the table, a few incremental sweeps
    ref2 = rr.label_rwr(g_r, 4, iters=3, r0=ref, ell=e_r)
    port2 = tr.label_rwr(g_p, 4, iters=3, r0=port, ell=e_p)
    _close(port2, ref2)


@pytest.mark.parametrize("backend", ["coo", "ell"])
@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_rwr_adaptive_matches_with_counts(graphs, backend, tol):
    g_r, g_p = graphs
    e_r, e_p = _ells(graphs, backend)
    src = np.array([0, 5, 17, 100, 333, 511, 64, 250], np.int32)
    e_np = np.zeros((512, len(src)), np.float32)
    e_np[src, np.arange(len(src))] = 1.0
    r_ref, n_ref, sk_ref = rr.rwr_adaptive(g_r, jnp.asarray(e_np),
                                           max_iters=30, tol=tol, ell=e_r)
    r_p, n_p, sk_p = tr.rwr_adaptive(g_p, torch.as_tensor(e_np),
                                     max_iters=30, tol=tol, ell=e_p)
    _close(r_p, r_ref)
    assert n_p == int(n_ref)
    assert sk_p == int(sk_ref)


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_label_rwr_adaptive_matches_with_counts(graphs, backend):
    g_r, g_p = graphs
    e_r, e_p = _ells(graphs, backend)
    r_ref, n_ref, sk_ref = rr.label_rwr_adaptive(g_r, 4, max_iters=30,
                                                 tol=1e-5, ell=e_r)
    r_p, n_p, sk_p = tr.label_rwr_adaptive(g_p, 4, max_iters=30, tol=1e-5,
                                           ell=e_p)
    _close(r_p, r_ref)
    assert (n_p, sk_p) == (int(n_ref), int(sk_ref))
    assert 0 < n_p < 30


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_rwr_residual_and_restarts_match(graphs, backend):
    g_r, g_p = graphs
    e_r, e_p = _ells(graphs, backend)
    np.testing.assert_array_equal(tr.label_restarts(g_p, 4).numpy(),
                                  np.asarray(rr.label_restarts(g_r, 4)))
    r_ref = rr.label_rwr(g_r, 4, iters=5, ell=e_r)
    r_p = tr.label_rwr(g_p, 4, iters=5, ell=e_p)
    e_ref, e_port = rr.label_restarts(g_r, 4), tr.label_restarts(g_p, 4)
    res_ref = np.asarray(rr.rwr_residual(g_r, r_ref, e_ref, ell=e_r))
    res_p = tr.rwr_residual(g_p, r_p, e_port, ell=e_p).numpy()
    np.testing.assert_allclose(res_p, res_ref, rtol=1e-4, atol=1e-9)


def test_combine_rounds_like_separate_mul_then_add():
    rng = np.random.default_rng(0)
    e = rng.random((64, 3)).astype(np.float32)
    agg = rng.random((64, 3)).astype(np.float32)
    want = np.asarray(rr._combine(jnp.asarray(e), jnp.asarray(agg), 0.15))
    got = tr._combine(torch.as_tensor(e), torch.as_tensor(agg), 0.15).numpy()
    np.testing.assert_array_equal(got, want)
