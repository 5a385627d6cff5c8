"""The port's segment reductions, gathers, COO ops, embedding bags and
neighbor sampler against the JAX package's ``repro.sparse``, on the CPU.

Inputs come from numpy with a fixed seed, segment ids include ids below 0
and at or past ``num_segments`` (JAX drops them) and leave segments empty
(``segment_max`` gives -inf there). Tolerances: ``segment_sum``,
``segment_max``, ``segment_mean``, ``scatter_add``, ``coo_spmm`` and the
embedding bags bitwise in f32 — both packages add each segment's rows in
ascending row order from zero on the CPU (the port through ``index_add``,
XLA's scatter serially). ``segment_softmax`` to rtol 1e-6: torch's and
XLA's ``exp`` differ by an ulp on some inputs. The sampler bitwise (one
numpy stream).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.sparse import segment as tseg  # noqa: E402

torch.set_num_threads(1)

N_SEG = 97


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids(rng, n_rows, n_seg=N_SEG):
    """Heavy-tailed segment sizes (a few hub segments), every tenth id out
    of range (negative or ≥ n_seg), and segments 3 and 50 left empty."""
    ids = np.minimum(rng.zipf(1.6, n_rows) - 1, n_seg - 1)
    ids = rng.permutation(n_seg)[ids]
    ids[::10] = rng.choice([-1, -n_seg, n_seg, n_seg + 7], len(ids[::10]))
    ids[(ids == 3) | (ids == 50)] = n_seg
    return ids.astype(np.int32)


@pytest.mark.parametrize("shape", [(3000,), (3000, 16), (3000, 3, 4)])
@pytest.mark.parametrize("fn", ["segment_sum", "segment_max",
                                "segment_mean"])
def test_segment_reductions_match_reference_bitwise(fn, shape):
    from repro.sparse import segment as rseg
    rng = np.random.default_rng([len(fn), len(shape)])
    x = rng.standard_normal(shape).astype(np.float32)
    ids = _ids(rng, shape[0])
    want = np.asarray(getattr(rseg, fn)(jnp.asarray(x), jnp.asarray(ids),
                                        N_SEG))
    got = getattr(tseg, fn)(_t(x), _t(ids), N_SEG).numpy()
    assert got.shape == want.shape == (N_SEG,) + shape[1:]
    np.testing.assert_array_equal(got, want)
    if fn == "segment_max":
        assert np.isneginf(got[3]).all() and np.isneginf(got[50]).all()


def test_segment_max_of_an_empty_integer_segment_is_the_least_value():
    from repro.sparse import segment as rseg
    x = np.array([5, -2, 7], np.int32)
    ids = np.array([0, 0, 2], np.int32)
    want = np.asarray(rseg.segment_max(jnp.asarray(x), jnp.asarray(ids), 3))
    got = tseg.segment_max(_t(x), _t(ids), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1] == torch.iinfo(torch.int32).min


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_softmax_matches_reference(seed):
    from repro.sparse import segment as rseg
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(2000)).astype(np.float32)
    ids = _ids(rng, 2000)
    want = np.asarray(rseg.segment_softmax(jnp.asarray(x), jnp.asarray(ids),
                                           N_SEG))
    got = tseg.segment_softmax(_t(x), _t(ids), N_SEG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_segment_sum_adds_rows_in_ascending_order():
    """Against a serial numpy loop (``out[ids[i]] += x[i]`` for ascending
    i) on heavy-tailed segments: the same bits."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20000, 8)).astype(np.float32)
    ids = _ids(rng, 20000)
    want = np.zeros((N_SEG + 1, 8), np.float32)
    for i, s in enumerate(ids):
        want[s if 0 <= s < N_SEG else N_SEG] += x[i]
    np.testing.assert_array_equal(
        tseg.segment_sum(_t(x), _t(ids), N_SEG).numpy(), want[:N_SEG])


def test_segment_sum_gradient_matches_reference():
    """d/dx Σ w·segment_sum(x): w gathered by id, 0 for a dropped id."""
    from repro.sparse import segment as rseg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((500, 6)).astype(np.float32)
    w = rng.standard_normal((N_SEG, 6)).astype(np.float32)
    ids = _ids(rng, 500)
    want = jax.grad(lambda a: (rseg.segment_sum(a, jnp.asarray(ids), N_SEG)
                               * w).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (tseg.segment_sum(xt, _t(ids), N_SEG) * _t(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert (xt.grad.numpy()[(ids < 0) | (ids >= N_SEG)] == 0).all()


def test_gathers_follow_jax_index_semantics():
    """``x[idx]`` counts negatives from the end and clamps; ``jnp.take``
    and ``take_along_axis`` fill ids outside [-n, n) with NaN."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([5, -7, -1, 2, 4, -4, -5], np.int32)
    np.testing.assert_array_equal(tseg.gather_rows(_t(x), _t(idx)).numpy(),
                                  np.asarray(jnp.asarray(x)[idx]))
    np.testing.assert_array_equal(
        tseg.take_rows(_t(x), _t(idx)).numpy(),
        np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0)))
    tables = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    ids = np.array([[0, 4], [-1, 5], [7, -6], [-5, 2]], np.int32)
    want = jnp.take_along_axis(jnp.asarray(tables)[None],
                               jnp.asarray(ids)[:, :, None, None],
                               axis=2)[:, :, 0]
    np.testing.assert_array_equal(
        tseg.take_along_fields(_t(tables), _t(ids)).numpy(),
        np.asarray(want))


def test_scatter_add_matches_reference_bitwise():
    from repro.sparse import coo as rcoo
    rng = np.random.default_rng(5)
    msg = rng.standard_normal((800, 5)).astype(np.float32)
    recv = _ids(rng, 800)
    want = rcoo.scatter_add(jnp.asarray(msg), jnp.asarray(recv), N_SEG)
    np.testing.assert_array_equal(
        tsparse.scatter_add(_t(msg), _t(recv), N_SEG).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_coo_spmm_matches_reference_bitwise(masked):
    from repro.sparse import coo as rcoo
    rng = np.random.default_rng(6)
    n, e = 60, 700
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0.5, 1.5, e).astype(np.float32)
    x = rng.standard_normal((n, 7)).astype(np.float32)
    mask = rng.random(e) < 0.7 if masked else None
    want = rcoo.coo_spmm(jnp.asarray(snd), jnp.asarray(rcv), jnp.asarray(w),
                         jnp.asarray(x), n,
                         None if mask is None else jnp.asarray(mask))
    got = tsparse.coo_spmm(_t(snd), _t(rcv), _t(w), _t(x), n,
                           None if mask is None else _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("by", ["offsets", "bag_ids"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference_bitwise(mode, by, weighted):
    from repro.sparse.embedding_bag import embedding_bag as r_bag
    rng = np.random.default_rng(7)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    n_idx, n_bags = 120, 17
    indices = rng.integers(0, 50, n_idx).astype(np.int32)
    weights = (rng.uniform(0.1, 2.0, n_idx).astype(np.float32)
               if weighted else None)
    if by == "offsets":
        # bags of 0-20 ids, two of them empty
        cuts = np.sort(rng.integers(0, n_idx, n_bags - 1))
        cuts[3] = cuts[4]
        offsets = np.concatenate([[0], cuts]).astype(np.int32)
        kw_r = dict(offsets=jnp.asarray(offsets))
        kw_t = dict(offsets=_t(offsets))
    else:
        bag_ids = rng.integers(0, n_bags, n_idx).astype(np.int32)
        kw_r = dict(bag_ids=jnp.asarray(bag_ids), n_bags=n_bags)
        kw_t = dict(bag_ids=_t(bag_ids), n_bags=n_bags)
    want = r_bag(jnp.asarray(table), jnp.asarray(indices), mode=mode,
                 weights=None if weights is None else jnp.asarray(weights),
                 **kw_r)
    got = tsparse.embedding_bag(_t(table), _t(indices), mode=mode,
                                weights=None if weights is None
                                else _t(weights), **kw_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embedding_bag_refuses_unknown_mode_and_missing_bags():
    table = torch.zeros((4, 2))
    idx = torch.tensor([0, 1])
    with pytest.raises(ValueError, match="unknown mode"):
        tsparse.embedding_bag(table, idx, offsets=torch.tensor([0]),
                              mode="min")
    with pytest.raises(ValueError, match="offsets or bag_ids"):
        tsparse.embedding_bag(table, idx)


@pytest.mark.parametrize("seed", [0, 3])
def test_sampler_blocks_match_reference_bitwise(seed):
    from repro.sparse.sampler import NeighborSampler as RSampler
    rng = np.random.default_rng(seed)
    n, e = 300, 1500
    snd = rng.integers(0, n, e)
    rcv = rng.integers(0, n, e)
    snd[snd < 20] = 20            # vertices 0-19 have no out-arcs
    seeds = rng.choice(n, 32, replace=False)
    ours = tsparse.NeighborSampler(snd, rcv, n, seed=seed)
    theirs = RSampler(snd, rcv, n, seed=seed)
    for _ in range(2):            # the generator's state carries over
        a = ours.sample_block(seeds, 5, 3)
        b = theirs.sample_block(seeds, 5, 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.flatten_edges(), b.flatten_edges()):
            np.testing.assert_array_equal(x, y)
    isolated = ours.sample_neighbors(np.arange(20), 4)
    np.testing.assert_array_equal(isolated,
                                  np.repeat(np.arange(20)[:, None], 4, 1))
