"""The port's ELL kernel wrappers against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX wrappers
run the Pallas kernels in interpret mode (they pick it themselves off-TPU).
Inputs come from numpy with a fixed seed and hold unsorted spill rows,
unallocated capacity rows (row_id 0, all masked) and empty vertices.

Tolerances: SpMM to rtol 1e-6 (float sums in another order), reach bitwise
(a max over exact 0/1 values). The CUDA-vs-plain test needs a card and is
skipped elsewhere. The JAX kernels are imported inside the tests that use
them, so that ``pytest --noconftest -m cuda`` runs this file on a machine
with a card and no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.spmv_ell import ops
from repro_torch.kernels.spmv_ell.ref import ell_reach_ref, ell_spmm_ref
from repro_torch.sparse.ell import build_row_index

torch.set_num_threads(1)


def _random_ell(n, r_cap, k, seed):
    """First row per vertex in vertex order, spill rows in shuffled order
    after them, capacity rows at the end; ~15 % empty vertices."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, k, n)
    deg[rng.random(n) < 0.15] = 0
    heavy = rng.random(n) < 0.05
    deg[heavy] = rng.integers(k + 1, 4 * k, int(heavy.sum()))
    rows_per_v = np.maximum(1, -(-deg // k))
    spill_owner = np.repeat(np.arange(n), rows_per_v - 1)
    rng.shuffle(spill_owner)
    n_rows = n + len(spill_owner)
    assert n_rows < r_cap
    row_ids = np.zeros(r_cap, np.int32)
    row_ids[:n] = np.arange(n)
    row_ids[n:n_rows] = spill_owner
    rows_of = [[v] for v in range(n)]
    for j, v in enumerate(spill_owner):
        rows_of[v].append(n + j)
    fill = np.zeros(r_cap, np.int64)
    for v in range(n):
        left = deg[v]
        for r in rows_of[v]:
            fill[r] = min(k, left)
            left -= fill[r]
    mask = np.arange(k)[None, :] < fill[:, None]
    cols = rng.integers(0, n, (r_cap, k)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (r_cap, k)).astype(np.float32)
    vals[~mask] = 0.0
    return cols, vals, mask, row_ids, deg


@pytest.fixture(scope="module")
def ell_data():
    return _random_ell(n=300, r_cap=480, k=16, seed=3)


def test_random_ell_has_the_hard_cases(ell_data):
    cols, vals, mask, row_ids, deg = ell_data
    n = 300
    spill = row_ids[n:]
    assert (np.diff(spill[spill > 0]) < 0).any()      # unsorted spill rows
    assert (deg == 0).any()                           # empty vertices
    assert not mask[row_ids.shape[0] - 1].any()       # capacity rows
    assert (deg > cols.shape[1]).any()                # multi-row vertices


@pytest.mark.parametrize("d", [1, 4, 40])
def test_plain_spmm_matches_pallas_kernel(ell_data, d):
    from repro.kernels.spmv_ell.ops import ell_spmm_kernel
    cols, vals, mask, row_ids, _ = ell_data
    n = 300
    x = np.random.default_rng(d).random((n, d)).astype(np.float32)
    want = np.asarray(ell_spmm_kernel(cols, vals, mask, row_ids, x, n))
    got = ops.ell_spmm(torch.as_tensor(cols), torch.as_tensor(vals),
                       torch.as_tensor(mask), torch.as_tensor(row_ids),
                       torch.as_tensor(x), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [1, 4, 40])
def test_plain_reach_matches_pallas_kernel_bitwise(ell_data, d):
    from repro.kernels.spmv_ell.ops import ell_reach_kernel
    cols, _, mask, row_ids, _ = ell_data
    n = 300
    x = (np.random.default_rng(d).random((n, d)) < 0.2).astype(np.float32)
    want = np.asarray(ell_reach_kernel(cols, mask, row_ids, x, n))
    got = ops.ell_reach(torch.as_tensor(cols), torch.as_tensor(mask),
                        torch.as_tensor(row_ids), torch.as_tensor(x),
                        n).numpy()
    np.testing.assert_array_equal(got, want)


def test_row_index_walks_each_vertex_rows_in_order(ell_data):
    cols, vals, mask, row_ids, deg = ell_data
    n = 300
    perm, row_ptr = build_row_index(torch.as_tensor(mask),
                                    torch.as_tensor(row_ids), n)
    perm, row_ptr = perm.numpy(), row_ptr.numpy()
    live = mask.any(axis=1)
    for v in range(n):
        rows = perm[row_ptr[v]:row_ptr[v + 1]]
        want = np.nonzero(live & (row_ids == v))[0]
        np.testing.assert_array_equal(rows, want)
    assert row_ptr[-1] == live.sum()
    # unallocated capacity rows (all owned by vertex 0) are never walked
    assert row_ptr[1] - row_ptr[0] == int((live & (row_ids == 0)).sum())


def test_cpu_path_launches_no_kernel(ell_data):
    cols, vals, mask, row_ids, _ = ell_data
    ops.reset_launch_counts()
    x = torch.ones((300, 4))
    ops.ell_spmm(torch.as_tensor(cols), torch.as_tensor(vals),
                 torch.as_tensor(mask), torch.as_tensor(row_ids), x, 300)
    ops.ell_reach(torch.as_tensor(cols), torch.as_tensor(mask),
                  torch.as_tensor(row_ids), x, 300)
    assert ops.LAUNCHES == {"ell_spmm": 0, "ell_reach": 0}


@pytest.mark.parametrize("bad", ["cols_dtype", "mask_shape", "x_dtype",
                                 "noncontiguous"])
def test_wrappers_reject_malformed_inputs(ell_data, bad):
    cols, vals, mask, row_ids, _ = (torch.as_tensor(a) for a in ell_data)
    x = torch.ones((300, 4))
    if bad == "cols_dtype":
        cols = cols.to(torch.int64)
    elif bad == "mask_shape":
        mask = mask[:, :8].contiguous()
    elif bad == "x_dtype":
        x = x.to(torch.float64)
    else:
        x = torch.ones((4, 300)).T
    with pytest.raises(ValueError):
        ops.ell_spmm(cols, vals, mask, row_ids, x, 300)
    with pytest.raises(ValueError):
        ops.ell_reach(cols, mask, row_ids, x, 300)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 20, 40, 320])
def test_cuda_kernels_match_plain_versions(ell_data, cuda_device, d):
    cols, vals, mask, row_ids, _ = (torch.as_tensor(a, device=cuda_device)
                                    for a in ell_data)
    n = 300
    gen = np.random.default_rng(d)
    x = torch.as_tensor(gen.random((n, d)).astype(np.float32),
                        device=cuda_device)
    xb = torch.as_tensor((gen.random((n, d)) < 0.2).astype(np.float32),
                         device=cuda_device)
    before = dict(ops.LAUNCHES)
    y = ops.ell_spmm(cols, vals, mask, row_ids, x, n)
    r = ops.ell_reach(cols, mask, row_ids, xb, n)
    assert ops.LAUNCHES["ell_spmm"] == before["ell_spmm"] + 1
    assert ops.LAUNCHES["ell_reach"] == before["ell_reach"] + 1
    torch.testing.assert_close(y, ell_spmm_ref(cols, vals, mask, row_ids,
                                               x, n), rtol=1e-5, atol=0)
    assert torch.equal(r, ell_reach_ref(cols, mask, row_ids, xb, n))
    assert torch.equal(y, ops.ell_spmm(cols, vals, mask, row_ids, x, n))
