"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX wrappers
run the Pallas kernels in interpret mode (they pick it themselves off-TPU).
Inputs come from numpy with a fixed seed. The ELL tiles hold unsorted spill
rows, unallocated capacity rows (row_id 0, all masked) and empty vertices;
the attention shapes are MHA, GQA and MQA with a ragged S = 200 and hd 32;
the expert GEMM shapes have unaligned C, d and f.

Tolerances: SpMM to rtol 1e-6 (float sums in another order), reach bitwise
(a max over exact 0/1 values); flash attention and the expert GEMM to
rtol 1e-4 / atol 1e-5 in f32 and rtol 2e-2 in bf16, the tolerances of
``tests/test_kernels.py`` (bf16 inputs, long f32 reductions in another
order, one bf16 rounding of the output). The bf16 atol is 2e-2 for the
expert GEMM, whose outputs are O(1). Flash attention's causal rows average
up to S values of v and shrink to a few hundredths, so its bf16 atol is
1e-3 for the plain version against the Pallas kernel (both keep the
softmax weights in f32) and, for the card's kernel, which rounds them to
bf16 before P·V, 2e-2 times the RMS of each output row of the plain
version. The CUDA-vs-plain tests need a
card and are skipped elsewhere; on the card two launches must also give
the same bits. The JAX kernels are imported inside the tests that use
them, so that ``pytest --noconftest -m cuda`` runs this file on a machine
with a card and no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import expert_gemm as gemm_ops
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.kernels.expert_gemm.ref import expert_gemm_ref
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)
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


# -- flash attention and the expert GEMM -------------------------------------------

FLASH_SHAPES = [(128, 4, 4, 64),   # MHA
                (256, 4, 2, 64),   # GQA
                (200, 8, 1, 32)]   # MQA, ragged S, small hd
GEMM_SHAPES = [(4, 96, 200, 72),   # unaligned everything
               (8, 128, 128, 128),
               (2, 320, 64, 768),  # qwen3-moe-ish expert
               (1, 8, 8, 8)]


def _tol(dtype, bf16_atol=2e-2):
    return (dict(rtol=2e-2, atol=bf16_atol) if dtype == "bfloat16"
            else dict(rtol=1e-4, atol=1e-5))


def _flash_tol(dtype):
    return _tol(dtype, bf16_atol=1e-3)


def _assert_flash_close(got, want, dtype):
    """The card's flash kernel against its plain version: bf16 to rtol 2e-2
    with an atol of 2e-2 times each output row's RMS."""
    if dtype != "bfloat16":
        torch.testing.assert_close(got, want, **_tol(dtype))
        return
    g, w = got.float(), want.float()
    allow = 2e-2 * (w.abs() + w.pow(2).mean(-1, keepdim=True).sqrt())
    used = float(((g - w).abs() / allow).max())
    assert used <= 1.0, f"{used:.2f} of the allowance"


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    import jax.numpy as jnp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jdt), torch.as_tensor(a).to(tdt)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,H,KV,hd", FLASH_SHAPES)
def test_plain_flash_matches_pallas_kernel(S, H, KV, hd, causal, dtype):
    from repro.kernels.flash_attention.ops import flash_attention
    rng = np.random.default_rng(S + H + hd)
    qj, qt = _pair(rng.standard_normal((2, S, H, hd)).astype(np.float32),
                   dtype)
    kj, kt = _pair(rng.standard_normal((2, S, KV, hd)).astype(np.float32),
                   dtype)
    vj, vt = _pair(rng.standard_normal((2, S, KV, hd)).astype(np.float32),
                   dtype)
    want = flash_attention(qj, kj, vj, causal=causal)
    got = flash_ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_flash_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_oracle(causal):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ref import attention_ref as jref
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((3, 70, 32)).astype(np.float32)
               for _ in range(3))
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got = attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES)
def test_plain_expert_gemm_matches_pallas_kernel(e, c, d, f, dtype):
    from repro.kernels.expert_gemm.ops import expert_gemm
    rng = np.random.default_rng(e + c + d + f)
    xj, xt = _pair(rng.standard_normal((e, c, d)).astype(np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((e, d, f)).astype(np.float32), dtype)
    want = expert_gemm(xj, wj)
    got = gemm_ops.expert_gemm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (e, c, f)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_expert_gemm_takes_groups_of_experts():
    """N = G·E matrices: matrix n multiplies by expert n mod E."""
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.standard_normal((6, 5, 7)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((3, 7, 4)).astype(np.float32))
    y = gemm_ops.expert_gemm(x, w)
    for n in range(6):
        torch.testing.assert_close(y[n], x[n] @ w[n % 3], rtol=1e-5,
                                   atol=1e-6)


def test_lm_kernels_cpu_path_launches_no_kernel():
    flash_ops.reset_launch_counts()
    gemm_ops.reset_launch_counts()
    q = torch.ones((1, 4, 2, 8))
    flash_ops.flash_attention(q, q[:, :, :1].contiguous(),
                              q[:, :, :1].contiguous())
    gemm_ops.expert_gemm(torch.ones((2, 3, 4)), torch.ones((1, 4, 5)))
    assert flash_ops.LAUNCHES == {"flash_attention_fwd": 0}
    assert gemm_ops.LAUNCHES == {"expert_gemm": 0}


@pytest.mark.parametrize("bad", ["dtype", "mixed", "kv_heads", "head_dim",
                                 "noncontiguous"])
def test_flash_wrapper_rejects_malformed_inputs(bad):
    q = torch.ones((1, 4, 4, 8))
    k = v = torch.ones((1, 4, 2, 8))
    if bad == "dtype":
        q, k, v = (t.to(torch.float64) for t in (q, k, v))
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "kv_heads":
        k = v = torch.ones((1, 4, 3, 8))
    elif bad == "head_dim":
        k = v = torch.ones((1, 4, 2, 16))
    else:
        q = torch.ones((1, 4, 8, 4)).transpose(2, 3)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "depth", "groups",
                                 "noncontiguous"])
def test_expert_gemm_wrapper_rejects_malformed_inputs(bad):
    x, w = torch.ones((4, 3, 8)), torch.ones((2, 8, 5))
    if bad == "dtype":
        x, w = x.to(torch.float16), w.to(torch.float16)
    elif bad == "mixed":
        w = w.to(torch.bfloat16)
    elif bad == "depth":
        w = torch.ones((2, 7, 5))
    elif bad == "groups":
        w = torch.ones((3, 8, 5))
    else:
        x = torch.ones((4, 8, 3)).transpose(1, 2)
    with pytest.raises(ValueError):
        gemm_ops.expert_gemm(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,hd,causal,q_offset", [
    (300, 8, 2, 128, True, 0),    # GQA, S ragged against the 64-row tiles
    (200, 8, 1, 32, True, 0),     # MQA, small hd
    (130, 4, 4, 64, False, 0),    # MHA, not causal
    (70, 4, 2, 40, True, 0),      # hd not a multiple of 8 (scalar loads)
    (16, 4, 2, 16, True, 48),     # queries after a 48-key prefix
])
def test_cuda_flash_matches_plain_version(cuda_device, S, H, KV, hd, causal,
                                          q_offset, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(S + hd)
    Sk = S + q_offset
    q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=cuda_device).to(tdt)
               for shape in ((2, S, H, hd), (2, Sk, KV, hd), (2, Sk, KV, hd)))
    before = flash_ops.LAUNCHES["flash_attention_fwd"]
    o = flash_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert flash_ops.LAUNCHES["flash_attention_fwd"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    _assert_flash_close(o, want, dtype)
    assert torch.equal(o, flash_ops.flash_attention(q, k, v, causal=causal,
                                                    q_offset=q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,e,c,d,f", [
    (4, 4, 96, 200, 72),
    (8, 4, 130, 256, 136),     # two groups of four experts
    (2, 1, 37, 45, 51),        # d and f not multiples of 8 (scalar loads)
    (8, 8, 8, 64, 48),         # decode-like: C = 8
])
def test_cuda_expert_gemm_matches_plain_version(cuda_device, n, e, c, d, f,
                                                dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(n + c + d + f)
    x = torch.as_tensor(rng.standard_normal((n, c, d)).astype(np.float32),
                        device=cuda_device).to(tdt)
    w = torch.as_tensor(rng.standard_normal((e, d, f)).astype(np.float32),
                        device=cuda_device).to(tdt)
    before = gemm_ops.LAUNCHES["expert_gemm"]
    y = gemm_ops.expert_gemm(x, w)
    assert gemm_ops.LAUNCHES["expert_gemm"] == before + 1
    torch.testing.assert_close(y.float(), expert_gemm_ref(x, w).float(),
                               **_tol(dtype))
    assert torch.equal(y, gemm_ops.expert_gemm(x, w))
