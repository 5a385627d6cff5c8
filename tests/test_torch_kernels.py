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
the same bits. Which kernel variant takes a call is decided by shape in
pure Python (``flash_variant``, ``flash_bwd_variant``, ``ell_variant``,
``gemm_variant``), pinned here on the CPU. The JAX kernels are imported inside the tests that use
them, so that ``pytest --noconftest -m cuda`` runs this file on a machine
with a card and no JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import expert_gemm as gemm_ops
from repro_torch.kernels import flash_attention as flash_ops
from repro_torch.kernels.expert_gemm import ExpertGemm
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


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_kernel_source_exports_its_entry_point(name):
    """Each registered source defines the C function build.py binds, with
    as many parameters as its ctypes argtypes (a missing one would shift
    the stream pointer into an int)."""
    import re
    rel, fn, argtypes = build.KERNELS[name]
    src = (Path(build.__file__).parent / rel).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert m, f"{rel} defines no extern \"C\" int {fn}(...)"
    assert len(m.group(1).split(",")) == len(argtypes)


def test_build_target_hashes_included_headers(tmp_path, monkeypatch):
    """A library's name changes with any header its source includes, so an
    edited header is rebuilt, not loaded stale."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint x;\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setitem(build.KERNELS, "k", (str(tmp_path / "k.cu"), "k", []))
    assert build._sources(tmp_path / "k.cu") == [tmp_path / "k.cu",
                                                 tmp_path / "h.cuh"]
    before = build._target("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build._target("k") != before
    shared = build.INCLUDE_DIR / "hopper.cuh"
    for name in ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma",
                 "expert_gemm_wgmma"):
        assert shared in build._sources(build._source(name))


def test_first_kernel_calls_build_once_under_the_build_lock(monkeypatch):
    """Concurrent first calls (the engine's executor pool) are serialised
    by ``build._BUILD_LOCK``: a stubbed build that sleeps runs once, never
    two at a time, and both callers get the same entry point."""
    import threading
    import time

    assert isinstance(build._BUILD_LOCK, type(threading.Lock()))
    active, peak, calls = [0], [0], []

    def slow_build(names=None):
        active[0] += 1
        peak[0] = max(peak[0], active[0])
        calls.append(names)
        time.sleep(0.05)
        active[0] -= 1
        return {}

    class _Lib:
        def __init__(self, path):
            self.ell_spmm_f32 = lambda *a: 0

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", _Lib)
    barrier = threading.Barrier(4)
    got = []

    def first_call():
        barrier.wait()
        got.append(build.kernel("ell_spmm"))

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [None] and peak[0] == 1
    assert len(got) == 4 and all(fn is got[0] for fn in got)
    assert list(build._LIBS) == ["ell_spmm"]


def test_launch_counts_stay_exact_across_threads(monkeypatch):
    """The executor pool's workers bump ``LAUNCHES`` concurrently: under a
    short switch interval, 8 threads x 5,000 counts lose none."""
    import sys
    import threading

    monkeypatch.setitem(ops.LAUNCHES, "ell_spmm", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ops._count("ell_spmm") for _ in range(5000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ops.LAUNCHES["ell_spmm"] == 8 * 5000


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


@pytest.mark.parametrize("d,ptr,want", [
    (1, 0, "small"),
    (4, 256, "small"),          # the label RWR
    (4, 4, "small"),            # alignment does not matter below 32
    (20, 0, "small"),           # one BFS sweep of 20 seeds
    (31, 0, "small"),
    (32, 0, "wide_vec4"),
    (32, 4, "wide_scalar"),     # x not 16-byte aligned
    (36, 16, "wide_vec4"),      # 9 float4 groups
    (38, 0, "wide_scalar"),     # d % 4 != 0
    (40, 0, "wide_vec4"),       # BFS, n_sweep 2
    (160, 0, "wide_vec4"),      # BFS, n_sweep 8
    (320, 512, "wide_vec4"),    # the expansion RWR; BFS, n_sweep 16
    (320, 8, "wide_scalar"),    # x not 16-byte aligned
    (520, 0, "wide_vec4"),      # more than 512 columns: two walks
])
def test_spmm_variant_by_shape(d, ptr, want):
    """The variant rule that both ELL wrappers (SpMM and reach) follow."""
    assert ops.ell_variant(d, ptr) == want


def _misaligned(a, device):
    """``a`` as a contiguous float32 tensor whose data sits 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(a.size + 1, dtype=torch.float32, device=device)
    out = buf[1:].view(a.shape)
    out.copy_(torch.as_tensor(a))
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d,aligned", [(4, False), (32, True), (36, True),
                                       (38, True), (320, True),
                                       (320, False), (520, True)])
def test_cuda_spmm_variants_match_plain_version(ell_data, cuda_device, d,
                                                aligned):
    cols, vals, mask, row_ids, _ = (torch.as_tensor(a, device=cuda_device)
                                    for a in ell_data)
    n = 300
    xa = np.random.default_rng(d).random((n, d)).astype(np.float32)
    x = (torch.as_tensor(xa, device=cuda_device) if aligned
         else _misaligned(xa, cuda_device))
    want = ("small" if d < 32 else "wide_vec4" if aligned and d % 4 == 0
            else "wide_scalar")
    assert ops.ell_variant(d, x.data_ptr()) == want
    before = ops.LAUNCHES["ell_spmm"]
    y = ops.ell_spmm(cols, vals, mask, row_ids, x, n)
    assert ops.LAUNCHES["ell_spmm"] == before + 1
    torch.testing.assert_close(y, ell_spmm_ref(cols, vals, mask, row_ids,
                                               x, n), rtol=1e-5, atol=0)
    assert torch.equal(y, ops.ell_spmm(cols, vals, mask, row_ids, x, n))


# -- flash attention and the expert GEMM --------------------------------------

FLASH_SHAPES = [(128, 4, 4, 64),   # MHA
                (256, 4, 2, 64),   # GQA
                (200, 8, 1, 32)]   # MQA, ragged S, small hd
# (G, E, C, d, f): x is (G·E, C, d) and matrix n takes expert n mod E
GEMM_SHAPES = [pytest.param(1, 4, 96, 200, 72, id="4-96-200-72"),  # unaligned
               pytest.param(1, 8, 128, 128, 128, id="8-128-128-128"),
               pytest.param(1, 2, 320, 64, 768, id="2-320-64-768"),  # qwen3-ish
               pytest.param(1, 1, 8, 8, 8, id="1-8-8-8"),
               # decode-like: two groups of experts, C = 8
               pytest.param(2, 4, 8, 64, 48, id="g2-4-8-64-48")]


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
@pytest.mark.parametrize("g,e,c,d,f", GEMM_SHAPES)
def test_plain_expert_gemm_matches_pallas_kernel(g, e, c, d, f, dtype):
    """The Pallas kernel takes one group (E, C, d); the port takes all G
    groups at once, so the reference runs once per group."""
    import jax.numpy as jnp

    from repro.kernels.expert_gemm.ops import expert_gemm
    rng = np.random.default_rng(e + c + d + f + 100 * (g - 1))
    xj, xt = _pair(rng.standard_normal((g * e, c, d)).astype(np.float32),
                   dtype)
    wj, wt = _pair(rng.standard_normal((e, d, f)).astype(np.float32), dtype)
    want = jnp.concatenate([expert_gemm(xj[i * e:(i + 1) * e], wj)
                            for i in range(g)])
    got = gemm_ops.expert_gemm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (g * e, c, f)
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
    kv = q[:, :, :1].contiguous()
    o, lse = flash_ops.flash_attention(q, kv, kv, return_lse=True)
    flash_ops.flash_attention_bwd(q, kv, kv, o, torch.ones_like(o), lse)
    gemm_ops.expert_gemm(torch.ones((2, 3, 4)), torch.ones((1, 4, 5)))
    assert flash_ops.LAUNCHES == {"flash_attention_fwd": 0,
                                  "flash_attention_fwd_wgmma": 0,
                                  "flash_attention_bwd": 0,
                                  "flash_attention_bwd_wgmma": 0}
    gemm_ops.expert_gemm(torch.ones((2, 8, 64), dtype=torch.bfloat16),
                         torch.ones((1, 64, 72), dtype=torch.bfloat16))
    assert gemm_ops.LAUNCHES == {"expert_gemm": 0, "expert_gemm_wgmma": 0,
                                 "expert_gemm_skinny": 0}


@pytest.mark.parametrize("dtype,hd,sq,sk,ptrs,want", [
    ("bfloat16", 128, 4096, 4096, (0, 512, 1024, 4096), "wgmma"),  # prefill
    ("bfloat16", 128, 4111, 4111, (16, 32, 48, 64), "wgmma"),      # ragged
    ("bfloat16", 64, 1, 1, (0, 0, 0, 0), "wgmma"),
    ("bfloat16", 40, 4096, 4096, (0, 0, 0, 0), "first"),   # hd not 64/128
    ("bfloat16", 32, 200, 200, (0, 0, 0, 0), "first"),
    ("bfloat16", 16, 16, 64, (0, 0, 0, 0), "first"),
    ("float32", 128, 300, 300, (0, 0, 0, 0), "first"),     # f32
    ("float32", 64, 128, 128, (0, 0, 0, 0), "first"),
    ("bfloat16", 128, 300, 300, (0, 8, 0, 0), "first"),    # k misaligned
    ("bfloat16", 64, 300, 300, (0, 0, 0, 2), "first"),     # o misaligned
    ("bfloat16", 128, 300, 0, (0, 0, 0, 0), "first"),      # no keys
])
def test_flash_variant_by_shape(dtype, hd, sq, sk, ptrs, want):
    name = flash_ops.flash_variant(getattr(torch, dtype), hd, sq, sk, ptrs)
    assert name == {"wgmma": "flash_attention_fwd_wgmma",
                    "first": "flash_attention_fwd"}[want]


ALIGNED8 = (0, 512, 1024, 4096, 8192, 16384, 20480, 24576)


@pytest.mark.parametrize("dtype,hd,sq,sk,ptrs,want", [
    ("bfloat16", 128, 4096, 4096, ALIGNED8, "wgmma"),        # train shape
    ("bfloat16", 128, 4111, 4111, (16,) * 8, "wgmma"),       # ragged
    ("bfloat16", 64, 200, 200, (0,) * 8, "wgmma"),
    ("bfloat16", 128, 1, 64, (0,) * 8, "wgmma"),             # one query
    ("bfloat16", 40, 4096, 4096, (0,) * 8, "first"),         # hd not 64/128
    ("bfloat16", 32, 200, 200, (0,) * 8, "first"),
    ("bfloat16", 16, 33, 33, (0,) * 8, "first"),
    ("float32", 128, 4096, 4096, (0,) * 8, "first"),         # f32
    ("float32", 16, 33, 33, (0,) * 8, "first"),
    ("bfloat16", 128, 300, 300, (0, 0, 0, 0, 2, 0, 0, 0), "first"),  # dO
    ("bfloat16", 64, 300, 300, (0, 0, 0, 0, 0, 0, 0, 2), "first"),   # dv
    ("bfloat16", 128, 300, 0, (0,) * 8, "first"),            # no keys
])
def test_flash_bwd_variant_by_shape(dtype, hd, sq, sk, ptrs, want):
    """The backward's pointers are q, k, v, O, dO, dq, dk, dv."""
    name = flash_ops.flash_bwd_variant(getattr(torch, dtype), hd, sq, sk,
                                       ptrs)
    assert name == {"wgmma": "flash_attention_bwd_wgmma",
                    "first": "flash_attention_bwd"}[want]


@pytest.mark.parametrize("dtype,C,d,f,ptrs,want", [
    ("bfloat16", 328, 2048, 768, (0, 512, 1024), "tiles"),   # prefill gate/up
    ("bfloat16", 328, 768, 2048, (0, 16, 32), "tiles"),      # prefill down
    ("bfloat16", 8, 2048, 768, (0, 0, 0), "skinny"),         # decode
    ("bfloat16", 8, 768, 2048, (0, 0, 0), "skinny"),         # decode down
    ("bfloat16", 1, 64, 72, (0, 0, 0), "skinny"),
    ("bfloat16", 64, 64, 72, (0, 0, 0), "skinny"),           # the threshold
    ("bfloat16", 65, 64, 72, (0, 0, 0), "tiles"),
    ("bfloat16", 130, 200, 192, (0, 0, 0), "tiles"),
    ("bfloat16", 328, 2044, 768, (0, 0, 0), "first"),        # d % 8 != 0
    ("bfloat16", 8, 2048, 764, (0, 0, 0), "first"),          # f % 8 != 0
    ("bfloat16", 328, 0, 768, (0, 0, 0), "first"),           # no depth
    ("bfloat16", 328, 2048, 768, (2, 0, 0), "first"),        # x misaligned
    ("bfloat16", 8, 2048, 768, (0, 8, 0), "first"),          # w misaligned
    ("bfloat16", 328, 2048, 768, (0, 0, 4), "first"),        # y misaligned
    ("float32", 328, 2048, 768, (0, 0, 0), "first"),         # f32
    ("float32", 8, 2048, 768, (0, 0, 0), "first"),
])
def test_gemm_variant_by_shape(dtype, C, d, f, ptrs, want):
    assert gemm_ops.gemm_variant(getattr(torch, dtype), C, d, f, ptrs) == {
        "tiles": "expert_gemm_wgmma", "skinny": "expert_gemm_skinny",
        "first": "expert_gemm"}[want]


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
    o_ptr = torch.empty_like(q).data_ptr()  # any fresh allocation: aligned
    name = flash_ops.flash_variant(tdt, hd, S, Sk, (q.data_ptr(),
                                                    k.data_ptr(),
                                                    v.data_ptr(), o_ptr))
    assert name == ("flash_attention_fwd_wgmma"
                    if dtype == "bfloat16" and hd in (64, 128)
                    else "flash_attention_fwd")
    before = dict(flash_ops.LAUNCHES)
    o = flash_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert flash_ops.LAUNCHES[name] == before[name] + 1
    assert sum(flash_ops.LAUNCHES.values()) == sum(before.values()) + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    _assert_flash_close(o, want, dtype)
    assert torch.equal(o, flash_ops.flash_attention(q, k, v, causal=causal,
                                                    q_offset=q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 48)])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [128, 300, 4111])
def test_cuda_wgmma_flash_matches_plain_version(cuda_device, S, hd, G,
                                                causal, q_offset):
    """The TMA + wgmma kernel (bf16, hd 64 or 128): one 128-row tile, a
    ragged S, and the prefill's length plus a ragged tail; MHA and GQA;
    queries after a 48-key prefix."""
    KV = 2
    rng = np.random.default_rng(S + hd + G)
    Sk = S + q_offset
    q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=cuda_device).to(torch.bfloat16)
               for shape in ((2, S, KV * G, hd), (2, Sk, KV, hd),
                             (2, Sk, KV, hd)))
    before = flash_ops.LAUNCHES["flash_attention_fwd_wgmma"]
    o = flash_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert flash_ops.LAUNCHES["flash_attention_fwd_wgmma"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    _assert_flash_close(o, want, "bfloat16")
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
    y_ptr = torch.empty((n, c, f), dtype=tdt,
                        device=cuda_device).data_ptr()  # fresh: aligned
    name = gemm_ops.gemm_variant(tdt, c, d, f, (x.data_ptr(), w.data_ptr(),
                                                y_ptr))
    before = dict(gemm_ops.LAUNCHES)
    y = gemm_ops.expert_gemm(x, w)
    assert gemm_ops.LAUNCHES[name] == before[name] + 1
    assert sum(gemm_ops.LAUNCHES.values()) == sum(before.values()) + 1
    torch.testing.assert_close(y.float(), expert_gemm_ref(x, w).float(),
                               **_tol(dtype))
    assert torch.equal(y, gemm_ops.expert_gemm(x, w))


def _misaligned_bf16(a, device):
    """``a`` as a contiguous bf16 tensor whose data sits 2 bytes past a
    16-byte boundary."""
    buf = torch.empty(a.size + 1, dtype=torch.bfloat16, device=device)
    out = buf[1:].view(a.shape)
    out.copy_(torch.as_tensor(a))
    assert out.is_contiguous() and out.data_ptr() % 16 == 2
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(64, 72), (200, 192), (2048, 768)])
@pytest.mark.parametrize("C", [1, 8, 12, 24, 37, 64, 130, 328])
def test_cuda_gemm_variants_match_plain_version(cuda_device, C, d, f):
    """The TMA + wgmma GEMM, skinny (C ≤ 64, at each of its widths N = 8,
    16, 32 and 64) and tiles: two groups of four experts, ragged C, d and
    f against the 64-deep k-tiles and the 128 × 192 output tiles; two
    launches give the same bits."""
    G, E = 2, 4
    rng = np.random.default_rng(C + d + f)
    x = torch.as_tensor(rng.standard_normal((G * E, C, d)).astype(
        np.float32), device=cuda_device).to(torch.bfloat16)
    w = torch.as_tensor((rng.standard_normal((E, d, f)) / np.sqrt(d))
                        .astype(np.float32),
                        device=cuda_device).to(torch.bfloat16)
    name = "expert_gemm_skinny" if C <= 64 else "expert_gemm_wgmma"
    before = dict(gemm_ops.LAUNCHES)
    y = gemm_ops.expert_gemm(x, w)
    assert gemm_ops.LAUNCHES[name] == before[name] + 1
    assert sum(gemm_ops.LAUNCHES.values()) == sum(before.values()) + 1
    torch.testing.assert_close(y.float(), expert_gemm_ref(x, w).float(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(y, gemm_ops.expert_gemm(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(64, 72), (2048, 768)])
@pytest.mark.parametrize("C", [8, 328])
@pytest.mark.parametrize("which", ["x", "w"])
def test_cuda_misaligned_gemm_takes_first_kernel(cuda_device, which, C, d,
                                                 f):
    """bf16 that TMA cannot address goes to the first kernel, also at the
    served widths (d 2048, f 768)."""
    E = 4
    rng = np.random.default_rng(C + d)
    xa = rng.standard_normal((E, C, d)).astype(np.float32)
    wa = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    x = (_misaligned_bf16(xa, cuda_device) if which == "x" else
         torch.as_tensor(xa, device=cuda_device).to(torch.bfloat16))
    w = (_misaligned_bf16(wa, cuda_device) if which == "w" else
         torch.as_tensor(wa, device=cuda_device).to(torch.bfloat16))
    before = dict(gemm_ops.LAUNCHES)
    y = gemm_ops.expert_gemm(x, w)
    assert gemm_ops.LAUNCHES["expert_gemm"] == before["expert_gemm"] + 1
    assert sum(gemm_ops.LAUNCHES.values()) == sum(before.values()) + 1
    torch.testing.assert_close(y.float(), expert_gemm_ref(x, w).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "zeros", "ones"])
@pytest.mark.parametrize("d,aligned", [(32, True), (36, True), (38, True),
                                       (160, True), (320, True),
                                       (320, False), (520, True)])
def test_cuda_reach_variants_match_plain_version(ell_data, cuda_device, d,
                                                 aligned, fill):
    """Every reach variant, bitwise against the plain version, for x of
    random indicators, all zeros (nothing reached) and all ones (every
    vertex with a live in-arc reached)."""
    cols, _, mask, row_ids, _ = (torch.as_tensor(a, device=cuda_device)
                                 for a in ell_data)
    n = 300
    xa = {"random": (np.random.default_rng(d).random((n, d)) < 0.2),
          "zeros": np.zeros((n, d)),
          "ones": np.ones((n, d))}[fill].astype(np.float32)
    x = (torch.as_tensor(xa, device=cuda_device) if aligned
         else _misaligned(xa, cuda_device))
    want = "wide_vec4" if aligned and d % 4 == 0 else "wide_scalar"
    assert ops.ell_variant(d, x.data_ptr()) == want
    before = ops.LAUNCHES["ell_reach"]
    y = ops.ell_reach(cols, mask, row_ids, x, n)
    assert ops.LAUNCHES["ell_reach"] == before + 1
    assert torch.equal(y, ell_reach_ref(cols, mask, row_ids, x, n))
    assert torch.equal(y, ops.ell_reach(cols, mask, row_ids, x, n))


# -- the ELL kernels under the graph axis of the device mesh ------------------

def _coo(n, k, seed):
    """A random arc list with one receiver heavy enough for spill rows."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, 6 * n)
    r = rng.integers(0, n, 6 * n)
    r[:3 * k] = 5
    return s, r


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 20, 40, 160])
def test_cuda_kernels_on_a_row_block(cuda_device, d):
    """Both kernels on each shard's row block (n = n_loc < n_x, local row
    ids, global column ids) against their plain versions, and the blocks'
    slices concatenated bitwise equal to the unsharded mirror's output."""
    from repro_torch.sparse.ell import build_ell, build_ell_sharded
    n, g, k = 256, 4, 8
    s, r = _coo(n, k, d)
    blocks = build_ell_sharded(r, s, n, g, k=k, devices=[cuda_device] * g)
    full = build_ell(r, s, n, k=k, r_cap=n + len(s), device=cuda_device)
    gen = np.random.default_rng(d)
    x = torch.as_tensor(gen.random((n, d)).astype(np.float32),
                        device=cuda_device)
    xb = torch.as_tensor((gen.random((n, d)) < 0.2).astype(np.float32),
                         device=cuda_device)
    ys, rs = [], []
    for b in blocks.blocks:
        assert b.n == n // g and b.n < x.shape[0]
        y = ops.ell_spmm(b.cols, b.vals, b.mask, b.row_ids, x, b.n,
                         index=b.row_index())
        reach = ops.ell_reach(b.cols, b.mask, b.row_ids, xb, b.n,
                              index=b.row_index())
        assert y.shape == reach.shape == (b.n, d)
        torch.testing.assert_close(
            y, ell_spmm_ref(b.cols, b.vals, b.mask, b.row_ids, x, b.n),
            rtol=1e-5, atol=0)
        assert torch.equal(reach, ell_reach_ref(b.cols, b.mask, b.row_ids,
                                                xb, b.n))
        ys.append(y)
        rs.append(reach)
    assert torch.equal(torch.cat(ys), ops.ell_spmm(
        full.cols, full.vals, full.mask, full.row_ids, x, n))
    assert torch.equal(torch.cat(rs), ops.ell_reach(
        full.cols, full.mask, full.row_ids, xb, n))


@pytest.mark.cuda
@pytest.mark.parametrize("wide,aligned", [(32, True), (40, True),
                                          (320, True), (320, False)])
@pytest.mark.parametrize("d", [1, 4, 20, 31])
def test_cuda_spmm_small_variant_sums_like_the_wide_ones(
        ell_data, cuda_device, d, wide, aligned):
    """A column's bits do not depend on the block's width: the small
    variant (d < 32) gives the first d columns of a wide call exactly, so
    a sweep block split over the query axis keeps the replicated bits."""
    cols, vals, mask, row_ids, _ = (torch.as_tensor(a, device=cuda_device)
                                    for a in ell_data)
    n = 300
    xa = np.random.default_rng(wide).random((n, wide)).astype(np.float32)
    x = (torch.as_tensor(xa, device=cuda_device) if aligned
         else _misaligned(xa, cuda_device))
    narrow = torch.as_tensor(xa[:, :d].copy(), device=cuda_device)
    assert ops.ell_variant(d, narrow.data_ptr()) == "small"
    y_wide = ops.ell_spmm(cols, vals, mask, row_ids, x, n)
    y_small = ops.ell_spmm(cols, vals, mask, row_ids, narrow, n)
    assert torch.equal(y_small, y_wide[:, :d])


@pytest.mark.cuda
def test_cuda_kernels_launch_on_a_card_that_is_not_current(ell_data):
    """Tensors on the second card while the first is current: each wrapper
    launches under a guard for its tensors' card, and the bits equal the
    first card's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    n, d = 300, 40
    xa = np.random.default_rng(0).random((n, d)).astype(np.float32)
    out = {}
    with torch.cuda.device(0):
        for dev in ("cuda:0", "cuda:1"):
            cols, vals, mask, row_ids, _ = (torch.as_tensor(a, device=dev)
                                            for a in ell_data)
            x = torch.as_tensor(xa, device=dev)
            out[dev] = (ops.ell_spmm(cols, vals, mask, row_ids, x, n),
                        ops.ell_reach(cols, mask, row_ids, (x < 0.2).float(),
                                      n))
            torch.cuda.synchronize(dev)
            assert out[dev][0].device == torch.device(dev)
    assert all(torch.equal(a.cpu(), b.cpu())
               for a, b in zip(out["cuda:0"], out["cuda:1"]))


@pytest.mark.cuda
@pytest.mark.parametrize("partitioned", [False, True])
def test_cuda_sharded_label_rwr_equals_replicated(cuda_device, partitioned):
    """The label table and a 40-column expansion block over a graph axis
    of the card named four times, bitwise equal to the replicated sweeps
    (fixed and residual-adaptive, with equal sweep and skip counts)."""
    from repro_torch.core.graph import EllCache, new_graph
    from repro_torch.core.rwr import label_rwr, restart_onehot, rwr_adaptive
    from repro_torch.engine.sharding import ShardedSweep
    n, k = 256, 8
    s, r = _coo(n, k, 11)
    labels = np.random.default_rng(11).integers(0, 4, n).astype(np.int32)
    g = new_graph(n, 4096, labels=labels, senders=s, receivers=r,
                  device=cuda_device)
    rep = EllCache(n, 4096, k, device=cuda_device)
    mesh = EllCache(n, 4096, k, n_shards=4, partitioned=partitioned,
                    devices=[cuda_device] * 4)
    rep.rebuild(g)
    mesh.rebuild(g)
    sweeps = ShardedSweep([cuda_device] * 4)
    want = label_rwr(g, 4, iters=10, ell=rep.ell)
    got, n_sw, _ = sweeps.label_table(g, 4, 10, 0.15, None, mesh.ell)
    assert n_sw == 10 and torch.equal(got, want)
    e = restart_onehot(torch.arange(40, device=cuda_device) * 6, n)
    want = rwr_adaptive(g, e, max_iters=30, tol=1e-5, ell=rep.ell)
    got = sweeps.run_rwr(g, e, 30, tol=1e-5, ell=mesh.ell)
    assert got[1:] == want[1:] and torch.equal(got[0], want[0])


# -- the LM kernels' backward (training) ----------------------------------------

def _flash_inputs(S, Sk, H, KV, hd, dtype, device, seed):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=device).to(tdt)
        for shape in ((2, S, H, hd), (2, Sk, KV, hd), (2, Sk, KV, hd),
                      (2, S, H, hd)))


def _grad_allowance_used(got, want, dtype):
    """The largest share of its allowance any element of ``got`` uses: 2e-2
    (bf16: the kernel rounds P and dS before their products) or 1e-4 (f32)
    of the element plus its row's RMS, plus 1e-4 of the tensor's RMS: a
    row whose gradient cancels to zero (causal query row 0 sees one key,
    so dS = dO·v − D = 0 and its dq is 0) keeps the f32 rounding noise of
    that difference, whose scale is dO·v's, not the row's."""
    share = 2e-2 if dtype == "bfloat16" else 1e-4
    g, w = got.float(), want.float()
    allow = (share * (w.abs() + w.pow(2).mean(-1, keepdim=True).sqrt())
             + 1e-4 * w.pow(2).mean().sqrt())
    return float(((g - w).abs() / allow).max())


FLASH_BWD_CASES = [
    # S, H, KV, hd, causal, q_offset
    (300, 8, 2, 128, True, 0),    # GQA, S ragged against the tiles
    (200, 8, 1, 64, True, 0),     # MQA
    (130, 4, 4, 64, False, 0),    # MHA, not causal
    (70, 4, 2, 40, True, 0),      # hd not a multiple of 8 (scalar loads)
    (16, 4, 2, 16, True, 48),     # queries after a 48-key prefix
    (33, 4, 2, 16, True, 0),      # the SMOKE model's head dim
    (257, 16, 2, 128, True, 0),   # G = 8, S ragged against the tiles
    (100, 8, 2, 128, True, 48),   # hd 128 after a 48-key prefix
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,hd,causal,q_offset", FLASH_BWD_CASES)
def test_cuda_flash_lse_leaves_o_unchanged(cuda_device, S, H, KV, hd, causal,
                                           q_offset, dtype):
    """Asking either forward kernel for the log-sum-exp changes no bit of O,
    and the log-sum-exp is each row's logsumexp of its scaled scores."""
    q, k, v, _ = _flash_inputs(S, S + q_offset, H, KV, hd, dtype,
                               cuda_device, S + hd)
    o = flash_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    o2, lse = flash_ops.flash_attention(q, k, v, causal=causal,
                                        q_offset=q_offset, return_lse=True)
    assert torch.equal(o, o2)
    _, want = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                  return_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,hd,causal,q_offset", FLASH_BWD_CASES)
def test_cuda_flash_bwd_matches_plain_version(cuda_device, S, H, KV, hd,
                                              causal, q_offset, dtype):
    """The backward kernel that ``flash_bwd_variant`` picks (the TMA +
    wgmma one for bf16 at hd 64 and 128, ``flash_attention_bwd.cu`` for the
    rest) against ``flash_attention_bwd_ref`` on the same q, k, v, O, dO and
    log-sum-exp: dq, dk and dv within ``_grad_allowance_used``; one launch
    of its entry point; two launches give the same bits."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    q, k, v, do = _flash_inputs(S, S + q_offset, H, KV, hd, dtype,
                                cuda_device, S + hd + 1)
    o, lse = flash_ops.flash_attention(q, k, v, causal=causal,
                                       q_offset=q_offset, return_lse=True)
    name = flash_ops.flash_bwd_variant(
        q.dtype, hd, S, S + q_offset,
        [t.data_ptr() for t in (q, k, v, o, do)]
        + [torch.empty_like(t).data_ptr() for t in (q, k, v)])
    assert name == ("flash_attention_bwd_wgmma"
                    if dtype == "bfloat16" and hd in (64, 128)
                    else "flash_attention_bwd")
    before = dict(flash_ops.LAUNCHES)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                        q_offset=q_offset)
    assert flash_ops.LAUNCHES[name] == before[name] + 1
    assert sum(flash_ops.LAUNCHES.values()) == sum(before.values()) + 1
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                   q_offset=q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        used = _grad_allowance_used(g, w, dtype)
        assert used <= 1.0, f"{name}: {used:.2f} of the allowance"
    again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                          q_offset=q_offset)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_misaligned_flash_bwd_takes_first_kernel(cuda_device, hd):
    """bf16 at hd 64 or 128 with dO 2 bytes off a 16-byte boundary (TMA
    cannot address it): the first backward kernel takes the call, within
    the same allowance of the plain version."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    q, k, v, do = _flash_inputs(130, 130, 8, 2, hd, "bfloat16", cuda_device,
                                hd + 7)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device=cuda_device)
    do_off = flat[1:].view(do.shape)
    do_off.copy_(do)
    assert do_off.data_ptr() % 16 == 2
    before = dict(flash_ops.LAUNCHES)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do_off, lse)
    assert flash_ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert sum(flash_ops.LAUNCHES.values()) == sum(before.values()) + 1
    want = flash_attention_bwd_ref(q, k, v, o, do, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        used = _grad_allowance_used(g, w, "bfloat16")
        assert used <= 1.0, f"{name}: {used:.2f} of the allowance"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_autograd_matches_cpu(cuda_device, dtype):
    """``FlashAttention`` on the card gives the forward kernel's O and the
    backward kernel's gradients bit for bit, and agrees with the same
    function on the CPU (both plain versions): within twice the backward
    test's share in bf16, where the card's forward rounds P before P·V and
    the backward's D = rowsum(dO·O) inherits that difference."""
    q, k, v, do = _flash_inputs(96, 96, 4, 2, 64, dtype, cuda_device, 5)
    out = {}
    for dev in ("cuda", "cpu"):
        ins = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = flash_ops.FlashAttention.apply(*ins, True, 0)
        o.backward(do.to(dev))
        out[dev] = [o.detach()] + [t.grad for t in ins]
    o_k, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    assert torch.equal(out["cuda"][0], o_k)
    want = flash_ops.flash_attention_bwd(q, k, v, o_k, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][1:], want))
    scale = 2.0 if dtype == "bfloat16" else 1.0
    for g, w in zip(out["cuda"], out["cpu"]):
        assert _grad_allowance_used(g.cpu(), w, dtype) <= scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,E,C,d,f", [(4, 8, 88, 64, 72),
                                       (2, 4, 96, 200, 136),
                                       (1, 2, 37, 45, 51)])
def test_cuda_expert_gemm_backward_matches_plain_version(cuda_device, G, E,
                                                         C, d, f, dtype):
    """``ExpertGemm``'s dX and dW on the card (the kernels on transposed
    operands) against the same backward on the CPU (the plain version):
    bf16 to rtol / atol 2e-2 of outputs scaled to O(1), f32 to 1e-4."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(G + C + d)
    x = rng.standard_normal((G * E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    dy = (rng.standard_normal((G * E, C, f)) / np.sqrt(G * C)).astype(
        np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        xt = torch.as_tensor(x, device=dev).to(tdt).requires_grad_()
        wt = torch.as_tensor(w, device=dev).to(tdt).requires_grad_()
        before = dict(gemm_ops.LAUNCHES)
        ExpertGemm.apply(xt, wt).backward(torch.as_tensor(dy, device=dev)
                                          .to(tdt))
        out[dev] = (xt.grad, wt.grad, {n: gemm_ops.LAUNCHES[n] - before[n]
                                       for n in before})
    assert sum(out["cuda"][2].values()) == 3   # forward, dX, dW
    assert sum(out["cpu"][2].values()) == 0
    tol = _tol(dtype)
    for g, want in zip(out["cuda"][:2], out["cpu"][:2]):
        assert g.dtype == tdt
        torch.testing.assert_close(g.float().cpu(), want.float(), **tol)


# -- the other LM configs' shapes, and repeatable training ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd", [
    (9, 3, 64),      # smollm-135m: hd 64, G 3
    (32, 32, 128),   # deepseek-7b: MHA, G 1
    (48, 8, 128),    # dbrx-132b: G 6
])
def test_cuda_flash_at_the_lm_configs_head_shapes(cuda_device, H, KV, hd):
    """The TMA + wgmma forward and backward at the head layouts of the
    other LM configs (S 1,024 and a ragged 1,000): O within
    ``_assert_flash_close`` and dq, dk, dv within ``_grad_allowance_used``
    of the plain versions, one launch of each TMA kernel, two launches
    bitwise equal."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    for S in (1024, 1000):
        q, k, v, do = _flash_inputs(S, S, H, KV, hd, "bfloat16",
                                    cuda_device, S + H + hd)
        before = dict(flash_ops.LAUNCHES)
        o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse)
        assert {n: flash_ops.LAUNCHES[n] - before[n] for n in before} == {
            "flash_attention_fwd_wgmma": 1, "flash_attention_bwd_wgmma": 1,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0}
        _assert_flash_close(o, flash_attention_ref(q, k, v), "bfloat16")
        want = flash_attention_bwd_ref(q, k, v, o, do, lse)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            used = _grad_allowance_used(g, w, "bfloat16")
            assert used <= 1.0, f"S {S} {name}: {used:.2f} of the allowance"
        assert torch.equal(o, flash_ops.flash_attention(q, k, v))
        again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("phase,G,C,variant", [
    ("prefill", 2, 1288, "expert_gemm_wgmma"),   # 2 × 4,096 tokens, C 1,288
    ("decode", 1, 8, "expert_gemm_skinny"),      # 2 tokens, C 8
])
def test_cuda_expert_gemm_at_dbrx_shapes(cuda_device, phase, G, C, variant):
    """dbrx-132b's three expert products (d 6,144, f 10,752, 16 experts) at
    the served prefill and decode capacities, on the variant the shape
    picks, against the plain version (bf16 to rtol / atol 2e-2, outputs
    O(1)), two launches bitwise equal."""
    E, d, f = 16, 6144, 10752
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    s_in = (2.0 / (d + f)) ** 0.5

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * scale).to(torch.bfloat16)
    for din, dout in ((d, f), (d, f), (f, d)):     # gate, up, down
        x, w = randn(G * E, C, din), randn(E, din, dout, scale=s_in)
        before = dict(gemm_ops.LAUNCHES)
        y = gemm_ops.expert_gemm(x, w)
        assert {n: gemm_ops.LAUNCHES[n] - before[n] for n in before} == {
            n: int(n == variant) for n in before}
        torch.testing.assert_close(y.float(), expert_gemm_ref(x, w).float(),
                                   **_tol("bfloat16"))
        assert torch.equal(y, gemm_ops.expert_gemm(x, w))
        del x, w, y
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_moe_block_backward_repeats_bitwise(cuda_device):
    """Two backward passes of ``moe_block`` at top-8 and train-lm's shape
    (4 groups of 1,024 tokens, d 2,048, 128 experts of d_ff 768, capacity
    88; bf16 activations, f32 master weights) give the same bits for dx
    and every weight's gradient, the router's included: the dispatch
    gather's backward adds each token's 8 slots in a fixed order."""
    from repro_torch.config.base import MoEConfig
    from repro_torch.models.moe import init_moe_params, moe_block, route
    mcfg = MoEConfig(n_experts=128, top_k=8, d_ff_expert=768)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_moe_params(gen, mcfg, 2048, torch.float32)
    x = torch.randn((4096, 2048), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    dy = torch.randn((4096, 2048), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    assert route(x, params["router"], mcfg, 4).C == 88
    runs = []
    for _ in range(2):
        xi = x.detach().requires_grad_()
        p = {n: t.detach().requires_grad_() for n, t in params.items()}
        y, aux = moe_block(xi, p, mcfg, 4)
        torch.autograd.backward((y, aux), (dy, torch.ones_like(aux)))
        runs.append([xi.grad] + [p[n].grad for n in sorted(p)])
    for a, b in zip(*runs):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)
