#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (``nvidia-smi``) and the build of all five kernel sources
   under ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source,
   started together);
2. the ELL kernels against their plain PyTorch versions on random ELL data
   at the full mirror's shapes (R 393,216 rows, K 64, n 262,144,
   d ∈ {4, 320}, with shuffled spill rows, unallocated capacity rows and
   empty vertices): SpMM to max relative error ≤ 1e-5, reach bitwise;
   median kernel time from CUDA events, the plain version's time,
   ``torch.sparse.mm`` on the same matrix as a CSR tensor (a yardstick only
   — the port never calls it), the byte/flop bound of the work, and for
   the SpMM the gather floor (nnz · d · 4 bytes at the memory rate: every
   live entry's row of x read once, no reuse in L2) and a digest of its
   output;
3. the LM kernels against their plain versions at the serve-lm shapes of
   qwen3-moe-30b-a3b: flash attention at prefill (B 2, S 4,096, H 32, KV 4,
   hd 128) and at a ragged S 4,111 against dense f32 ``attention_ref``
   (both taken by the TMA + wgmma kernel), and the first flash kernel at
   hd 40, a shape only it takes; the expert GEMM at the three prefill products (gate, up, down of the
   (2, 128, 328, ·) dispatch buffer) and at decode (C 8) against an f32
   einsum; bf16 to rtol 2e-2, with atol 2e-2 for the expert GEMM (outputs
   of O(1)) and, for flash, 2e-2 times each output row's RMS in the plain
   version (late causal rows average thousands of values and are a few
   hundredths); two launches bitwise equal; times,
   bounds and the yardsticks ``scaled_dot_product_attention`` (causal,
   GQA) and ``torch.matmul`` on the same inputs;
4. a small-input check: the toy stream served on the card and on the CPU
   (plain versions) must give equal match deltas and stores;
5. LM agreement: qwen3-moe ``SMOKE`` (f32) with one set of weights served
   greedily on the card (kernels) and on the CPU (plain versions): equal
   tokens, logits within 1e-4;
6. serve-inc — ``MatchServer(FULL, query_zoo(16), ServingConfig(adaptive=
   False))`` on the ``transactions`` twin at full scale for 4 served steps,
   launch counters set to 0 before and read after; the inputs of the first
   label-RWR sweep, the first expansion sweep and the first BFS sweep are
   captured, the kernels held against their plain versions on them, and
   the SpMM timed on the two captured sweeps;
7. serve-batch — 2 steps of ``Engine(FULL, EngineConfig(mode="batch"))``
   on the same stream (full-graph label RWR and bank match), counters
   again set to 0 before and read after;
8. serve-lm — qwen3-moe-30b-a3b ``FULL`` at its published widths with the
   depth cut from 48 to 8 layers, seeded random weights, a 2 × 4,096-token
   prompt: prefill and 15 greedy decode steps through
   ``repro_torch.launch.serve.greedy_generate``, counters set to 0 before
   and read after (flash 8 launches, all of the TMA + wgmma kernel; expert
   GEMM 384); then, with the MoE
   at a capacity that drops no slot, the prompt is served again and a
   prefill over it plus the 15 generated tokens must give the last decode
   step's logits.

Then a ``{"kernels": [...]}`` JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line. ``--profile`` adds a device-time profile of one step of each
served path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # fp32 outside the tensor cores, data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores, data sheet
SPMM_RTOL = 1e-5
# bf16 kernels against their plain versions: rtol as tests/test_kernels.py,
# atol per kernel. The expert GEMM's outputs are O(1): atol 2e-2. A causal
# flash row i averages i + 1 values of N(0, 1) v, so its outputs shrink to
# |o| ~ 0.03 in the late rows, and the kernel rounds P to bf16 before P·V,
# an error that scales with the row, not with each element: its atol is
# LM_KERNEL_RTOL times the RMS of that output row in the plain version.
LM_KERNEL_RTOL = 2e-2
LM_GEMM_ATOL = 2e-2
LM_AGREE_TOL = 1e-4    # SMOKE f32 logits, card against CPU
LM_LAYERS = 8          # serve-lm depth (48 in the published config)
LM_BATCH, LM_PROMPT, LM_TOKENS = 2, 4096, 16
# serve-lm prefill-vs-decode logits: correlation floor and absolute bound.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): bf16 3.9e-2 and
# 0.99898; f32 3.8e-4 and 0.9999995, the bf16 cache's rounding alone.
LM_CONSIST_CORR = 0.99
LM_CONSIST_ATOL = 0.1
LM_CONSIST32_CORR = 0.9999
LM_CONSIST32_ATOL = 4e-3
REPS = 20          # timed launches per kernel measurement
SPIN_CYCLES = 2_000_000  # card clock cycles spun before each timed run
INC_STEPS = 4      # serve-inc steps
BATCH_STEPS = 2    # serve-batch steps


class SmokeFailure(RuntimeError):
    pass


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each bracketed
    by its own pair of CUDA events. Before each run the card spins for
    about 1 ms, so the host's work in ``fn`` before its launch overlaps
    the spin and the start event fires with the launch already queued:
    the time is the card's, not the wrapper's Python."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 2: kernels against their plain versions -----------------------------

def random_ell(n: int, r_cap: int, k: int, seed: int, device="cuda"):
    """Random incoming-adjacency ELL tile shaped like the full mirror: one
    first row per vertex in vertex order, spill rows for vertices with
    more than ``k`` entries handed out in shuffled order after them,
    unallocated capacity rows (row_id 0, all masked) at the end, ~10 %
    empty vertices; entries packed at the front of each row."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 13, n)
    deg[rng.random(n) < 0.10] = 0
    heavy = rng.random(n) < 0.005
    deg[heavy] = rng.integers(k + 1, 5 * k, int(heavy.sum()))
    rows_per_v = np.maximum(1, -(-deg // k))
    spill_owner = np.repeat(np.arange(n), rows_per_v - 1)
    rng.shuffle(spill_owner)
    n_rows = n + len(spill_owner)
    assert n_rows <= r_cap
    row_ids = np.zeros(r_cap, np.int32)
    row_ids[:n] = np.arange(n)
    row_ids[n:n_rows] = spill_owner
    # the j-th row of vertex v: its first row, then its spill rows in the
    # order the shuffled cursor handed them out
    rows_of = [[v] for v in range(n)]
    for j, v in enumerate(spill_owner):
        rows_of[v].append(n + j)
    fill = np.zeros(r_cap, np.int64)
    for v in np.nonzero(deg > k)[0]:
        left = deg[v]
        for r in rows_of[v]:
            fill[r] = min(k, left)
            left -= fill[r]
    light = deg <= k
    fill[:n][light] = deg[light]
    mask = np.arange(k)[None, :] < fill[:, None]
    cols = rng.integers(0, n, (r_cap, k)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (r_cap, k)).astype(np.float32)
    vals[~mask] = 0.0
    return tuple(torch.as_tensor(a, device=device)
                 for a in (cols, vals, mask, row_ids))


def spmm_bound(mask, x, n: int, with_vals: bool):
    """Least card time for the function on these inputs: each input byte
    it needs read once, each output byte written once — the whole mask,
    the row ids, the column id (and weight) of every live entry, all of
    x — against its flops (2·nnz·d for the SpMM, nnz·d compares for the
    reach) at the fp32 peak."""
    r, k = mask.shape
    nnz = int(mask.sum())
    d = x.shape[1]
    nbytes = (r * k + r * 4 + nnz * (8 if with_vals else 4)
              + x.numel() * 4 + n * d * 4)
    ops = (2 if with_vals else 1) * nnz * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops


def gather_floor(mask, d: int) -> float:
    """Milliseconds to read every live entry's row of x once from device
    memory (nnz · d · 4 bytes), as when x is far larger than L2."""
    return int(mask.sum()) * d * 4 / H100_BYTES_PER_S * 1e3


def spmm_csr(cols, vals, mask, row_ids, n: int, n_x: int):
    """The ELL tile as a CSR tensor for ``torch.sparse.mm`` (a yardstick
    only: the port never calls it)."""
    import torch
    live = mask.nonzero(as_tuple=True)
    coo = torch.sparse_coo_tensor(
        torch.stack([row_ids[live[0]].to(torch.int64),
                     cols[live].to(torch.int64)]),
        vals[live], (n, n_x)).coalesce()
    return coo.to_sparse_csr()


def digest(t) -> str:
    """First 16 hex digits of the sha256 of a tensor's bytes."""
    import hashlib
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def spmm_errors(y, y_ref):
    import torch
    diff = (y - y_ref).abs()
    denom = y_ref.abs()
    rel = torch.where(denom > 0, diff / denom.clamp_min(1e-30),
                      torch.where(diff > 0, torch.full_like(diff, float("inf")),
                                  torch.zeros_like(diff)))
    return float(diff.max()), float(rel.max())


def compare_spmm(ops, ref, cols, vals, mask, row_ids, x, n, index, label):
    y = ops.ell_spmm(cols, vals, mask, row_ids, x, n, index=index)
    y2 = ops.ell_spmm(cols, vals, mask, row_ids, x, n, index=index)
    y_ref = ref.ell_spmm_ref(cols, vals, mask, row_ids, x, n)
    check(bool((y == y2).all()), f"ell_spmm {label}: two launches differ")
    abs_err, rel_err = spmm_errors(y, y_ref)
    variant = ops.spmm_variant(x.shape[1], x.data_ptr())
    say(f"  ell_spmm {label}: R={cols.shape[0]} K={cols.shape[1]} n={n} "
        f"d={x.shape[1]} variant={variant} max_abs_err={abs_err:.3e} "
        f"max_rel_err={rel_err:.3e} run-to-run bitwise equal, output "
        f"sha256 {digest(y)}")
    check(rel_err <= SPMM_RTOL,
          f"ell_spmm {label}: max relative error {rel_err} > {SPMM_RTOL}")
    return abs_err, rel_err


def compare_reach(ops, ref, cols, mask, row_ids, x, n, index, label):
    y = ops.ell_reach(cols, mask, row_ids, x, n, index=index)
    y_ref = ref.ell_reach_ref(cols, mask, row_ids, x, n)
    abs_err = float((y - y_ref).abs().max()) if y.numel() else 0.0
    bitwise = bool(y.equal(y_ref))
    say(f"  ell_reach {label}: R={cols.shape[0]} K={cols.shape[1]} n={n} "
        f"d={x.shape[1]} max_abs_err={abs_err:.3e} bitwise={bitwise}")
    check(bitwise, f"ell_reach {label}: not bitwise equal")
    return abs_err


def phase_kernels(ds, reps: int):
    import torch
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    n, k, r_cap = 262_144, 64, 393_216
    cols, vals, mask, row_ids = random_ell(n, r_cap, k, seed=0)
    index = build_row_index(mask, row_ids, n)
    nnz = int(mask.sum())
    say(f"phase kernels: synthetic ELL n={n} R={r_cap} K={k} nnz={nnz} "
        f"live_rows={index[0].shape[0]} "
        f"empty_vertices={int((index[1][1:] == index[1][:-1]).sum())}")
    csr = spmm_csr(cols, vals, mask, row_ids, n, n)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for d in ds:
        x = torch.rand((n, d), device="cuda", generator=gen)
        xb = (torch.rand((n, d), device="cuda", generator=gen)
              < 0.1).to(torch.float32)
        s_abs, s_rel = compare_spmm(ops, ref, cols, vals, mask, row_ids, x,
                                    n, index, f"synthetic d={d}")
        r_abs = compare_reach(ops, ref, cols, mask, row_ids, xb, n, index,
                              f"synthetic d={d}")
        s_ms = cuda_ms(lambda: ops.ell_spmm(cols, vals, mask, row_ids, x, n,
                                            index=index), reps)
        r_ms = cuda_ms(lambda: ops.ell_reach(cols, mask, row_ids, xb, n,
                                             index=index), reps)
        s_plain = cuda_ms(lambda: ref.ell_spmm_ref(cols, vals, mask, row_ids,
                                                   x, n), 3, warmup=1)
        r_plain = cuda_ms(lambda: ref.ell_reach_ref(cols, mask, row_ids, xb,
                                                    n), 3, warmup=1)
        s_lib = cuda_ms(lambda: torch.sparse.mm(csr, x), reps)
        s_bound, s_by, s_bytes, s_ops = spmm_bound(mask, x, n, True)
        r_bound, r_by, r_bytes, r_ops = spmm_bound(mask, xb, n, False)
        s_floor = gather_floor(mask, d)
        say(f"  d={d} ell_spmm: {s_ms:.4f} ms, plain {s_plain:.4f} ms, "
            f"torch.sparse.mm(csr) {s_lib:.4f} ms, bound {s_bound:.4f} ms "
            f"({s_by}: {s_bytes} B, {s_ops} flop), gather floor "
            f"{s_floor:.4f} ms ({nnz * d * 4} B)")
        say(f"  d={d} ell_reach: {r_ms:.4f} ms, plain {r_plain:.4f} ms, "
            f"bound {r_bound:.4f} ms ({r_by}: {r_bytes} B, {r_ops} op)")
        rows[("ell_spmm", d)] = dict(ms=s_ms, plain_ms=s_plain,
                                     library_ms=s_lib, bound_ms=s_bound,
                                     bound_by=s_by, bytes=s_bytes,
                                     gather_floor_ms=s_floor,
                                     variant=ops.spmm_variant(
                                         d, x.data_ptr()),
                                     max_abs_err=s_abs, max_rel_err=s_rel)
        rows[("ell_reach", d)] = dict(ms=r_ms, plain_ms=r_plain,
                                      library_ms=None, bound_ms=r_bound,
                                      bound_by=r_by, bytes=r_bytes,
                                      max_abs_err=r_abs)
        del x, xb
    torch.cuda.synchronize()
    return rows


# -- phase 3: the LM kernels against their plain versions -----------------------

def bound(nbytes: int, flops: int, peak_flops: float):
    """Least card time: the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def causal_pairs(sq: int, sk: int, q_offset: int = 0) -> int:
    """Visible (query, key) pairs of one head under the causal mask."""
    import numpy as np
    rows = np.minimum(q_offset + np.arange(sq) + 1, sk)
    return int(rows.sum())


def row_atol(want):
    """Flash's atol: ``LM_KERNEL_RTOL`` times the RMS of each output row
    (the hd values of one query and head) of the plain version."""
    return LM_KERNEL_RTOL * want.float().pow(2).mean(-1, keepdim=True).sqrt()


def lm_check(name: str, got, again, want, atol):
    """Max abs error, and the largest share of its allowance ``atol +
    rtol·|want|`` that any element uses (≤ 1 passes); ``atol`` is a number
    or a tensor that broadcasts against ``want``."""
    import torch
    check(bool(torch.equal(got, again)), f"{name}: two launches differ")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    diff = (g - w).abs()
    abs_err = float(diff.max())
    used = float((diff / (atol + LM_KERNEL_RTOL * w.abs())).max())
    check(used <= 1.0, f"{name}: outside its tolerance (max abs error "
                       f"{abs_err:.3e}, {used:.2f} of the allowance)")
    return abs_err, used


def phase_lm_kernels(reps: int):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.expert_gemm.ref import expert_gemm_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.models.moe import moe_capacity
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(bf)

    B, H, KV = LM_BATCH, FULL.n_heads, FULL.n_kv_heads
    # the served prefill and a ragged S go to the TMA + wgmma kernel; hd 40
    # only the first kernel takes
    for label, S, hd, name in (
            ("prefill", LM_PROMPT, FULL.head_dim, flash_ops.WGMMA),
            ("ragged", LM_PROMPT + LM_TOKENS - 1, FULL.head_dim,
             flash_ops.WGMMA),
            ("hd40", LM_PROMPT, 40, flash_ops.FIRST)):
        q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
        before = dict(flash_ops.LAUNCHES)
        o = flash_ops.flash_attention(q, k, v)
        check(flash_ops.LAUNCHES[name] == before[name] + 1,
              f"flash_attention {label}: not taken by {name} "
              f"({flash_ops.LAUNCHES})")
        o2 = flash_ops.flash_attention(q, k, v)
        want = flash_attention_ref(q, k, v)
        err, used = lm_check(f"{name} {label}", o, o2, want,
                             row_atol(want))
        # the second half of the rows: outputs of a few hundredths
        late = slice(S // 2, None)
        late_err = float((o[:, late].float() - want[:, late].float())
                         .abs().max())
        late_rms = float(want[:, late].float().pow(2).mean().sqrt())
        del want, o2
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: flash_ops.flash_attention(q, k, v), reps)
        plain = cuda_ms(lambda: flash_attention_ref(q, k, v), 3, warmup=1)
        torch.cuda.empty_cache()
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), reps)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
        flops = 4 * B * H * hd * causal_pairs(S, S)
        b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
        say(f"  {name} {label}: q {tuple(q.shape)} k,v "
            f"{tuple(k.shape)} bf16: max_abs_err={err:.3e} ({used:.3f} of "
            f"the allowance; rows >= {S // 2}: {late_err:.3e} at output RMS"
            f" {late_rms:.3e}) run-to-run "
            f"bitwise equal; {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
            f"{flops} flop)")
        rows[(name, label)] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, bytes=nbytes, flops=flops, max_abs_err=err,
            tol_used=used, late_max_abs_err=late_err, late_rms=late_rms,
            shape=f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal")
        del q, k, v, o
        torch.cuda.empty_cache()

    # the dispatch buffers of serve-lm: one MoE group per sequence at
    # prefill (capacity 328), one group of the batch's 2 tokens at decode
    moe = FULL.moe
    E, d, f = moe.n_experts, FULL.d_model, moe.d_ff_expert
    c_pre = moe_capacity(LM_PROMPT, E, moe.top_k)
    c_dec = moe_capacity(LM_BATCH, E, moe.top_k)
    s_in = (2.0 / (d + f)) ** 0.5
    w_gate, w_up = randn(E, d, f, scale=s_in), randn(E, d, f, scale=s_in)
    w_down = randn(E, f, d, scale=s_in)
    for label, G, C, w in (("prefill gate", LM_BATCH, c_pre, w_gate),
                           ("prefill up", LM_BATCH, c_pre, w_up),
                           ("prefill down", LM_BATCH, c_pre, w_down),
                           ("decode gate", 1, c_dec, w_gate)):
        depth = w.shape[1]
        x = randn(G * E, C, depth)
        y = gemm_ops.expert_gemm(x, w)
        y2 = gemm_ops.expert_gemm(x, w)
        err, used = lm_check(f"expert_gemm {label}", y, y2,
                             expert_gemm_ref(x, w), LM_GEMM_ATOL)
        ms = cuda_ms(lambda: gemm_ops.expert_gemm(x, w), reps)
        plain = cuda_ms(lambda: expert_gemm_ref(x, w), 3, warmup=1)
        x4 = x.view(G, E, C, depth)
        lib = cuda_ms(lambda: torch.matmul(x4, w), reps)
        nbytes = sum(t.numel() * t.element_size() for t in (x, w, y))
        flops = 2 * G * E * C * depth * w.shape[2]
        b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
        say(f"  expert_gemm {label}: x {tuple(x.shape)} w {tuple(w.shape)}"
            f" bf16: max_abs_err={err:.3e} ({used:.3f} of the allowance) "
            f"run-to-run bitwise equal; "
            f"{ms:.4f} ms, plain {plain:.4f} ms, torch.matmul {lib:.4f} ms,"
            f" bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
        rows[("expert_gemm", label)] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, bytes=nbytes, flops=flops, max_abs_err=err,
            tol_used=used, shape=f"x {tuple(x.shape)} w {tuple(w.shape)} bf16")
        del x, y, y2, x4
    del w_gate, w_up, w_down
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def reset_all_counts():
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.spmv_ell import ops as ell_ops
    for ops in (ell_ops, flash_ops, gemm_ops):
        ops.reset_launch_counts()


def read_all_counts():
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.spmv_ell import ops as ell_ops
    return {**ell_ops.LAUNCHES, **flash_ops.LAUNCHES, **gemm_ops.LAUNCHES}


# -- phase 5: LM agreement, card against CPU ------------------------------------

def phase_lm_agreement():
    import torch
    from repro_torch.configs.qwen3_moe_30b_a3b import SMOKE
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.transformer import TransformerLM
    # f32 products in full f32 on the card (PyTorch's default, set here so
    # the 1e-4 agreement does not rest on it)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TransformerLM(SMOKE)
    params = model.init(torch.Generator(device="cpu").manual_seed(0))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    prompt = torch.randint(0, SMOKE.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    reset_all_counts()
    out = {}
    for dev in ("cuda", "cpu"):
        p = to(params, dev)
        logits, _ = model.prefill(p, prompt.to(dev))
        gen = greedy_generate(model, p, prompt.to(dev), LM_TOKENS)
        out[dev] = (logits.cpu(), gen.tokens.cpu(), gen.logits.cpu(),
                    gen.cache[0].cpu())
    counts = read_all_counts()
    check(counts["flash_attention_fwd"] > 0 and counts["expert_gemm"] > 0,
          f"LM agreement: the card path launched no LM kernel ({counts})")
    (pre_g, tok_g, last_g, k_g), (pre_c, tok_c, last_c, k_c) = \
        out["cuda"], out["cpu"]
    check(bool(torch.equal(tok_g, tok_c)),
          f"LM agreement: greedy tokens differ: {tok_g.tolist()} vs "
          f"{tok_c.tolist()}")
    err_pre = float((pre_g - pre_c).abs().max())
    err_last = float((last_g - last_c).abs().max())
    k_steps = int((k_g != k_c).sum())
    say(f"phase lm-agreement: qwen3-moe SMOKE f32, 2 x 12 prompt, "
        f"{LM_TOKENS} greedy tokens equal on card and CPU; max |logit "
        f"diff| prefill {err_pre:.3e}, last step {err_last:.3e}; "
        f"bf16 key-cache entries that differ {k_steps} of {k_g.numel()}; "
        f"card launches {counts}")
    check(max(err_pre, err_last) <= LM_AGREE_TOL,
          f"LM agreement: logits differ by more than {LM_AGREE_TOL}")
    return counts


# -- phase 8: serve-lm -----------------------------------------------------------

def phase_serve_lm(profile: bool = False):
    import dataclasses
    import torch
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(FULL, n_layers=LM_LAYERS)
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"  serve-lm model: qwen3-moe-30b-a3b FULL widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, hd "
        f"{cfg.head_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
        f"d_ff {cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}); reduced: "
        f"n_layers {cfg.n_layers} of {FULL.n_layers}; {n_params} params "
        f"bf16 (param_count {cfg.param_count()}), init {init_s:.2f} s")
    check(n_params == cfg.param_count(), "serve-lm: parameter count")
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    gen = greedy_generate(model, params, prompt, LM_TOKENS)
    launches = read_all_counts()
    peak = torch.cuda.max_memory_allocated()
    n_dec = LM_BATCH * (LM_TOKENS - 1)
    say(f"  serve-lm prefill {LM_BATCH} x {LM_PROMPT}: {gen.prefill_s:.3f} s"
        f" ({LM_BATCH * LM_PROMPT / gen.prefill_s:.1f} tok/s); "
        f"{LM_TOKENS - 1} decode steps: {gen.decode_s:.3f} s "
        f"({n_dec / gen.decode_s:.2f} tok/s, "
        f"{gen.decode_s / (LM_TOKENS - 1) * 1e3:.2f} ms/step); peak memory "
        f"{peak} B")
    say(f"  serve-lm launches: {launches}")
    check(launches["flash_attention_fwd_wgmma"] == LM_LAYERS
          and launches["flash_attention_fwd"] == 0,
          f"serve-lm: flash launches {launches['flash_attention_fwd_wgmma']}"
          f" (TMA + wgmma) and {launches['flash_attention_fwd']} (first "
          f"kernel), want {LM_LAYERS} and 0")
    want_gemm = 3 * LM_LAYERS * LM_TOKENS
    check(launches["expert_gemm"] == want_gemm,
          f"serve-lm: expert_gemm launches {launches['expert_gemm']} != "
          f"{want_gemm}")
    toks = gen.tokens
    check(toks.shape == (LM_BATCH, LM_TOKENS), "serve-lm: token shape")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "serve-lm: token out of the vocabulary")
    check(bool(torch.isfinite(gen.logits.float()).all()),
          "serve-lm: non-finite logits")
    say(f"  serve-lm greedy continuation (row 0): {toks[0].tolist()}")
    prefill_s, decode_s = gen.prefill_s, gen.decode_s
    if profile:
        cache = tuple(c.clone() for c in gen.cache)
        StepProfiler(True, "serve-lm decode").step(
            1, lambda: model.decode_step(params, toks[:, -1:], cache,
                                         LM_PROMPT + LM_TOKENS - 1))
        del cache
        StepProfiler(True, "serve-lm prefill").step(
            1, lambda: model.prefill(params, prompt))

    # consistency: a prefill over the prompt + the 15 fed-back tokens gives
    # the last decode step's logits if both compute the same per-token
    # function. At the served capacity factor (1.25) they do not: the
    # prefill drops the MoE slots over capacity, a 2-token decode step
    # drops none. So the check serves the prompt again and prefills at a
    # capacity that drops nothing, in bf16 and, on the same draws, in f32.
    del gen
    t0 = time.perf_counter()
    bf = consistency(cfg, params, prompt, "bf16")
    consist_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = TransformerLM(cfg32).init(
        torch.Generator(device="cuda").manual_seed(0))
    f32 = consistency(cfg32, params32, prompt, "f32")
    del params32
    torch.cuda.empty_cache()
    for tag, res, corr_min, atol in (
            ("bf16", bf, LM_CONSIST_CORR, LM_CONSIST_ATOL),
            ("f32", f32, LM_CONSIST32_CORR, LM_CONSIST32_ATOL)):
        check(res["corr"] >= corr_min,
              f"serve-lm {tag}: prefill/decode logits correlation "
              f"{res['corr']} < {corr_min}")
        check(res["max_abs"] <= atol,
              f"serve-lm {tag}: prefill/decode logits differ by "
              f"{res['max_abs']} > {atol}")
    return launches, dict(n_layers=cfg.n_layers, init_s=init_s,
                          prefill_s=prefill_s, decode_s=decode_s,
                          decode_tok_s=n_dec / decode_s,
                          consistency_s=consist_s, peak_bytes=peak,
                          consistency_bf16=bf, consistency_f32=f32)


def consistency(cfg, params, prompt, tag: str):
    """Serve ``prompt`` with no MoE slot dropped, then prefill the prompt +
    the fed-back tokens the same way and compare the last logits with the
    last decode step's."""
    import torch
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.transformer import TransformerLM
    model = TransformerLM(cfg)
    with no_drop_capacity():
        gen = greedy_generate(model, params, prompt, LM_TOKENS)
        full = torch.cat([prompt, gen.tokens[:, :-1].to(prompt.dtype)],
                         dim=1)
        logits, _ = model.prefill(params, full)
    a, b = logits.float(), gen.logits.float()
    out = dict(max_abs=float((a - b).abs().max()),
               max_logit=float(b.abs().max()),
               corr=float(torch.corrcoef(torch.stack([a.ravel(),
                                                      b.ravel()]))[0, 1]),
               same_argmax=bool(torch.equal(a.argmax(-1), b.argmax(-1))))
    say(f"  serve-lm consistency {tag}: no-drop serve of the prompt, then a "
        f"no-drop prefill {tuple(full.shape)} vs the last decode step: max "
        f"|diff| {out['max_abs']:.4e} (max |logit| {out['max_logit']:.4e}),"
        f" correlation {out['corr']:.6f}, same argmax {out['same_argmax']}")
    return out


@contextlib.contextmanager
def no_drop_capacity():
    """Route every MoE block at capacity factor E / top_k, where no slot can
    be dropped (the served factor is 1.25), and check that none is."""
    from repro_torch.models import moe
    route = moe.route

    def no_drop(x, router, cfg, n_groups, capacity_factor=1.25):
        r = route(x, router, cfg, n_groups, cfg.n_experts / cfg.top_k)
        check(bool(r.keep.all()), "no-drop capacity dropped a MoE slot")
        return r

    moe.route = no_drop
    try:
        yield
    finally:
        moe.route = route


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -- phase 4: CUDA vs CPU on a small stream ------------------------------------

def phase_small_agreement():
    from repro_torch.config.base import IGPMConfig, ServingConfig
    from repro_torch.core.query import query_zoo
    from repro_torch.data.temporal import TemporalGraphSpec, generate_stream
    from repro_torch.serving.server import MatchServer
    spec = TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                             n_edges=4096, n_steps=40, seed=7)
    cfg = IGPMConfig(n_max=512, e_max=16384, rwr_iters=12,
                     rwr_iters_incremental=4, top_k_patterns=8,
                     init_community_size=32, backend="ell")
    out = {}
    for dev in ("cuda", "cpu"):
        st = generate_stream(spec, n_measured_steps=4, u_max=128, device=dev)
        srv = MatchServer(cfg, query_zoo(4), ServingConfig(adaptive=False),
                          device=dev)
        _, stats = srv.run(st.graph, st.updates)
        out[dev] = ([s.deltas for s in stats],
                    [dict(s._patterns) for s in srv.stores])
    check(out["cuda"][0] == out["cpu"][0],
          "small stream: CUDA and CPU match deltas differ")
    worst = 0.0
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        check(sorted(a) == sorted(b),
              "small stream: CUDA and CPU pattern stores differ")
        for key, (good, exact) in a.items():
            check(exact == b[key][1], "small stream: exact flags differ")
            worst = max(worst, abs(good - b[key][0]))
    n_pat = sum(len(s) for s in out["cuda"][1])
    check(n_pat > 0, "small stream: no patterns found")
    say(f"phase small-stream: CUDA == CPU plain on {len(out['cuda'][0])} "
        f"steps, {n_pat} patterns, max goodness diff {worst:.3e}")
    check(worst <= 1e-4, "small stream: goodness differs by more than 1e-4")


# -- phases 6-7: the IGPM paths ---------------------------------------------------

class Capture:
    """Wrap the ELL wrappers to keep copies of the first inputs of each
    kind the served path hands them: the label-RWR sweep (d = n_labels),
    the expansion sweep (wider d) and the BFS frontier sweep."""

    def __init__(self, ops, n_labels: int):
        self.ops = ops
        self.n_labels = n_labels
        self.inputs = {}
        self._spmm, self._reach = ops.ell_spmm, ops.ell_reach

    def __enter__(self):
        ops, inputs = self.ops, self.inputs
        spmm, reach, n_labels = self._spmm, self._reach, self.n_labels

        def spy_spmm(cols, vals, mask, row_ids, x, n, index=None):
            key = "label_rwr" if x.shape[1] == n_labels else "expansion_rwr"
            if key not in inputs:
                inputs[key] = tuple(t.clone() for t in
                                    (cols, vals, mask, row_ids, x)) + (n,)
            return spmm(cols, vals, mask, row_ids, x, n, index=index)

        def spy_reach(cols, mask, row_ids, x, n, index=None):
            if "bfs" not in inputs:
                inputs["bfs"] = tuple(t.clone() for t in
                                      (cols, mask, row_ids, x)) + (n,)
            return reach(cols, mask, row_ids, x, n, index=index)

        ops.ell_spmm, ops.ell_reach = spy_spmm, spy_reach
        return self

    def __exit__(self, *exc):
        self.ops.ell_spmm, self.ops.ell_reach = self._spmm, self._reach
        return False


class StepProfiler:
    """With ``enabled``, record step 1 (the first warm step) under
    ``torch.profiler`` and report device time by op and the device busy
    share of that step's wall time. A no-op otherwise."""

    def __init__(self, enabled: bool, label: str):
        self.enabled = enabled
        self.label = label

    def step(self, i: int, fn):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if not self.enabled or i != 1:
            return fn()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        from torch.autograd import DeviceType
        rows = []
        for ev in prof.key_averages():
            # device-side events only (kernels, copies): an aten op's own
            # device time repeats that of the kernels it launched
            if getattr(ev, "device_type", None) == DeviceType.CPU:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy_us = sum(r[0] for r in rows)
        say(f"  profile {self.label} step {i}: wall {wall_s * 1e3:.1f} ms "
            f"(profiled), device busy {busy_us / 1e3:.1f} ms "
            f"({100 * busy_us / 1e6 / wall_s:.1f} %)")
        for dev_us, count, key in rows[:12]:
            say(f"    {dev_us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        return out


def check_results(stats_deltas, where: str) -> int:
    total = sum(d.total for d in stats_deltas)
    check(total > 0, f"{where}: no patterns in the stores")
    return total


def phase_serve_inc(stream, n_steps: int, profile: bool = False):
    import torch
    from repro_torch.config.base import ServingConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.kernels.spmv_ell import ops
    from repro_torch.serving.server import MatchServer
    srv = MatchServer(FULL, query_zoo(16), ServingConfig(adaptive=False),
                      device="cuda")
    g = stream.graph
    ops.reset_launch_counts()
    per_step = []
    prof = StepProfiler(profile, "serve-inc")
    with Capture(ops, FULL.n_labels) as cap:
        for i, upd in enumerate(stream.updates[:n_steps]):
            t0 = time.perf_counter()
            srv.submit_update(upd)
            g, st = prof.step(i, lambda: srv.step(g))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_live = max(int(g.node_mask.sum()), 1)
            storm = st.n_recompute > srv.serving.full_graph_frac * n_live
            say(f"  serve-inc step {i}: {dt:.3f} s (pipeline {st.elapsed:.3f}"
                f" s, ell refresh {st.ell_refresh_s:.3f} s) n_recompute="
                f"{st.n_recompute} storm={storm} subgraph="
                f"{st.subgraph_nodes} vertices/{st.subgraph_edges} arcs "
                f"new_patterns={st.n_new_patterns}")
            if i == 0:
                say(f"  serve-inc louvain dendrogram build (host): "
                    f"{srv.pem.clustering_time:.3f} s")
            per_step.append(dict(step=i, s=dt, pipeline_s=st.elapsed,
                                 n_recompute=st.n_recompute, storm=storm,
                                 subgraph_nodes=st.subgraph_nodes,
                                 new_patterns=st.n_new_patterns))
    launches = dict(ops.LAUNCHES)
    say(f"  serve-inc launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"serve-inc never launched {name}")
    total = check_results(st.deltas, "serve-inc")
    for d in st.deltas:
        check(d.total >= d.exact >= 0, "serve-inc: inconsistent store counts")
    say(f"  serve-inc stores: {total} patterns over {len(st.deltas)} queries")
    return launches, per_step, cap.inputs, srv.pem.clustering_time


def phase_serve_batch(stream, n_steps: int, profile: bool = False):
    import numpy as np
    import torch
    from repro_torch.config.base import EngineConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.engine import Engine
    from repro_torch.kernels.spmv_ell import ops
    eng = Engine(FULL, EngineConfig(mode="batch"), device="cuda")
    for q in query_zoo(16):
        eng.register(q)
    state = eng.init_state(stream.graph)
    ops.reset_launch_counts()
    per_step = []
    prof = StepProfiler(profile, "serve-batch")
    for i, upd in enumerate(stream.updates[:n_steps]):
        t0 = time.perf_counter()
        state, out = prof.step(i, lambda: eng.step(state, upd))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        say(f"  serve-batch step {i}: {dt:.3f} s (pipeline {out.elapsed:.3f}"
            f" s) patterns={out.n_new_patterns} rwr_sweeps={out.rwr_sweeps}")
        per_step.append(dict(step=i, s=dt, pipeline_s=out.elapsed,
                             new_patterns=out.n_new_patterns))
    launches = dict(ops.LAUNCHES)
    say(f"  serve-batch launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"serve-batch never launched {name}")
    check_results(out.deltas, "serve-batch")
    for qid, store in eng.stores.items():
        good = np.asarray([v[0] for v in store._patterns.values()])
        check(bool(np.isfinite(good).all()),
              f"serve-batch: non-finite goodness in {qid}")
    return launches, per_step


def check_captured(inputs):
    import torch
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    for key in ("label_rwr", "expansion_rwr", "bfs"):
        check(key in inputs, f"serve-inc handed no {key} sweep to a kernel")
    out = {}
    for key in ("label_rwr", "expansion_rwr"):
        cols, vals, mask, row_ids, x, n = inputs[key]
        index = build_row_index(mask, row_ids, n)
        abs_err, rel_err = compare_spmm(ops, ref, cols, vals, mask, row_ids,
                                        x, n, index, f"captured {key}")
        ms = cuda_ms(lambda: ops.ell_spmm(cols, vals, mask, row_ids, x, n,
                                          index=index), REPS)
        csr = spmm_csr(cols, vals, mask, row_ids, n, x.shape[0])
        lib = cuda_ms(lambda: torch.sparse.mm(csr, x), REPS)
        b_ms, b_by, nbytes, _ = spmm_bound(mask, x, n, True)
        floor = gather_floor(mask, x.shape[1])
        say(f"  ell_spmm captured {key}: nnz={int(mask.sum())} "
            f"{ms:.4f} ms, torch.sparse.mm(csr) {lib:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} B), gather floor {floor:.4f} ms")
        out[key] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                        library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                        gather_floor_ms=floor, nnz=int(mask.sum()),
                        R=cols.shape[0], n=n, d=x.shape[1])
    cols, mask, row_ids, x, n = inputs["bfs"]
    index = build_row_index(mask, row_ids, n)
    out["bfs"] = compare_reach(ops, ref, cols, mask, row_ids, x, n, index,
                               "captured bfs")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile serve step 1 of each path (device time "
                         "by op, device busy share)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        say("chip_smoke: FAIL torch.cuda.is_available() is False — this "
            "script needs a CUDA card")
        return 2
    if not (SRC / "repro_torch" / "kernels").is_dir():
        say(f"chip_smoke: FAIL no port package under {SRC} — run from a "
            "checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    say(f"phase build: {time.perf_counter() - t0:.2f} s wall "
        f"(per source: {', '.join(f'{k} {v:.2f} s' for k, v in built.items()) or 'cached'})")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  nvcc {name}: {line.strip()}")

    rows = phase_kernels((4, 320), REPS)
    say("phase lm-kernels:")
    rows.update(phase_lm_kernels(REPS))
    phase_small_agreement()
    launches_agree = phase_lm_agreement()
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.data.temporal import generate_stream, scaled_twin
    spec = scaled_twin("transactions", 1.0)
    t0 = time.perf_counter()
    stream = generate_stream(spec, n_max=FULL.n_max, e_max=FULL.e_max,
                             n_measured_steps=max(INC_STEPS, BATCH_STEPS),
                             u_max=512, device="cuda")
    say(f"phase stream: {spec.name} n_vertices={spec.n_vertices} "
        f"warm arcs={int(stream.graph.edge_mask.sum())} "
        f"({time.perf_counter() - t0:.2f} s)")
    say("phase serve-inc:")
    launches_inc, inc_steps, captured, louvain_s = phase_serve_inc(
        stream, INC_STEPS, args.profile)
    cap = check_captured(captured)
    del captured
    say("phase serve-batch:")
    launches_batch, batch_steps = phase_serve_batch(
        stream, BATCH_STEPS, args.profile)
    del stream
    say("phase serve-lm:")
    launches_lm, lm = phase_serve_lm(args.profile)
    serve = dict(inc_steps=inc_steps, batch_steps=batch_steps,
                 louvain_s=louvain_s, captured=cap, lm=lm)

    kernels = []
    for name, src, line in (
            ("ell_spmm", "src/repro_torch/kernels/spmv_ell/csrc/ell_spmm.cu",
             "src/repro/kernels/spmv_ell/spmv_ell.py:60"),
            ("ell_reach", "src/repro_torch/kernels/spmv_ell/csrc/ell_reach.cu",
             "src/repro/kernels/spmv_ell/spmv_ell.py:91")):
        head = rows[(name, 320)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches_inc[name], "launches_path": "serve-inc",
            "launches_batch": launches_batch[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "gather_floor_ms": head.get("gather_floor_ms"),
            "shape": "R=393216 K=64 n=262144 d=320",
            "by_d": {str(d): rows[(name, d)] for d in (4, 320)},
        })
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/"
    flash_tpu = "src/repro/kernels/flash_attention/flash_attention.py:80"
    for name, src, line, labels, launches, path in (
            ("flash_attention_fwd_wgmma",
             flash_src + "flash_attention_fwd_wgmma.cu", flash_tpu,
             ("prefill", "ragged"), launches_lm, "serve-lm"),
            # the first kernel keeps the f32 and the odd-hd bf16 calls: the
            # SMOKE model's f32 attention on the card launches it
            ("flash_attention_fwd", flash_src + "flash_attention_fwd.cu",
             flash_tpu, ("hd40",), launches_agree, "lm-agreement"),
            ("expert_gemm",
             "src/repro_torch/kernels/expert_gemm/csrc/expert_gemm.cu",
             "src/repro/kernels/expert_gemm/expert_gemm.py:44",
             ("prefill gate", "prefill up", "prefill down", "decode gate"),
             launches_lm, "serve-lm")):
        check(launches[name] > 0, f"{path} never launched {name}")
        head = rows[(name, labels[0])]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches[name], "launches_path": path,
            "max_abs_err": max(rows[(name, lb)]["max_abs_err"]
                               for lb in labels),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "by_shape": {lb: rows[(name, lb)] for lb in labels},
        })
    say(f"serve summary: {json.dumps(serve)}")
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        say(f"chip_smoke: FAIL {exc}")
        sys.exit(1)
