#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (``nvidia-smi``) and the build of all eight kernel sources
   under ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source,
   started together);
2. the ELL kernels against their plain PyTorch versions on random ELL data
   at the full mirror's shapes (R 393,216 rows, K 64, n 262,144,
   d ∈ {4, 320}, with shuffled spill rows, unallocated capacity rows and
   empty vertices): SpMM to max relative error ≤ 1e-5, reach bitwise;
   median kernel time from CUDA events, the plain version's time,
   ``torch.sparse.mm`` on the same matrix as a CSR tensor (a yardstick only
   — the port never calls it), the byte/flop bound of the work, and for
   both the gather floor (nnz · d · 4 bytes at the memory rate: every
   live entry's row of x read once, no reuse in L2), the variant that took
   the call, and for the SpMM a digest of its output;
3. the LM kernels against their plain versions at the serve-lm shapes of
   qwen3-moe-30b-a3b: flash attention at prefill (B 2, S 4,096, H 32, KV 4,
   hd 128) and at a ragged S 4,111 against dense f32 ``attention_ref``
   (both taken by the TMA + wgmma kernel), and the first flash kernel at
   hd 40, a shape only it takes; the expert GEMM at the three prefill
   products (gate, up, down of the (2, 128, 328, ·) dispatch buffer; the
   tiles variant of the TMA + wgmma source), at decode gate and down (C 8;
   its skinny variant), and in f32 and in bf16 with x 2 bytes off a
   16-byte boundary at decode gate (both the first kernel), against an
   f32 einsum; each case asserts which variant took it; bf16 to
   rtol 2e-2, with atol 2e-2 for the expert GEMM (outputs of O(1)) and,
   for flash, 2e-2 times each output row's RMS in the plain version (late
   causal rows average thousands of values and are a few hundredths); the
   f32 GEMM to 1e-4; two launches bitwise equal; times, bounds and the
   yardsticks ``scaled_dot_product_attention`` (causal, GQA) and
   ``torch.matmul`` on the same inputs. Then the training side: both
   forward kernels asked for each row's log-sum-exp (prefill, hd 40, f32
   hd 16) must give O bit for bit as without it and an LSE within 1e-5
   relative / 1e-4 absolute of a plain ``logsumexp``; the flash backward
   at the train shape (B 1, S 4,096, H 32, KV 4, hd 128, bf16) and at a
   ragged S 4,111 (both taken by the TMA + wgmma backward kernel), and at
   bf16 hd 40 and in f32 at hd 16 (both the first backward kernel) against
   ``flash_attention_bwd_ref`` (dq, dk, dv within 2e-2 — 1e-4 in f32 — of
   each element plus its row's RMS, plus 1e-4 of the tensor's RMS; two
   launches bitwise equal), timed beside the backward of
   ``scaled_dot_product_attention`` through autograd, the bound and, for
   the TMA kernel, its two-pass floor (7 products); the expert GEMM's
   backward products at the train shapes (dX = dY·Wᵀ and dW = Xᵀ·dY of
   the gate and down products, G 4, C 88) against the plain version, timed
   beside ``torch.matmul``, and the plain-torch transposes they need. Then
   the same kernels at the other LM configs' shapes, held and timed the
   same way: the flash forward at train-smollm's microbatch (B 4, S 4,096,
   H 9, KV 3, hd 64) and deepseek-7b's prefill (B 2, H 32, KV 32, hd 128:
   G 1), the flash backward at train-smollm's microbatch and at G 1
   (deepseek-7b) and G 6 (dbrx-132b, H 48, KV 8), and dbrx-132b's gate, up
   and down products (16 experts, d 6,144, f 10,752) at prefill (C 1,288,
   tiles) and decode (C 8, skinny);
4. a small-input check: the toy stream served on the card and on the CPU
   (plain versions) must give equal match deltas and stores;
5. adaptive agreement: the toy stream served with the default
   ``ServingConfig()`` (adaptive PEM) on the card and on the CPU, the card's
   DQN loaded from the CPU agent's state before step 0 and both PEMs'
   feedback given one seeded elapsed schedule in place of wall time: equal
   deltas, stores and c trajectory, TD losses within 1e-5 relative; then
   the serving controller on a toy closed loop (n 128, ``rwr_tol`` 1e-4,
   a flash crowd of 8 ticks under ``VirtualClock`` and the simulated
   service model): a policy trained on the CPU, loaded frozen on the card
   and on the CPU, must give equal decision histories (observations
   bitwise), equal label-RWR sweeps per step and equal stores;
6. LM agreement: qwen3-moe ``SMOKE`` (f32) with one set of weights served
   greedily on the card (kernels) and on the CPU (plain versions): equal
   tokens, logits within 1e-4;
   train agreement: the qwen3-moe ``SMOKE`` config and the dense smoke
   config of ``tests/test_torch_lm.py`` (both f32), 3 train steps of 2
   microbatches on the card and on the CPU from one set of weights and one
   ``TokenPipeline`` stream: losses within 1e-4 relative, step-0
   gradients per leaf within 1e-4 relative plus 1e-5 of the leaf's
   largest entry; the first flash kernel, the backward kernel (f32 path)
   and the first GEMM kernel must launch;
7. serve-inc — ``MatchServer(FULL, query_zoo(16), ServingConfig(adaptive=
   False))`` on the ``transactions`` twin at full scale for 4 served steps,
   launch counters set to 0 before and read after; the inputs of the first
   label-RWR sweep, the first expansion sweep and the first BFS sweep are
   captured, the kernels held against their plain versions on them and
   timed;
8. serve-batch — 2 steps of ``Engine(FULL, EngineConfig(mode="batch"))``
   on the same stream (full-graph label RWR and bank match), counters
   again set to 0 before and read after; its first BFS sweep (the full
   mirror) is captured, held bitwise and timed. Then serve-sharded:
   serve-batch's engine over the device mesh (the visible cards where
   there are two or more, else ``cuda:0`` named four times, which checks
   the distribution and is no speedup) in three
   layouts — ``graph_shard="auto", shard="off"`` (g = 4), the same with
   ``edge_partition="on"``, and ``shard="auto", graph_shard="auto"`` (a
   2 × 2 mesh) — 2 steps each, counters set to 0 before each run and read
   after; every label-RWR table, every bucket's matched ids, goodness,
   hops and exact/valid flags, the deltas and the stores must equal
   serve-batch's bitwise; step times, launches, the row-block capacity
   and per-shard mirror bytes are printed; then both ELL kernels on row
   block 0 of the g = 4 mirror (n_loc 65,536 of n_x 262,144) against their
   plain versions at d 4 and 160, timed;
9. serve-adaptive — ``MatchServer(FULL, query_zoo(16), ServingConfig())``,
   the paper's IGPM-PEM, on the same stream for 20 steps, counters set to
   0 before and read after: per step the wall and pipeline time, c, the TD
   loss, the recompute set and subgraph, and the time of the PEM's
   feedback and communities calls (wrapped here); checks that c moved,
   that every learning step (from step 16, when the replay ring holds
   replay_batch = 16 transitions) has rl_loss > 0, that both ELL kernels
   launched, that the DQN's tensors are on the card and that the stores
   are consistent; the first label-RWR and BFS sweeps at a c other than
   the initial 64 are captured and held against the plain versions (SpMM
   to 1e-5 relative, reach bitwise);
10. round trips — the adaptive server's ``save``/``load`` into a fresh FULL
    server (equal graph, stores, c, bitwise-equal Q-values) and its
    ``save_policy``/``load_policy`` likewise;
11. serve-traced — a FULL Inc server with tracing on
    (``ServingConfig(adaptive=False, obs=ObsConfig(enabled=True))``)
    replays serve-inc's 4 batches with serve-inc's Louvain dendrogram
    handed over (no third host build): stores and ``ell_spmm``/
    ``ell_reach`` launch counts must equal serve-inc's; each step's
    ``stage_s`` is printed in ms beside its wall time (the stages should
    cover 90-110 % of a warm step; a step outside that is reported), and
    under ``--profile`` each warm step's device-to-host copies are
    attributed to the stage they fall in;
12. runtime — serve-inc's untraced server (``reset()`` between runs, its
    PEM state put back) serves the stream's 20 measured batches dealt into
    a seeded flash-crowd arrival process (1,000 events/s, 48 ticks of
    50 ms, 8x bursts for 4 of every 16 ticks, seed 0): under
    ``VirtualClock`` ``run_workload_sync`` and the lockstep
    ``ServingRuntime`` must give bitwise-equal stores and graphs (launch
    counters set to 0 before the lockstep run and read after), and a
    2-executor lockstep run the serial one's stores; under ``WallClock``
    ``run_workload_sync(ingest="open")`` and ``ServingRuntime(ingress=
    "shed")`` are run and their p50/p99 step and e2e latency, drops and
    step counts printed;
13. the CLI — ``python -m repro_torch.launch.serve --arch igpm-pem --steps 4
    --policy-dir <dir>`` run twice: the second run restores the policy the
    first saved;
14. serve-lm — qwen3-moe-30b-a3b ``FULL`` at its published widths with the
   depth cut from 48 to 8 layers, seeded random weights, a 2 × 4,096-token
   prompt: prefill and 15 greedy decode steps through
   ``repro_torch.launch.serve.greedy_generate``, counters set to 0 before
   and read after (flash 8 launches, all of the TMA + wgmma kernel; expert
   GEMM 24 of the tiles variant, 360 of the skinny one, none of the first
   kernel); then, with the MoE
   at a capacity that drops no slot, the prompt is served again and a
   prefill over it plus the 15 generated tokens must give the last decode
   step's logits; then serve-lm-configs — smollm-135m (30 of 30 layers),
   deepseek-7b (30 of 30), qwen2-72b (24 of 80) and dbrx-132b (8 of 40) at
   their published widths, seeded bf16 weights, each serving the same
   traffic with its counts set to 0 before and read after (flash: one
   launch per layer, all on the TMA + wgmma kernel, at hd 64 for smollm and
   hd 128 for the rest; dbrx's expert GEMM: tiles at prefill, skinny at
   decode, the first kernel none), then the prefill-versus-decode
   consistency check at a capacity that drops no slot (bf16), each model
   freed before the next; then train-lm — qwen3-moe-30b-a3b ``FULL`` widths, depth
   cut to 2 layers, f32 masters from a seed, 5 ``TrainLoop`` steps
   (``TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=5)``,
   2 microbatches, ``remat="full"``, MoE groups of 1,024 tokens) on
   ``TokenPipeline(151936, 2, 4096, seed=0)``, the final checkpoint under
   ``build/`` (deleted after): per step loss, grad norm, lr, time and
   tokens/s, the peak memory; finite losses, step 0 within 0.5 of ln V,
   the last below step 0's, and the launches counted exactly (per step
   and microbatch and layer: 2 flash forwards — the forward and its
   recompute — on the TMA + wgmma kernel, 1 flash backward on the TMA +
   wgmma backward kernel and none on the first one, 12 expert
   GEMMs of the tiles variant — 3 forward, 3 recompute, 6 backward), and
   the same 5 steps run again from the same seed without the loop (no
   checkpoint): losses and grad norms must be bitwise equal; then
   train-smollm — smollm-135m ``FULL`` at its whole depth (30 layers, tied
   embeddings, ``remat="dots"``), f32 masters, 5 ``TrainLoop`` steps of
   8 × 4,096 tokens in 2 microbatches on ``TokenPipeline(49152, 8, 4096,
   seed=0)``: per step loss, grad norm, step time and tokens/s, the peak
   memory; the loss must fall, every flash launch must be on the TMA +
   wgmma kernels (2 forwards — the forward and the dots recompute — and 1
   backward per step, microbatch and layer), and one more step's
   gradients under ``"dots"`` and under ``"none"`` must be bitwise equal;
15. control (run after phase 12, on serve-adaptive's server, ``rwr_tol``
    set to 1e-4 so all seven actions are live; reset between runs, its
    PEM state put back, its PEM reward fed one seeded elapsed schedule
    under ``VirtualClock``, so no further Louvain build): the stream's
    batches dealt into the reference control bench's closed-loop flash
    crowd (350 events/s, 20 ticks of 300 ms, 5x bursts for 2 of every 10
    ticks, seed 11, lag reference and ack SLO 0.5 s); 2 training episodes
    under ``VirtualClock`` and ``sim_service_model()`` (decisions, TD
    losses, knobs and sweeps per step printed), two frozen replays that
    must give equal histories and stores and no loss, an ``Engine.save``/
    ``load`` round trip of the attached controller (Q-values bitwise, knob
    indices equal), the frozen policy in ``ServingRuntime(ingress="shed")``
    under ``WallClock`` (closed-loop summary, decisions, knobs, p50/p99 of
    the ``on_batch`` hook and of its Q-value pass, the pass run on the
    current stream and on a stream of its own in turn, step and e2e
    latency), launch counters set to 0
    before training and read after the wall-clock run (both ELL kernels
    must launch); then a traced frozen replay prints each step's sweeps
    beside ``stage_s["rwr"]``.

Then a ``{"kernels": [...]}`` JSON line (every kernel with its serve and
train launches, both flash backward kernels among them), the card line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line. ``--profile`` adds a device-time profile of one step of each
served path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SPMM_RTOL = 1e-5
# bf16 kernels against their plain versions: rtol as tests/test_kernels.py,
# atol per kernel. The expert GEMM's outputs are O(1): atol 2e-2. A causal
# flash row i averages i + 1 values of N(0, 1) v, so its outputs shrink to
# |o| ~ 0.03 in the late rows, and the kernel rounds P to bf16 before P·V,
# an error that scales with the row, not with each element: its atol is
# LM_KERNEL_RTOL times the RMS of that output row in the plain version.
LM_KERNEL_RTOL = 2e-2
LM_GEMM_ATOL = 2e-2
# the first GEMM kernel in f32 against an f32 einsum: rtol and atol, for
# sums over d = 2,048 in another order (outputs O(1))
LM_GEMM32_TOL = 1e-4
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
# train-lm: qwen3-moe-30b-a3b at full widths, depth cut to 2 layers, the
# train_4k shape's sequence with its global batch cut from 256 to 2, two
# microbatches of one sequence, MoE groups of 1,024 tokens (the reference's
# cells rule min(4096, max(64, B·S // 8)) at B·S = 8,192), 5 steps
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 2, 4096, 2, 5
TRAIN_GROUP = min(4096, max(64, TRAIN_BATCH * TRAIN_SEQ // 8))
TRAIN_LOSS_BAND = 0.5  # step-0 loss within this of ln(vocab)
# serve-lm-configs: the other LM configs at their published widths, each
# serving serve-lm's traffic; depth cut where the bf16 weights would not
# leave room on the card (qwen2-72b 1.76 GB a layer, dbrx-132b 6.52 GB)
SERVE_CONFIGS = (("smollm-135m", 30), ("deepseek-7b", 30), ("qwen2-72b", 24),
                 ("dbrx-132b", 8))
# train-smollm: smollm-135m FULL (30 of 30 layers, tied embeddings,
# remat "dots"), the train_4k shape's sequence with its global batch cut
# from 256 to 8, two microbatches of four sequences, 5 steps
SMOL_BATCH, SMOL_MICRO, SMOL_STEPS = 8, 2, 5
# train-agreement: card against CPU, 3 steps of 2 microbatches
AGREE_STEPS = 3
AGREE_LOSS_RTOL = 1e-4
# step-0 gradients, card against CPU: rtol plus this share of the leaf's
# largest entry (f32 sums in another order through routing and softmax,
# the tolerance tests/test_torch_train.py holds the port to against JAX)
AGREE_GRAD_RTOL, AGREE_GRAD_FLOOR = 1e-4, 1e-5
# LSE of the forward kernels against a plain logsumexp (f32 statistics)
LSE_RTOL, LSE_ATOL = 1e-5, 1e-4
REPS = 20          # timed launches per kernel measurement
INC_STEPS = 4      # serve-inc steps
BATCH_STEPS = 2    # serve-batch steps
# serve-adaptive steps: transitions reach the replay ring from step 1 on, so
# the ring holds replay_batch = 16 at step 16 and steps 16-19 learn
ADAPT_STEPS = 20
LOSS_RTOL = 1e-5   # TD losses, card against CPU (adaptive agreement)


class SmokeFailure(RuntimeError):
    pass


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# -- phase 2: kernels against their plain versions -----------------------------

def spmm_bound(mask, x, n: int, with_vals: bool, cols=None):
    """Least card time for the function on these inputs: each input byte
    it needs read once, each output byte written once — the whole mask,
    the row ids, the column id (and weight) of every live entry, the rows
    of x it reads (all of x, or with ``cols`` the distinct live columns:
    one shard's row block reads only those) — against its flops (2·nnz·d
    for the SpMM, nnz·d compares for the reach) at the fp32 peak."""
    from repro_torch.kernels.measure import H100_BYTES_PER_S, H100_F32_FLOPS
    r, k = mask.shape
    nnz = int(mask.sum())
    d = x.shape[1]
    x_rows = (x.shape[0] if cols is None
              else int(cols[mask].unique().numel()))
    nbytes = (r * k + r * 4 + nnz * (8 if with_vals else 4)
              + x_rows * d * 4 + n * d * 4)
    ops = (2 if with_vals else 1) * nnz * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops


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
    variant = ops.ell_variant(x.shape[1], x.data_ptr())
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
    from repro_torch.kernels.measure import cuda_ms, gather_floor, random_ell
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
        r_variant = ops.ell_variant(d, xb.data_ptr())
        say(f"  d={d} ell_reach ({r_variant}): {r_ms:.4f} ms, plain "
            f"{r_plain:.4f} ms, bound {r_bound:.4f} ms ({r_by}: {r_bytes} "
            f"B, {r_ops} op), gather floor {s_floor:.4f} ms")
        rows[("ell_spmm", d)] = dict(ms=s_ms, plain_ms=s_plain,
                                     library_ms=s_lib, bound_ms=s_bound,
                                     bound_by=s_by, bytes=s_bytes,
                                     gather_floor_ms=s_floor,
                                     variant=ops.ell_variant(
                                         d, x.data_ptr()),
                                     max_abs_err=s_abs, max_rel_err=s_rel)
        rows[("ell_reach", d)] = dict(ms=r_ms, plain_ms=r_plain,
                                      library_ms=None, bound_ms=r_bound,
                                      bound_by=r_by, bytes=r_bytes,
                                      gather_floor_ms=s_floor,
                                      variant=r_variant, max_abs_err=r_abs)
        del x, xb
    torch.cuda.synchronize()
    return rows


# -- phase 3: the LM kernels against their plain versions -----------------------

def bound(nbytes: int, flops: int, peak_flops: float):
    """Least card time: the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    from repro_torch.kernels.measure import H100_BYTES_PER_S
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


def lm_check(name: str, got, again, want, atol, rtol=LM_KERNEL_RTOL):
    """Max abs error, and the largest share of its allowance ``atol +
    rtol·|want|`` that any element uses (≤ 1 passes); ``atol`` is a number
    or a tensor that broadcasts against ``want``."""
    import torch
    check(bool(torch.equal(got, again)), f"{name}: two launches differ")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    diff = (g - w).abs()
    abs_err = float(diff.max())
    used = float((diff / (atol + rtol * w.abs())).max())
    check(used <= 1.0, f"{name}: outside its tolerance (max abs error "
                       f"{abs_err:.3e}, {used:.2f} of the allowance)")
    return abs_err, used


def flash_fwd_row(name: str, label: str, q, k, v, reps: int) -> dict:
    """One flash forward call held against the plain version (taken by
    kernel ``name``, two launches bitwise equal, within ``row_atol``),
    timed beside ``scaled_dot_product_attention``, with its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.measure import H100_BF16_FLOPS, cuda_ms
    B, S, H, hd = q.shape
    KV = k.shape[2]
    before = dict(flash_ops.LAUNCHES)
    o = flash_ops.flash_attention(q, k, v)
    check(flash_ops.LAUNCHES[name] == before[name] + 1,
          f"flash_attention {label}: not taken by {name} "
          f"({flash_ops.LAUNCHES})")
    o2 = flash_ops.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    err, used = lm_check(f"{name} {label}", o, o2, want, row_atol(want))
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
    del o
    return dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, flops=flops, max_abs_err=err,
        tol_used=used, late_max_abs_err=late_err, late_rms=late_rms,
        shape=f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal")


def gemm_row(name: str, label: str, x, w, reps: int) -> dict:
    """One expert GEMM call (G·E, C, d) × (E, d, f) held against the plain
    version (taken by kernel ``name``, two launches bitwise equal), timed
    beside batched ``torch.matmul``, with its bound."""
    import torch
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.expert_gemm.ref import expert_gemm_ref
    from repro_torch.kernels.measure import (H100_BF16_FLOPS, H100_F32_FLOPS,
                                             cuda_ms)
    N, C, depth = x.shape
    E = w.shape[0]
    G = N // E
    before = dict(gemm_ops.LAUNCHES)
    y = gemm_ops.expert_gemm(x, w)
    check(gemm_ops.LAUNCHES[name] == before[name] + 1,
          f"expert_gemm {label}: not taken by {name} "
          f"({gemm_ops.LAUNCHES})")
    y2 = gemm_ops.expert_gemm(x, w)
    f32 = w.dtype == torch.float32
    err, used = lm_check(f"{name} {label}", y, y2, expert_gemm_ref(x, w),
                         LM_GEMM32_TOL if f32 else LM_GEMM_ATOL,
                         rtol=LM_GEMM32_TOL if f32 else LM_KERNEL_RTOL)
    del y2
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: gemm_ops.expert_gemm(x, w), reps)
    plain = cuda_ms(lambda: expert_gemm_ref(x, w), 3, warmup=1)
    torch.cuda.empty_cache()
    x4 = x.view(G, E, C, depth)
    lib = cuda_ms(lambda: torch.matmul(x4, w), reps)
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, y))
    flops = 2 * G * E * C * depth * w.shape[2]
    b_ms, b_by = bound(nbytes, flops,
                       H100_F32_FLOPS if f32 else H100_BF16_FLOPS)
    dt = "f32" if f32 else "bf16"
    say(f"  {name} {label}: x {tuple(x.shape)} w {tuple(w.shape)}"
        f" {dt}: max_abs_err={err:.3e} ({used:.3f} of the allowance) "
        f"run-to-run bitwise equal; "
        f"{ms:.4f} ms, plain {plain:.4f} ms, torch.matmul {lib:.4f} ms,"
        f" bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)")
    del y
    torch.cuda.empty_cache()
    return dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, flops=flops, max_abs_err=err,
        tol_used=used, shape=f"x {tuple(x.shape)} w {tuple(w.shape)} {dt}")


def phase_lm_kernels(reps: int):
    import torch
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
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
        rows[(name, label)] = flash_fwd_row(name, label, q, k, v, reps)
        del q, k, v
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
    # bf16 goes to the TMA + wgmma source: its tiles variant at prefill,
    # its skinny variant at decode; f32 (the SMOKE configs) and bf16 that
    # TMA cannot address (here x 2 bytes off a 16-byte boundary: `shift`
    # elements) only the first kernel takes. f32 sums are held to
    # LM_GEMM32_TOL against an f32 einsum in full f32 (set here: TF32
    # would lose those digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, G, C, w, name, shift in (
            ("prefill gate", LM_BATCH, c_pre, w_gate, gemm_ops.TILES, 0),
            ("prefill up", LM_BATCH, c_pre, w_up, gemm_ops.TILES, 0),
            ("prefill down", LM_BATCH, c_pre, w_down, gemm_ops.TILES, 0),
            ("decode gate", 1, c_dec, w_gate, gemm_ops.SKINNY, 0),
            ("decode down", 1, c_dec, w_down, gemm_ops.SKINNY, 0),
            ("decode gate f32", 1, c_dec, w_gate.float(), gemm_ops.FIRST, 0),
            ("decode gate bf16 misaligned", 1, c_dec, w_gate, gemm_ops.FIRST,
             1)):
        depth = w.shape[1]
        x = randn(G * E * C * depth + shift).to(w.dtype)[shift:].view(
            G * E, C, depth)
        check(x.data_ptr() % 16 == shift * x.element_size(),
              f"expert_gemm {label}: x at {x.data_ptr() % 16} bytes past a "
              f"16-byte boundary, want {shift * x.element_size()}")
        rows[(name, label)] = gemm_row(name, label, x, w, reps)
        del x
        if w.dtype == torch.float32:
            del w
    del w_gate, w_up, w_down
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


# -- phase 3b: the LM kernels' training side ---------------------------------------

def grad_allowance_used(got, want, share):
    """The largest share of its allowance any element of ``got`` uses:
    ``share`` of the element plus its row's RMS, plus 1e-4 of the tensor's
    RMS for rows that cancel to zero
    (tests/test_torch_kernels.py::_grad_allowance_used)."""
    g, w = got.float(), want.float()
    allow = (share * (w.abs() + w.pow(2).mean(-1, keepdim=True).sqrt())
             + 1e-4 * w.pow(2).mean().sqrt())
    return float(((g - w).abs() / allow).max())


def flash_bwd_row(name: str, label: str, q, k, v, do, reps: int) -> dict:
    """One flash backward call (from the forward kernel's O and
    log-sum-exp) held against ``flash_attention_bwd_ref`` (taken by kernel
    ``name``, two launches bitwise equal, within ``grad_allowance_used``),
    timed beside SDPA's backward through autograd, with its bound and, for
    the TMA kernel, its two-pass floor."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    from repro_torch.kernels.measure import (H100_BF16_FLOPS, H100_F32_FLOPS,
                                             cuda_ms)
    bf = torch.bfloat16
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dt = q.dtype
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)

    def bwd():
        return flash_ops.flash_attention_bwd(q, k, v, o, do, lse)
    before = dict(flash_ops.LAUNCHES)
    got = bwd()
    check(flash_ops.LAUNCHES[name] == before[name] + 1
          and sum(flash_ops.LAUNCHES.values())
          == sum(before.values()) + 1,
          f"flash bwd {label}: not taken by {name}")
    again = bwd()
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"flash bwd {label}: two launches differ")
    want = flash_attention_bwd_ref(q, k, v, o, do, lse)
    share = LM_KERNEL_RTOL if dt == bf else LM_GEMM32_TOL
    errs = {n: float((g.float() - w.float()).abs().max())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    used_by = {n: grad_allowance_used(g, w, share)
               for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    used = max(used_by.values())
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          f"flash bwd {label}: non-finite gradient")
    check(used <= 1.0, f"flash bwd {label}: {used_by} of the "
                       f"allowance ({errs})")
    del again, want
    torch.cuda.empty_cache()
    ms = cuda_ms(bwd, reps)
    plain = cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, o, do, lse),
                    3, warmup=1)
    torch.cuda.empty_cache()
    # the yardstick: SDPA's backward through autograd, same inputs
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         enable_gqa=True)
    dos = do.transpose(1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                              retain_graph=True), reps)
    del out, qs, ks, vs
    nbytes = sum(t.numel() * t.element_size()
                 for t in (q, k, v, o, do, lse, *got))
    pairs = B * causal_pairs(S, S)
    flops = 10 * H * hd * pairs
    peak = H100_BF16_FLOPS if dt == bf else H100_F32_FLOPS
    b_ms, b_by = bound(nbytes, flops, peak)
    tag = "bf16" if dt == bf else "f32"
    # the TMA kernel's two passes recompute S and dP: 7 products
    wgmma = name == flash_ops.BWD_WGMMA
    floor = 14 * H * hd * pairs / peak * 1e3 if wgmma else None
    say(f"  {name} {label}: q {tuple(q.shape)} k,v "
        f"{tuple(k.shape)} {tag}: max_abs_err dq/dk/dv "
        f"{errs['dq']:.3e}/{errs['dk']:.3e}/{errs['dv']:.3e} ({used:.3f}"
        f" of the allowance), run-to-run bitwise equal; {ms:.4f} ms "
        f"(D = rowsum(dO·O) {'in the kernel' if wgmma else 'in torch'}"
        f"), plain {plain:.4f} ms, sdpa backward {lib:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {flops} flop)"
        + (f", two-pass floor {floor:.4f} ms" if wgmma else ""))
    del o, lse, got
    return dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, flops=flops, floor_ms=floor,
        max_abs_err=max(errs.values()), tol_used=used,
        shape=f"B={B} S={S} H={H} KV={KV} hd={hd} {tag} causal")


def phase_train_kernels(reps: int):
    """The forward kernels' log-sum-exp, the flash backward kernel and the
    expert GEMM's backward products against their plain versions, timed,
    at the train-lm shapes."""
    import torch
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.expert_gemm.ref import expert_gemm_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.measure import H100_BF16_FLOPS, cuda_ms
    from repro_torch.models.moe import moe_capacity
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    H, KV = FULL.n_heads, FULL.n_kv_heads
    rows = {}

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    # the log-sum-exp output: O bitwise unchanged, LSE a row's logsumexp
    for label, B, S, hd, dt, name in (
            ("prefill", LM_BATCH, LM_PROMPT, FULL.head_dim, bf,
             flash_ops.WGMMA),
            ("hd40", LM_BATCH, LM_PROMPT, 40, bf, flash_ops.FIRST),
            ("f32 hd16", 1, TRAIN_SEQ, 16, f32, flash_ops.FIRST)):
        q = randn(B, S, H, hd, dtype=dt)
        k, v = randn(B, S, KV, hd, dtype=dt), randn(B, S, KV, hd, dtype=dt)
        before = dict(flash_ops.LAUNCHES)
        o = flash_ops.flash_attention(q, k, v)
        o2, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
        check(flash_ops.LAUNCHES[name] == before[name] + 2,
              f"flash lse {label}: not taken by {name}")
        check(bool(torch.equal(o, o2)),
              f"flash lse {label}: O changed when LSE was requested")
        _, want = flash_attention_ref(q, k, v, return_lse=True)
        err = float((lse - want).abs().max())
        used = float(((lse - want).abs()
                      / (LSE_ATOL + LSE_RTOL * want.abs())).max())
        say(f"  {name} {label} lse: O bitwise equal with and without it; "
            f"LSE max_abs_err={err:.3e} ({used:.3f} of the allowance)")
        check(used <= 1.0, f"flash lse {label}: LSE off its plain version")
        rows[("lse", label)] = dict(max_abs_err=err, tol_used=used,
                                    o_bitwise=True)
        del q, k, v, o, o2, lse, want
        torch.cuda.empty_cache()

    # the flash backward: the train shape (one sequence of the train
    # microbatch) and a ragged S on the TMA + wgmma kernel, then a head dim
    # and the f32 path (the SMOKE head dim) that only the first one takes
    for label, S, hd, dt, name in (
            ("train", TRAIN_SEQ, FULL.head_dim, bf, flash_ops.BWD_WGMMA),
            ("ragged", TRAIN_SEQ + 15, FULL.head_dim, bf,
             flash_ops.BWD_WGMMA),
            ("hd40", TRAIN_SEQ, 40, bf, flash_ops.BWD),
            ("f32 hd16", TRAIN_SEQ, 16, f32, flash_ops.BWD)):
        q, do = randn(1, S, H, hd, dtype=dt), randn(1, S, H, hd, dtype=dt)
        k, v = randn(1, S, KV, hd, dtype=dt), randn(1, S, KV, hd, dtype=dt)
        rows[(name, label)] = flash_bwd_row(name, label, q, k, v, do, reps)
        del q, k, v, do
        torch.cuda.empty_cache()

    # the expert GEMM's backward products at the train shapes: groups of
    # TRAIN_GROUP tokens of one microbatch, capacity 88
    moe = FULL.moe
    E, d, f = moe.n_experts, FULL.d_model, moe.d_ff_expert
    G = TRAIN_SEQ // TRAIN_GROUP
    C = moe_capacity(TRAIN_GROUP, E, moe.top_k)
    s_in = (2.0 / (d + f)) ** 0.5
    for label, din, dout in (("gate", d, f), ("down", f, d)):
        x = randn(G * E, C, din)
        w = randn(E, din, dout, scale=s_in)
        dy = randn(G * E, C, dout, scale=(G * C) ** -0.5)
        t_w = cuda_ms(lambda: w.transpose(1, 2).contiguous(), reps)
        t_xy = cuda_ms(lambda: (
            x.view(G, E, C, din).permute(1, 3, 0, 2).reshape(E, din, G * C),
            dy.view(G, E, C, dout).transpose(0, 1).reshape(E, G * C, dout)),
            reps)
        wt = w.transpose(1, 2).contiguous()
        xt = x.view(G, E, C, din).permute(1, 3, 0, 2).reshape(E, din, G * C)
        dyt = dy.view(G, E, C, dout).transpose(0, 1).reshape(E, G * C, dout)
        for prod, a, b, lib_a in (("dX", dy, wt, dy.view(G, E, C, dout)),
                                  ("dW", xt, dyt, xt)):
            before = dict(gemm_ops.LAUNCHES)
            y = gemm_ops.expert_gemm(a, b)
            check(gemm_ops.LAUNCHES[gemm_ops.TILES]
                  == before[gemm_ops.TILES] + 1,
                  f"expert_gemm train {label} {prod}: not the tiles variant")
            want = expert_gemm_ref(a, b)
            atol = LM_KERNEL_RTOL * float(want.float().pow(2).mean().sqrt())
            err, used = lm_check(f"expert_gemm train {label} {prod}", y,
                                 gemm_ops.expert_gemm(a, b), want, atol)
            ms = cuda_ms(lambda: gemm_ops.expert_gemm(a, b), reps)
            plain = cuda_ms(lambda: expert_gemm_ref(a, b), 3, warmup=1)
            lib = cuda_ms(lambda: torch.matmul(lib_a, b), reps)
            nbytes = sum(t.numel() * t.element_size() for t in (a, b, y))
            flops = 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
            b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
            say(f"  expert_gemm_wgmma train {label} {prod}: "
                f"{tuple(a.shape)} x {tuple(b.shape)} bf16: max_abs_err="
                f"{err:.3e} ({used:.3f} of the allowance) run-to-run bitwise"
                f" equal; {ms:.4f} ms, plain {plain:.4f} ms, torch.matmul "
                f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
                f"{flops} flop)")
            rows[(gemm_ops.TILES, f"train {label} {prod}")] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, flops=flops, max_abs_err=err,
                tol_used=used, shape=f"{tuple(a.shape)} x {tuple(b.shape)} "
                                     f"bf16")
            del y, want
        say(f"  expert GEMM backward transposes (plain torch), train "
            f"{label}: W^T {t_w:.4f} ms, X and dY for dW {t_xy:.4f} ms")
        rows[("gemm transposes", label)] = dict(w_ms=t_w, x_dy_ms=t_xy)
        del x, w, dy, wt, xt, dyt
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows


def phase_config_kernels(reps: int):
    """The flash forward and backward and the expert GEMM at the shapes the
    other LM configs give them, against their plain versions, timed: flash
    forward at train-smollm's microbatch (hd 64, G 3) and deepseek-7b's
    prefill (hd 128, G 1); the backward at train-smollm's microbatch and at
    G 1 (deepseek-7b) and G 6 (dbrx-132b); dbrx-132b's three expert
    products at prefill (2 groups of 4,096 tokens, C 1,288: tiles) and at
    decode (2 tokens, C 8: skinny)."""
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.moe import moe_capacity
    gen = torch.Generator(device="cuda").manual_seed(4)
    smol, deep, dbrx = (get_arch(a).model for a in
                        ("smollm-135m", "deepseek-7b", "dbrx-132b"))
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def heads(B, cfg):
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        return ((B, TRAIN_SEQ, H, hd), (B, TRAIN_SEQ, KV, hd),
                (B, TRAIN_SEQ, KV, hd))

    micro = SMOL_BATCH // SMOL_MICRO
    for label, B, cfg in (("smollm train", micro, smol),
                          ("deepseek prefill", LM_BATCH, deep)):
        q, k, v = (randn(*sh) for sh in heads(B, cfg))
        rows[(flash_ops.WGMMA, label)] = flash_fwd_row(
            flash_ops.WGMMA, label, q, k, v, reps)
        del q, k, v
        torch.cuda.empty_cache()
    for label, B, cfg in (("smollm train", micro, smol),
                          ("deepseek G1", 1, deep), ("dbrx G6", 1, dbrx)):
        q, k, v = (randn(*sh) for sh in heads(B, cfg))
        do = randn(*q.shape)
        rows[(flash_ops.BWD_WGMMA, label)] = flash_bwd_row(
            flash_ops.BWD_WGMMA, label, q, k, v, do, reps)
        del q, k, v, do
        torch.cuda.empty_cache()

    moe = dbrx.moe
    E, d, f = moe.n_experts, dbrx.d_model, moe.d_ff_expert
    c_pre = moe_capacity(LM_PROMPT, E, moe.top_k)
    c_dec = moe_capacity(LM_BATCH, E, moe.top_k)
    s_in = (2.0 / (d + f)) ** 0.5
    for prod, din, dout in (("gate", d, f), ("up", d, f), ("down", f, d)):
        w = randn(E, din, dout, scale=s_in)
        for phase, G, C, name in (("prefill", LM_BATCH, c_pre,
                                   gemm_ops.TILES),
                                  ("decode", 1, c_dec, gemm_ops.SKINNY)):
            x = randn(G * E, C, din)
            label = f"dbrx {phase} {prod}"
            rows[(name, label)] = gemm_row(name, label, x, w, reps)
            del x
        del w
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
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


# -- phase 6: LM agreement, card against CPU ------------------------------------

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
    prompt = torch.randint(0, SMOKE.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    reset_all_counts()
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_to(params, dev)
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


# -- phase 14: serve-lm ---------------------------------------------------------

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
    # 3 GEMMs per layer: the prefill's take the tiles variant, each decode
    # step's the skinny one, the first kernel none
    want_gemm = {"expert_gemm_wgmma": 3 * LM_LAYERS,
                 "expert_gemm_skinny": 3 * LM_LAYERS * (LM_TOKENS - 1),
                 "expert_gemm": 0}
    got_gemm = {k: launches[k] for k in want_gemm}
    check(got_gemm == want_gemm,
          f"serve-lm: expert GEMM launches {got_gemm}, want {want_gemm}")
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


def phase_serve_lm_configs():
    """smollm-135m, deepseek-7b, qwen2-72b and dbrx-132b at their published
    widths (``SERVE_CONFIGS``: depth cut where the bf16 weights would not
    fit), seeded weights, each serving serve-lm's traffic through
    ``greedy_generate`` with the counts set to 0 before and read after,
    then the prefill-versus-decode consistency check at a capacity that
    drops no MoE slot. Each model is freed before the next is built."""
    import dataclasses
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.transformer import TransformerLM
    out, total = {}, {}
    for arch_id, depth in SERVE_CONFIGS:
        full = get_arch(arch_id).model
        cfg = dataclasses.replace(full, n_layers=depth)
        model = TransformerLM(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        # param_count leaves out the QKV biases
        n_bias = (depth * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                  if cfg.qkv_bias else 0)
        check(n_params == cfg.param_count() + n_bias,
              f"serve-lm-configs {arch_id}: {n_params} parameters, want "
              f"param_count {cfg.param_count()} + {n_bias} QKV biases")
        moe = cfg.moe
        mlp = (f"{moe.n_experts} experts top-{moe.top_k}, d_ff "
               f"{moe.d_ff_expert}" if moe else f"d_ff {cfg.d_ff}")
        reduced = (f"n_layers {depth} of {full.n_layers}"
                   if depth < full.n_layers else "none (whole depth)")
        say(f"  {arch_id}: published widths (d_model {cfg.d_model}, "
            f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, hd {cfg.head_dim}, "
            f"{mlp}, vocab {cfg.vocab_size}, qkv_bias {cfg.qkv_bias}, tied "
            f"embeddings {cfg.tie_embeddings}); reduced: {reduced}; "
            f"{n_params} params bf16 (param_count {cfg.param_count()} + "
            f"{n_bias} QKV biases), init {init_s:.2f} s")
        prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                               generator=torch.Generator(device="cuda")
                               .manual_seed(1), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        gen = greedy_generate(model, params, prompt, LM_TOKENS)
        launches = read_all_counts()
        peak = torch.cuda.max_memory_allocated()
        n_dec = LM_BATCH * (LM_TOKENS - 1)
        decode_ms = gen.decode_s / (LM_TOKENS - 1) * 1e3
        say(f"  {arch_id} prefill {LM_BATCH} x {LM_PROMPT}: "
            f"{gen.prefill_s:.3f} s ({LM_BATCH * LM_PROMPT / gen.prefill_s:.1f}"
            f" tok/s); {LM_TOKENS - 1} decode steps: {gen.decode_s:.3f} s "
            f"({n_dec / gen.decode_s:.2f} tok/s, {decode_ms:.2f} ms/step); "
            f"peak memory {peak} B")
        say(f"  {arch_id} launches: {launches}")
        # every attention of the prefill on the TMA + wgmma kernel, at the
        # config's head dim; decode attends in plain torch
        hd_want = 64 if arch_id == "smollm-135m" else 128
        want = {"flash_attention_fwd_wgmma": depth, "flash_attention_fwd": 0,
                "flash_attention_bwd_wgmma": 0, "flash_attention_bwd": 0,
                # the MoE's three products: tiles at prefill, skinny at
                # each decode step, the first kernel none
                "expert_gemm_wgmma": 3 * depth if moe else 0,
                "expert_gemm_skinny": (3 * depth * (LM_TOKENS - 1) if moe
                                       else 0),
                "expert_gemm": 0}
        got = {k: launches[k] for k in want}
        check(cfg.head_dim == hd_want and got == want,
              f"serve-lm-configs {arch_id}: hd {cfg.head_dim} (want "
              f"{hd_want}), launches {got}, want {want}")
        toks = gen.tokens
        check(toks.shape == (LM_BATCH, LM_TOKENS)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
              and bool(torch.isfinite(gen.logits.float()).all()),
              f"serve-lm-configs {arch_id}: tokens {tuple(toks.shape)} or "
              f"logits out of range")
        say(f"  {arch_id} greedy continuation (row 0): {toks[0].tolist()}")
        prefill_s, decode_s = gen.prefill_s, gen.decode_s
        del gen
        res = consistency(cfg, params, prompt, f"{arch_id} bf16")
        check(res["corr"] >= LM_CONSIST_CORR,
              f"serve-lm-configs {arch_id}: prefill/decode logits "
              f"correlation {res['corr']} < {LM_CONSIST_CORR}")
        check(res["max_abs"] <= LM_CONSIST_ATOL,
              f"serve-lm-configs {arch_id}: prefill/decode logits differ "
              f"by {res['max_abs']} > {LM_CONSIST_ATOL}")
        out[arch_id] = dict(n_layers=depth, n_layers_published=full.n_layers,
                            n_params=n_params, init_s=init_s,
                            prefill_s=prefill_s, decode_s=decode_s,
                            decode_ms_per_step=decode_ms, peak_bytes=peak,
                            launches=got, consistency_bf16=res)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del params, model, prompt
        torch.cuda.empty_cache()
    return total, out


# -- train phases ------------------------------------------------------------

def dense_smoke_cfg():
    """The dense SMOKE-sized LM of tests/test_torch_lm.py (SwiGLU MLP)."""
    from repro_torch.config.base import TransformerConfig
    return TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                             d_ff=128, vocab_size=128, dtype="float32",
                             remat="none")


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.detach().to(dev)


def phase_train_agreement():
    """The qwen3-moe SMOKE config (f32, hd 16: the first flash kernels and
    the first GEMM kernel) and the dense smoke config, trained for
    ``AGREE_STEPS`` steps of 2 microbatches on the card and on the CPU
    from one set of f32 weights and one batch stream: losses within
    ``AGREE_LOSS_RTOL``, step-0 gradients per leaf within
    ``AGREE_GRAD_RTOL`` plus ``AGREE_GRAD_FLOOR`` of the leaf's largest
    entry."""
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.qwen3_moe_30b_a3b import SMOKE
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.state import make_train_step, new_train_state
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    reset_all_counts()
    out = {}
    for name, cfg in (("qwen3-moe SMOKE", SMOKE),
                      ("dense smoke", dense_smoke_cfg())):
        model = TransformerLM(cfg)
        params = model.init(torch.Generator().manual_seed(0),
                            dtype=torch.float32)
        pipe = TokenPipeline(cfg.vocab_size, 4, 32, seed=0)
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_to(params, dev)
            toks, labels = (torch.as_tensor(a, device=dev)
                            for a in pipe.batch_at(0))
            for t in tree_leaves(p):
                t.requires_grad_(True)
            runs = []
            for _ in range(2 if dev == "cuda" else 1):
                model.loss(p, toks, labels).backward()
                runs.append([t.grad.detach().cpu() for t in tree_leaves(p)])
                for t in tree_leaves(p):
                    t.grad = None
            for t in tree_leaves(p):
                t.requires_grad_(False)
            grads = runs[0]
            if dev == "cuda":
                # two backward passes: every sum of the path, the MoE
                # dispatch gather's backward included, in a fixed order
                repeat = [i for i, (a, b) in enumerate(zip(*runs))
                          if not torch.equal(a, b)]
            step = make_train_step(model.loss, tcfg, microbatches=2)
            state = new_train_state(p)
            losses = []
            for i in range(AGREE_STEPS):
                batch = (torch.as_tensor(a, device=dev)
                         for a in pipe.batch_at(i))
                state, m = step(state, *batch)
                losses.append(float(m["loss"]))
            res[dev] = (grads, losses)
        (g_card, l_card), (g_cpu, l_cpu) = res["cuda"], res["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
        grad_err, grad_used = 0.0, 0.0
        for a, b in zip(g_card, g_cpu):
            diff = (a - b).abs()
            allow = (AGREE_GRAD_RTOL * b.abs()
                     + AGREE_GRAD_FLOOR * float(b.abs().max()) + 1e-30)
            grad_err = max(grad_err, float(diff.max()))
            grad_used = max(grad_used, float((diff / allow).max()))
        say(f"phase train-agreement: {name}, {AGREE_STEPS} steps of 2 "
            f"microbatches: losses card {[f'{x:.6f}' for x in l_card]} cpu "
            f"{[f'{x:.6f}' for x in l_cpu]} (largest relative difference "
            f"{loss_rel:.3e}); step-0 gradients, {len(g_card)} leaves: "
            f"largest difference {grad_err:.3e} ({grad_used:.3f} of the "
            f"allowance); two card backward passes bitwise equal: "
            f"{not repeat} (leaves that differ: {repeat})")
        check(loss_rel <= AGREE_LOSS_RTOL,
              f"train-agreement {name}: losses differ by {loss_rel:.3e}")
        check(grad_used <= 1.0,
              f"train-agreement {name}: step-0 gradients outside tolerance")
        check(not repeat, f"train-agreement {name}: two card backward "
                          f"passes differ in leaves {repeat}")
        out[name] = dict(losses_card=l_card, losses_cpu=l_cpu,
                         loss_max_rel=loss_rel, grad_max_abs=grad_err,
                         grad_tol_used=grad_used,
                         card_repeat_differs=repeat)
    counts = read_all_counts()
    say(f"  train-agreement card launches: {counts}")
    for name in ("flash_attention_fwd", "flash_attention_bwd", "expert_gemm"):
        check(counts[name] > 0,
              f"train-agreement: the card path never launched {name}")
    return out, counts


def phase_train_lm(profile: bool = False):
    """qwen3-moe-30b-a3b at its published widths, ``TRAIN_LAYERS`` layers,
    f32 masters from a seed, ``TRAIN_STEPS`` steps of ``TrainLoop`` on the
    synthetic ``TokenPipeline`` (2 × 4,096 tokens, 2 microbatches,
    ``remat="full"``), the final checkpoint under build/."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.state import make_train_step, new_train_state
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(FULL, n_layers=TRAIN_LAYERS)
    model = TransformerLM(cfg, moe_group_size=TRAIN_GROUP)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.float32)
    state = new_train_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == cfg.param_count(), "train-lm: parameter count")
    say(f"  train-lm model: qwen3-moe-30b-a3b FULL widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, hd "
        f"{cfg.head_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
        f"d_ff {cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}, remat "
        f"{cfg.remat}); reduced: n_layers {cfg.n_layers} of {FULL.n_layers},"
        f" train_4k's global batch 256 -> {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, {TRAIN_MICRO} microbatches, moe_group_size {TRAIN_GROUP};"
        f" {n_params} params, f32 masters + f32 grads, m, v "
        f"({16 * n_params} B); init {init_s:.2f} s")
    ckpt_dir = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=TRAIN_STEPS, checkpoint_dir=str(ckpt_dir),
                       keep_checkpoints=1)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    inner = make_train_step(model.loss, tcfg, microbatches=TRAIN_MICRO)
    record = []

    def step_fn(st, *batch):
        st, m = inner(st, *batch)
        record.append({k: float(v) for k, v in m.items()})
        return st, m

    loop = TrainLoop(step_fn, state, pipe.batch_at, tcfg, log_every=10 ** 9,
                     print_fn=say)
    check(loop.start_step == 0, "train-lm: a checkpoint was restored")
    reset_all_counts()
    t0 = time.perf_counter()
    metrics = loop.run()
    run_s = time.perf_counter() - t0
    launches = read_all_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (loss, dt, m) in enumerate(zip(metrics.losses, metrics.step_times,
                                          record)):
        say(f"  train-lm step {i}: loss {loss:.4f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3e} step {dt:.3f} s "
            f"({tokens / dt:.1f} tok/s)")
    ckpt_s = run_s - sum(metrics.step_times)
    n_ckpt = sum(p.stat().st_size for p in ckpt_dir.rglob("*") if p.is_file())
    say(f"  train-lm peak memory {peak} B; run {run_s:.2f} s, of it the "
        f"batches and the final checkpoint ({n_ckpt} B under build/) "
        f"{ckpt_s:.2f} s")
    say(f"  train-lm launches ({TRAIN_STEPS} steps): {launches}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = metrics.losses
    ln_v = math.log(cfg.vocab_size)
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train-lm: losses {losses}")
    check(abs(losses[0] - ln_v) <= TRAIN_LOSS_BAND,
          f"train-lm: step-0 loss {losses[0]:.4f} not within "
          f"{TRAIN_LOSS_BAND} of ln V = {ln_v:.4f}")
    check(losses[-1] < losses[0],
          f"train-lm: last loss {losses[-1]:.4f} not below step 0's "
          f"{losses[0]:.4f}")
    # per step and microbatch, each layer runs attention and the three
    # expert products forward, again in the remat recompute, and their
    # backward passes (one flash backward, two GEMMs per product)
    per = TRAIN_STEPS * TRAIN_MICRO * TRAIN_LAYERS
    want = {"flash_attention_fwd_wgmma": 2 * per,
            "flash_attention_bwd_wgmma": per, "flash_attention_bwd": 0,
            "flash_attention_fwd": 0, "expert_gemm_wgmma": 12 * per,
            "expert_gemm_skinny": 0, "expert_gemm": 0}
    got = {k: launches[k] for k in want}
    check(got == want, f"train-lm launches {got}, want {want}")
    parts = None
    if profile:  # after the counts were read
        parts = train_step_parts(model, loop, pipe)
    del loop, state, params
    torch.cuda.empty_cache()
    # the same steps again from the same seed, without the loop's
    # checkpoint: a card train step must repeat bit for bit
    state = new_train_state(model.init(
        torch.Generator(device="cuda").manual_seed(0), dtype=torch.float32))
    first = [(loss, m["grad_norm"]) for loss, m in zip(losses, record)]
    again = []
    for i in range(TRAIN_STEPS):
        state, m = inner(state, *(torch.as_tensor(a, device="cuda")
                                  for a in pipe.batch_at(i)))
        again.append((float(m["loss"]), float(m["grad_norm"])))
    del state
    torch.cuda.empty_cache()
    say(f"  train-lm again from seed 0 (no checkpoint): (loss, grad_norm) "
        f"per step {again}; bitwise equal to the first run: "
        f"{again == first}")
    check(again == first, f"train-lm: a second run from the same seed "
                          f"gave {again}, the first {first}")
    phase_s = time.perf_counter() - t_phase
    say(f"phase train-lm: {phase_s:.1f} s wall")
    return launches, dict(
        n_layers=cfg.n_layers, n_params=n_params, init_s=init_s,
        losses=losses, step_s=metrics.step_times,
        grad_norm=[m["grad_norm"] for m in record],
        lr=[m["lr"] for m in record],
        tokens_per_s=[tokens / dt for dt in metrics.step_times],
        peak_bytes=peak, run_s=run_s, checkpoint_and_batches_s=ckpt_s,
        checkpoint_bytes=n_ckpt, phase_s=phase_s, profile_parts=parts,
        repeat_bitwise=again == first)


def step_grads(model, params, batch, microbatches: int):
    """One train step's gradients: each microbatch's loss differentiated
    and accumulated in ``.grad`` in order, as ``make_train_step`` does."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    split = [torch.as_tensor(a, device="cuda")
             .reshape((microbatches, -1) + a.shape[1:]) for a in batch]
    for i in range(microbatches):
        model.loss(params, *(x[i] for x in split)).backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return grads


def phase_train_smollm():
    """smollm-135m ``FULL`` at its whole depth (30 layers, tied embeddings,
    ``remat="dots"``), f32 masters from a seed, ``SMOL_STEPS`` steps of
    ``TrainLoop`` on ``TokenPipeline`` (8 × 4,096 tokens in 2
    microbatches), the final checkpoint under build/ (deleted after); then
    one step's gradients under ``"dots"`` and under ``"none"``, which must
    be bitwise equal."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.smollm_135m import FULL as cfg
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.state import make_train_step, new_train_state
    t_phase = time.perf_counter()
    model = TransformerLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.float32)
    state = new_train_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == cfg.param_count(), "train-smollm: parameter count")
    say(f"  train-smollm model: smollm-135m FULL (n_layers {cfg.n_layers}, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, "
        f"hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings {cfg.tie_embeddings}, remat {cfg.remat}); reduced: "
        f"train_4k's global batch 256 -> {SMOL_BATCH} x {TRAIN_SEQ} tokens, "
        f"{SMOL_MICRO} microbatches; {n_params} params, f32 masters + f32 "
        f"grads, m, v ({16 * n_params} B); init {init_s:.2f} s")
    ckpt_dir = ROOT / "build" / "train_smollm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=SMOL_STEPS, checkpoint_dir=str(ckpt_dir),
                       keep_checkpoints=1)
    pipe = TokenPipeline(cfg.vocab_size, SMOL_BATCH, TRAIN_SEQ, seed=0)
    inner = make_train_step(model.loss, tcfg, microbatches=SMOL_MICRO)
    record = []

    def step_fn(st, *batch):
        st, m = inner(st, *batch)
        record.append({k: float(v) for k, v in m.items()})
        return st, m

    loop = TrainLoop(step_fn, state, pipe.batch_at, tcfg, log_every=10 ** 9,
                     print_fn=say)
    check(loop.start_step == 0, "train-smollm: a checkpoint was restored")
    reset_all_counts()
    t0 = time.perf_counter()
    metrics = loop.run()
    run_s = time.perf_counter() - t0
    launches = read_all_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = SMOL_BATCH * TRAIN_SEQ
    for i, (loss, dt, m) in enumerate(zip(metrics.losses, metrics.step_times,
                                          record)):
        say(f"  train-smollm step {i}: loss {loss:.4f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3e} step {dt:.3f} s "
            f"({tokens / dt:.1f} tok/s)")
    n_ckpt = sum(p.stat().st_size for p in ckpt_dir.rglob("*") if p.is_file())
    say(f"  train-smollm peak memory {peak} B; run {run_s:.2f} s, of it the "
        f"batches and the final checkpoint ({n_ckpt} B under build/) "
        f"{run_s - sum(metrics.step_times):.2f} s")
    say(f"  train-smollm launches ({SMOL_STEPS} steps): {launches}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = metrics.losses
    ln_v = math.log(cfg.vocab_size)
    check(len(losses) == SMOL_STEPS and all(map(math.isfinite, losses)),
          f"train-smollm: losses {losses}")
    check(abs(losses[0] - ln_v) <= TRAIN_LOSS_BAND,
          f"train-smollm: step-0 loss {losses[0]:.4f} not within "
          f"{TRAIN_LOSS_BAND} of ln V = {ln_v:.4f}")
    check(losses[-1] < losses[0],
          f"train-smollm: last loss {losses[-1]:.4f} not below step 0's "
          f"{losses[0]:.4f}")
    # per step, microbatch and layer: the flash forward twice (forward and
    # the dots recompute) and its backward once, all at hd 64 on the TMA +
    # wgmma kernels; a dense model runs no expert GEMM
    per = SMOL_STEPS * SMOL_MICRO * cfg.n_layers
    want = {"flash_attention_fwd_wgmma": 2 * per,
            "flash_attention_bwd_wgmma": per, "flash_attention_bwd": 0,
            "flash_attention_fwd": 0, "expert_gemm_wgmma": 0,
            "expert_gemm_skinny": 0, "expert_gemm": 0}
    got = {k: launches[k] for k in want}
    check(cfg.head_dim == 64 and got == want,
          f"train-smollm: hd {cfg.head_dim}, launches {got}, want {want}")
    # one more step's gradients from the trained state, under the
    # config's "dots" and under "none": the same bits
    batch = pipe.batch_at(SMOL_STEPS)
    t0 = time.perf_counter()
    grads = {remat: step_grads(
        TransformerLM(dataclasses.replace(cfg, remat=remat)),
        loop.state.params, batch, SMOL_MICRO) for remat in ("dots", "none")}
    differ = [i for i, (a, b) in enumerate(zip(grads["dots"], grads["none"]))
              if not torch.equal(a, b)]
    say(f"  train-smollm step gradients, remat dots against none: "
        f"{len(grads['dots'])} leaves, bitwise equal: {not differ} (leaves "
        f"that differ: {differ}; {time.perf_counter() - t0:.2f} s)")
    check(not differ, f"train-smollm: dots and none gradients differ in "
                      f"leaves {differ}")
    del grads, loop, state, params
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    say(f"phase train-smollm: {phase_s:.1f} s wall")
    return launches, dict(
        n_layers=cfg.n_layers, n_params=n_params, init_s=init_s,
        losses=losses, step_s=metrics.step_times,
        grad_norm=[m["grad_norm"] for m in record],
        lr=[m["lr"] for m in record],
        tokens_per_s=[tokens / dt for dt in metrics.step_times],
        peak_bytes=peak, run_s=run_s, checkpoint_bytes=n_ckpt,
        dots_equals_none=not differ, phase_s=phase_s)


def train_step_parts(model, loop, pipe):
    """One more train step under ``torch.profiler`` (device time by op),
    then the step's parts timed alone with CUDA events: one microbatch's
    forward (the loss, with remat's checkpoints), its forward + backward,
    and AdamW over all parameters (which moves the state on: run after
    the checks)."""
    import torch
    from repro_torch.kernels.measure import cuda_ms
    from repro_torch.optim.adamw import adamw_update, tree_leaves
    batch = [torch.as_tensor(a, device=loop.device)
             for a in pipe.batch_at(TRAIN_STEPS)]
    StepProfiler(True, "train-lm step").step(
        1, lambda: loop.step_fn(loop.state, *batch))
    state = loop.state
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    mb = [x[:TRAIN_BATCH // TRAIN_MICRO] for x in batch]
    fwd = cuda_ms(lambda: model.loss(state.params, *mb), 3, warmup=1)
    fwd_bwd = cuda_ms(lambda: model.loss(state.params, *mb).backward(), 3,
                      warmup=1)
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    opt = [state.opt]

    def adamw():
        opt[0] = adamw_update(grads, opt[0], state.params, 1e-9)[1]
    adam = cuda_ms(adamw, 3, warmup=1)
    del grads
    say(f"  train-lm step parts (CUDA events, one microbatch of "
        f"{TRAIN_SEQ} tokens): forward (loss, remat) {fwd:.1f} ms, forward "
        f"+ backward {fwd_bwd:.1f} ms; AdamW over all parameters "
        f"{adam:.1f} ms")
    return dict(forward_ms=fwd, forward_backward_ms=fwd_bwd, adamw_ms=adam)


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


# -- phases 7-8: the IGPM paths -------------------------------------------------

class Capture:
    """Wrap the ELL wrappers to keep copies of the first inputs of each
    kind in ``kinds`` that the served path hands them: the label-RWR sweep
    (d = n_labels), the expansion sweep (wider d) and the BFS frontier
    sweep."""

    KINDS = ("label_rwr", "expansion_rwr", "bfs")

    def __init__(self, ops, n_labels: int, kinds=KINDS):
        self.ops = ops
        self.n_labels = n_labels
        self.kinds = kinds
        self.inputs = {}
        # captures are taken only while ``armed``; ``where[kind]`` keeps the
        # ``tag`` that was set when each was taken
        self.armed = True
        self.tag = None
        self.where = {}
        self._spmm, self._reach = ops.ell_spmm, ops.ell_reach

    def _take(self, key, tensors, n) -> None:
        if self.armed and key in self.kinds and key not in self.inputs:
            self.inputs[key] = tuple(t.clone() for t in tensors) + (n,)
            self.where[key] = self.tag

    def __enter__(self):
        ops, cap = self.ops, self
        spmm, reach, n_labels = self._spmm, self._reach, self.n_labels

        def spy_spmm(cols, vals, mask, row_ids, x, n, index=None):
            key = "label_rwr" if x.shape[1] == n_labels else "expansion_rwr"
            cap._take(key, (cols, vals, mask, row_ids, x), n)
            return spmm(cols, vals, mask, row_ids, x, n, index=index)

        def spy_reach(cols, mask, row_ids, x, n, index=None):
            cap._take("bfs", (cols, mask, row_ids, x), n)
            return reach(cols, mask, row_ids, x, n, index=index)

        ops.ell_spmm, ops.ell_reach = spy_spmm, spy_reach
        return self

    def __exit__(self, *exc):
        self.ops.ell_spmm, self.ops.ell_reach = self._spmm, self._reach
        return False


# the port's kernels as the profiler names them (csrc/*.cu)
PORT_KERNELS = ("ell_spmm_rows", "ell_spmm_small", "ell_reach_rows",
                "ell_reach_small", "flash_fwd_wgmma", "flash_fwd_bf16",
                "flash_fwd_f32", "flash_bwd_pre", "flash_bwd_dkdv_wgmma",
                "flash_bwd_dq_wgmma", "flash_bwd_reduce",
                "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16",
                "flash_bwd_dkdv_f32", "flash_bwd_dq_f32", "gemm_tiles",
                "gemm_skinny", "expert_gemm_bf16", "expert_gemm_f32")


class StepProfiler:
    """With ``enabled``, record step 1 (the first warm step) under
    ``torch.profiler`` and report device time by op, the port's kernels
    summed by function, and the device busy share of that step's wall
    time. A no-op otherwise."""

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
        # the port's own kernels, summed by function over all instances
        port = {}
        for dev_us, count, key in rows:
            for name in PORT_KERNELS:
                if f"(anonymous namespace)::{name}<" in key or \
                        f"(anonymous namespace)::{name}(" in key:
                    ms, n = port.get(name, (0.0, 0))
                    port[name] = (ms + dev_us / 1e3, n + count)
        say("    port kernels: " + (", ".join(
            f"{name} {ms:.3f} ms ({n}x)" for name, (ms, n) in
            sorted(port.items(), key=lambda kv: -kv[1][0])) or "none"))
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
    return launches, per_step, cap.inputs, srv


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
    record = MeshRecord(eng)
    ops.reset_launch_counts()
    per_step = []
    prof = StepProfiler(profile, "serve-batch")
    with Capture(ops, FULL.n_labels, kinds=("bfs",)) as cap:
        for i, upd in enumerate(stream.updates[:n_steps]):
            t0 = time.perf_counter()
            state, out = prof.step(i, lambda: eng.step(state, upd))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            say(f"  serve-batch step {i}: {dt:.3f} s (pipeline "
                f"{out.elapsed:.3f} s) patterns={out.n_new_patterns} "
                f"rwr_sweeps={out.rwr_sweeps}")
            per_step.append(dict(step=i, s=dt, pipeline_s=out.elapsed,
                                 new_patterns=out.n_new_patterns))
            record.deltas.append(out.deltas)
    record.stores = {qid: dict(st._patterns) for qid, st in eng.stores.items()}
    launches = dict(ops.LAUNCHES)
    say(f"  serve-batch launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"serve-batch never launched {name}")
    check_results(out.deltas, "serve-batch")
    for qid, store in eng.stores.items():
        good = np.asarray([v[0] for v in store._patterns.values()])
        check(bool(np.isfinite(good).all()),
              f"serve-batch: non-finite goodness in {qid}")
    return launches, per_step, cap.inputs, record


# -- phase 8b: serve-sharded, serve-batch over the device mesh ------------

class MeshRecord:
    """Wrap an engine's ``_label_table`` and ``_merge`` (here, not in the
    package) to keep, on the card, every label-RWR table and every bucket's
    ``GRayResult`` (matched ids, goodness, hops, exact and valid flags) of
    each step; the steps' deltas and the final stores are added by the
    caller."""

    def __init__(self, eng):
        self.tables, self.results, self.deltas = [], [], []
        self.stores = {}
        label_table, merge = eng._label_table, eng._merge

        def recording_table(*args, **kw):
            r = label_table(*args, **kw)
            self.tables.append(r.clone())
            return r

        def recording_merge(results, *args, **kw):
            self.results.append({shape: tuple(t.clone() for t in res)
                                 for shape, res in results.items()})
            return merge(results, *args, **kw)

        eng._label_table, eng._merge = recording_table, recording_merge

    def mismatch(self, other) -> str:
        """'' when ``other`` holds the same bits, else what differs."""
        import torch
        if len(self.tables) != len(other.tables) or not all(
                torch.equal(a, b.to(a.device))
                for a, b in zip(self.tables, other.tables)):
            return "label-RWR tables"
        for i, (a, b) in enumerate(zip(self.results, other.results)):
            if a.keys() != b.keys():
                return f"step {i} buckets"
            for shape in a:
                for f, x, y in zip(("matched", "goodness", "hops", "exact",
                                    "valid"), a[shape], b[shape]):
                    if not torch.equal(x, y.to(x.device)):
                        return f"step {i} bucket {shape} {f}"
        if len(self.results) != len(other.results):
            return "step count"
        if self.deltas != other.deltas:
            return "deltas"
        if self.stores != other.stores:
            return "stores"
        return ""


SHARDED_RUNS = (
    ("graph", dict(shard="off", graph_shard="auto")),
    ("graph-partitioned", dict(shard="off", graph_shard="auto",
                               edge_partition="on")),
    ("mesh-2d", dict(shard="auto", graph_shard="auto")),
)


def smoke_mesh():
    """The mesh of serve-sharded: the visible cards where there are two or
    more, else the one card named four times (which checks the
    distribution and is no speedup)."""
    import torch
    n = torch.cuda.device_count()
    if n >= 2:
        return [f"cuda:{i}" for i in range(n)], "real cards"
    return ["cuda:0"] * 4, "cuda:0 x 4 (one card: a check, not a speedup)"


def phase_serve_sharded(stream, n_steps: int, batch_record, batch_steps,
                        reps: int):
    """serve-batch's engine (FULL, ``query_zoo(16)``, batch mode) over the
    device mesh in three layouts; each must equal serve-batch's run
    bitwise. Launch counters are set to 0 before each run and read after.
    Then both ELL kernels on row block 0 of the graph run's mirror against
    their plain versions."""
    import torch
    from repro_torch.config.base import EngineConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.engine import Engine
    from repro_torch.kernels.spmv_ell import ops
    mesh, kind = smoke_mesh()
    say(f"  mesh: {torch.cuda.device_count()} visible card(s); "
        f"devices {mesh} — {kind}")
    out = dict(mesh=mesh, mesh_kind=kind, runs={},
               replicated_step_s=[st["s"] for st in batch_steps])
    block_rows = None
    for name, knobs in SHARDED_RUNS:
        eng = Engine(FULL, EngineConfig(mode="batch", **knobs),
                     device="cuda", devices=mesh)
        for q in query_zoo(16):
            eng.register(q)
        record = MeshRecord(eng)
        state = eng.init_state(stream.graph)
        ops.reset_launch_counts()
        step_s = []
        for upd in stream.updates[:n_steps]:
            t0 = time.perf_counter()
            state, res = eng.step(state, upd)
            for dev in dict.fromkeys(mesh):
                torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t0)
            record.deltas.append(res.deltas)
        launches = dict(ops.LAUNCHES)
        record.stores = {qid: dict(st._patterns)
                         for qid, st in eng.stores.items()}
        cache = eng.ell_cache
        q_shards = {f"{k[0]}x{k[1]}": b.n_shards
                    for k, b in eng.buckets.items()}
        say(f"  serve-sharded {name}: g_shards={eng.g_shards} "
            f"q_budget={eng.q_budget} partitioned={eng.partitioned} "
            f"query shards per bucket {q_shards}; steps "
            f"{', '.join(f'{t:.3f} s' for t in step_s)} (warm step "
            f"{step_s[-1]:.3f} s against serve-batch's "
            f"{batch_steps[-1]['s']:.3f} s; {kind}); launches {launches}; "
            f"r_cap_block={cache.r_cap_block} rows, "
            f"{cache.block_nbytes()} B per shard "
            f"({cache.r_cap_block} x {FULL.ell_width} x 9 B), "
            f"occupancy {cache.occupancy():.4f}")
        for kname, count in launches.items():
            check(count > 0, f"serve-sharded {name} never launched {kname}")
        check(eng.g_shards > 1 or (name == "mesh-2d" and len(mesh) < 4),
              f"serve-sharded {name}: no graph axis")
        diff = batch_record.mismatch(record)
        check(diff == "", f"serve-sharded {name} differs from serve-batch "
                          f"in its {diff}")
        say(f"  serve-sharded {name}: bitwise equal to serve-batch (tables, "
            f"matched ids, goodness, hops, exact/valid, deltas, stores)")
        out["runs"][name] = dict(
            g_shards=eng.g_shards, q_budget=eng.q_budget,
            partitioned=eng.partitioned, query_shards=q_shards,
            step_s=step_s, launches=launches,
            r_cap_block=cache.r_cap_block,
            block_bytes=cache.block_nbytes(),
            occupancy=cache.occupancy())
        if name == "graph":
            block_rows = phase_block_kernels(cache.ell.blocks[0],
                                             FULL.n_max, reps)
        del eng, record, state, cache
        torch.cuda.empty_cache()
    return out, block_rows


def phase_block_kernels(block, n_x: int, reps: int):
    """Both ELL kernels on one shard's row block of the FULL mirror (n =
    n_loc < n_x, local row ids, global column ids) against their plain
    versions at d 4 and d 160, timed beside the plain versions, their
    bounds and (SpMM) ``torch.sparse.mm``."""
    import torch
    from repro_torch.kernels.measure import cuda_ms
    from repro_torch.kernels.spmv_ell import ref
    from repro_torch.kernels.spmv_ell import ops
    cols, vals, mask, row_ids, n = (block.cols, block.vals, block.mask,
                                    block.row_ids, block.n)
    index = block.row_index()
    say(f"phase kernels (row block 0 of the FULL mirror): R={cols.shape[0]} "
        f"K={cols.shape[1]} n_loc={n} n_x={n_x} nnz={int(mask.sum())}")
    csr = spmm_csr(cols, vals, mask, row_ids, n, n_x)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for d in (4, 160):
        x = torch.rand((n_x, d), device="cuda", generator=gen)
        xb = (torch.rand((n_x, d), device="cuda", generator=gen)
              < 0.1).to(torch.float32)
        s_abs, s_rel = compare_spmm(ops, ref, cols, vals, mask, row_ids, x,
                                    n, index, f"row block d={d}")
        r_abs = compare_reach(ops, ref, cols, mask, row_ids, xb, n, index,
                              f"row block d={d}")
        s_ms = cuda_ms(lambda: ops.ell_spmm(cols, vals, mask, row_ids, x, n,
                                            index=index), reps)
        r_ms = cuda_ms(lambda: ops.ell_reach(cols, mask, row_ids, xb, n,
                                             index=index), reps)
        s_plain = cuda_ms(lambda: ref.ell_spmm_ref(cols, vals, mask, row_ids,
                                                   x, n), 3, warmup=1)
        r_plain = cuda_ms(lambda: ref.ell_reach_ref(cols, mask, row_ids, xb,
                                                    n), 3, warmup=1)
        s_lib = cuda_ms(lambda: torch.sparse.mm(csr, x), reps)
        s_bound, s_by, _, _ = spmm_bound(mask, x, n, True, cols)
        r_bound, r_by, _, _ = spmm_bound(mask, xb, n, False, cols)
        say(f"  row block d={d}: ell_spmm {s_ms:.4f} ms (plain {s_plain:.4f}"
            f" ms, torch.sparse.mm {s_lib:.4f} ms, bound {s_bound:.4f} ms "
            f"{s_by}); ell_reach {r_ms:.4f} ms (plain {r_plain:.4f} ms, "
            f"bound {r_bound:.4f} ms {r_by})")
        rows[("ell_spmm", d)] = dict(ms=s_ms, plain_ms=s_plain,
                                     library_ms=s_lib, bound_ms=s_bound,
                                     bound_by=s_by, max_abs_err=s_abs,
                                     max_rel_err=s_rel)
        rows[("ell_reach", d)] = dict(ms=r_ms, plain_ms=r_plain,
                                      library_ms=None, bound_ms=r_bound,
                                      bound_by=r_by, max_abs_err=r_abs)
        del x, xb
    return rows


def check_captured(inputs):
    import torch
    from repro_torch.kernels.measure import cuda_ms, gather_floor
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
    out["bfs"] = time_captured_bfs(inputs["bfs"], "serve-inc")
    return out


def time_captured_bfs(inputs, path: str):
    """Hold ``ell_reach`` bitwise against its plain version on a captured
    BFS sweep, and time it beside its bound and gather floor."""
    from repro_torch.kernels.measure import cuda_ms, gather_floor
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    cols, mask, row_ids, x, n = inputs
    index = build_row_index(mask, row_ids, n)
    abs_err = compare_reach(ops, ref, cols, mask, row_ids, x, n, index,
                            f"captured {path} bfs")
    ms = cuda_ms(lambda: ops.ell_reach(cols, mask, row_ids, x, n,
                                       index=index), REPS)
    b_ms, b_by, nbytes, _ = spmm_bound(mask, x, n, False)
    d = x.shape[1]
    floor = gather_floor(mask, d)
    variant = ops.ell_variant(d, x.data_ptr())
    say(f"  ell_reach captured {path} bfs ({variant}): nnz={int(mask.sum())}"
        f" n={n} d={d} {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} "
        f"B), gather floor {floor:.4f} ms")
    return dict(max_abs_err=abs_err, ms=ms, bound_ms=b_ms, bound_by=b_by,
                gather_floor_ms=floor, variant=variant, nnz=int(mask.sum()),
                R=cols.shape[0], n=n, d=d)


# -- phase 9: serve-adaptive, the paper's IGPM-PEM -----------------------------

class PemTimer:
    """Wrap a PEM's ``feedback`` and ``communities`` (here, not in the
    package) and add up the wall time of their calls since ``reset``."""

    def __init__(self, pem):
        self.feedback_s = self.communities_s = 0.0
        feedback, communities = pem.feedback, pem.communities

        def timed_feedback(*args):
            t0 = time.perf_counter()
            out = feedback(*args)
            self.feedback_s += time.perf_counter() - t0
            return out

        def timed_communities(*args):
            t0 = time.perf_counter()
            out = communities(*args)
            self.communities_s += time.perf_counter() - t0
            return out

        pem.feedback, pem.communities = timed_feedback, timed_communities

    def reset(self) -> None:
        self.feedback_s = self.communities_s = 0.0


def agent_tensors(agent):
    return [*agent.params.values(), *agent.m.values(), *agent.v.values(),
            *dict(agent.target_net.named_parameters()).values()]


def phase_serve_adaptive(stream, n_steps: int, profile: bool = False):
    """The default ``ServingConfig()`` (adaptive PEM) at ``FULL``: per step
    the wall and pipeline time, c and the TD loss, the recompute set, the
    PEM's feedback and communities time. The first label-RWR and BFS sweeps
    of the first step that runs at a c other than the initial one are
    captured."""
    import torch
    from repro_torch.config.base import ServingConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.kernels.spmv_ell import ops
    from repro_torch.serving.server import MatchServer
    srv = MatchServer(FULL, query_zoo(16), ServingConfig(), device="cuda")
    check(srv.pem.adaptive and srv.pem.agent is not None,
          "serve-adaptive: the default ServingConfig is not adaptive")
    agent = srv.pem.agent
    timer = PemTimer(srv.pem)
    g = stream.graph
    ops.reset_launch_counts()
    per_step = []
    prof = StepProfiler(profile, "serve-adaptive")
    with Capture(ops, FULL.n_labels, kinds=("label_rwr", "bfs")) as cap:
        for i, upd in enumerate(stream.updates[:n_steps]):
            c_in, t_in = srv.pem.c, agent.t
            cap.armed = (c_in != FULL.init_community_size
                         and len(cap.inputs) < len(cap.kinds))
            cap.tag = dict(step=i, c=c_in)
            timer.reset()
            t0 = time.perf_counter()
            srv.submit_update(upd)
            g, st = prof.step(i, lambda: srv.step(g))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            learned = agent.t > t_in
            say(f"  serve-adaptive step {i}: {dt:.3f} s (pipeline "
                f"{st.elapsed:.3f} s) c {c_in}->{st.community_size} "
                f"rl_loss={st.rl_loss:.6g}{' (learned)' if learned else ''} "
                f"n_recompute={st.n_recompute} subgraph={st.subgraph_nodes} "
                f"vertices/{st.subgraph_edges} arcs feedback "
                f"{timer.feedback_s * 1e3:.3f} ms communities "
                f"{timer.communities_s * 1e3:.3f} ms "
                f"new_patterns={st.n_new_patterns}")
            if i == 0:
                say(f"  serve-adaptive louvain dendrogram build (host): "
                    f"{srv.pem.clustering_time:.3f} s")
            per_step.append(dict(
                step=i, s=dt, pipeline_s=st.elapsed, c_in=c_in,
                c=st.community_size, rl_loss=st.rl_loss, learned=learned,
                n_recompute=st.n_recompute, subgraph_nodes=st.subgraph_nodes,
                subgraph_edges=st.subgraph_edges,
                feedback_ms=timer.feedback_s * 1e3,
                communities_ms=timer.communities_s * 1e3,
                new_patterns=st.n_new_patterns))
    launches = dict(ops.LAUNCHES)
    say(f"  serve-adaptive launches: {launches}")
    for name in ("ell_spmm", "ell_reach"):
        check(launches[name] > 0, f"serve-adaptive never launched {name}")
    cs = [s["c_in"] for s in per_step] + [per_step[-1]["c"]]
    check(len(set(cs)) > 1, "serve-adaptive: c never moved")
    learning = [s for s in per_step if s["learned"]]
    check(len(learning) >= 4,
          f"serve-adaptive: {len(learning)} learning steps, want >= 4")
    check(all(s["rl_loss"] > 0 for s in learning),
          "serve-adaptive: a learning step reported rl_loss <= 0")
    check(all(s["rl_loss"] == 0 for s in per_step if not s["learned"]),
          "serve-adaptive: rl_loss without a learning step")
    check(all(t.is_cuda for t in agent_tensors(agent)),
          "serve-adaptive: the DQN's tensors are not on the card")
    check_results(st.deltas, "serve-adaptive")
    for d in st.deltas:
        check(d.total >= d.exact >= 0,
              "serve-adaptive: inconsistent store counts")
    say(f"  serve-adaptive c trajectory: {cs}; learning steps "
        f"{[s['step'] for s in learning]}; agent t={agent.t}")
    return launches, per_step, cap, srv


def check_captured_adaptive(cap):
    """Hold both ELL kernels against their plain versions on the sweeps
    serve-adaptive handed them at a c other than the initial one."""
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.kernels.measure import cuda_ms
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    for key in ("label_rwr", "bfs"):
        check(key in cap.inputs,
              f"serve-adaptive handed no {key} sweep to a kernel at c != "
              "the initial c")
        check(cap.where[key]["c"] != FULL.init_community_size,
              "serve-adaptive: captured at the initial c")
    cols, vals, mask, row_ids, x, n = cap.inputs["label_rwr"]
    index = build_row_index(mask, row_ids, n)
    abs_err, rel_err = compare_spmm(
        ops, ref, cols, vals, mask, row_ids, x, n, index,
        f"captured serve-adaptive label_rwr (step {cap.where['label_rwr']})")
    ms = cuda_ms(lambda: ops.ell_spmm(cols, vals, mask, row_ids, x, n,
                                      index=index), REPS)
    b_ms, b_by, nbytes, _ = spmm_bound(mask, x, n, True)
    say(f"  ell_spmm captured serve-adaptive label_rwr: nnz="
        f"{int(mask.sum())} n={n} {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    out = {"label_rwr": dict(max_abs_err=abs_err, max_rel_err=rel_err,
                             ms=ms, bound_ms=b_ms, bound_by=b_by,
                             nnz=int(mask.sum()), R=cols.shape[0], n=n,
                             d=x.shape[1], **cap.where["label_rwr"])}
    out["bfs"] = dict(time_captured_bfs(cap.inputs["bfs"], "serve-adaptive"),
                      **cap.where["bfs"])
    return out


# -- phase 10: round trips of the adaptive server --------------------------------

def q_probe(agent):
    import numpy as np
    obs = np.random.default_rng(0).random((8, 2)).astype(np.float32)
    return agent.q_values(obs)


def phase_round_trips(srv, graph0):
    """``save``/``load`` of the whole engine and ``save_policy``/
    ``load_policy`` into fresh FULL servers on the card: equal graph,
    stores, c, and bitwise-equal Q-values."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.config.base import ServingConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.serving.server import MatchServer
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        srv.save(str(tmp / "engine"))
        save_s = time.perf_counter() - t0
        fresh = MatchServer(FULL, query_zoo(16), ServingConfig(),
                            device="cuda")
        t0 = time.perf_counter()
        step = fresh.load(graph0, str(tmp / "engine"))
        load_s = time.perf_counter() - t0
        check(step == srv.step_idx, "round trip: wrong step restored")
        for f in graph0._fields:
            check(torch.equal(getattr(fresh.graph, f),
                              getattr(srv.graph, f)),
                  f"round trip: graph field {f} differs")
        check([s._patterns for s in fresh.stores]
              == [s._patterns for s in srv.stores],
              "round trip: pattern stores differ")
        check(fresh.pem.c == srv.pem.c, "round trip: c differs")
        want = q_probe(srv.pem.agent)
        check(np.array_equal(q_probe(fresh.pem.agent), want),
              "round trip: Q-values differ")
        check(all(t.is_cuda for t in agent_tensors(fresh.pem.agent)),
              "round trip: the restored agent is not on the card")
        del fresh
        srv.save_policy(str(tmp / "policy"))
        fresh = MatchServer(FULL, query_zoo(16), ServingConfig(),
                            device="cuda")
        check(fresh.load_policy(str(tmp / "policy")) == srv.step_idx,
              "policy round trip: wrong step restored")
        check(fresh.pem.c == srv.pem.c, "policy round trip: c differs")
        check(fresh.pem.agent.t == srv.pem.agent.t,
              "policy round trip: t differs")
        check(np.array_equal(q_probe(fresh.pem.agent), want),
              "policy round trip: Q-values differ")
        n_bytes = sum(p.stat().st_size for p in tmp.rglob("*")
                      if p.is_file())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase round-trips: save {save_s:.3f} s, load {load_s:.3f} s "
        f"({n_bytes} B on disk): graph, stores, c={srv.pem.c} and Q-values "
        f"equal; the policy alone likewise")
    return dict(save_s=save_s, load_s=load_s, bytes=n_bytes)


# -- phases 11-12: serve-traced and the async runtime ----------------------------

def stores_of(srv):
    return [dict(s._patterns) for s in srv.stores]


def record_outputs(eng):
    """Wrap ``eng.step`` to keep each StepOutput (which carries
    ``stage_s``; the server's step stats do not)."""
    outs = []
    step = eng.step

    def recording(state, upd):
        state, out = step(state, upd)
        outs.append(out)
        return state, out

    eng.step = recording
    return outs


def pem_snapshot(pem):
    return pem._dendro, dict(pem._cuts), pem.c


def pem_restore(pem, snap) -> None:
    """Put back a PEM's dendrogram, cuts and c: every run of the runtime
    phase starts from the same PEM state (the dendrogram is a function of
    the warm graph and the seed, so handing it over saves its host build)."""
    pem._dendro, cuts, pem.c = snap
    pem._cuts = dict(cuts)


class SpanRanges:
    """Under ``--profile``: open a ``torch.profiler.record_function`` of the
    span's name inside each engine span of ``obs``, so the profile can
    attribute device-to-host copies to the stage they fall in."""

    def __init__(self, obs):
        import torch
        span = obs.span

        @contextlib.contextmanager
        def ranged(name, **args):
            with span(name, **args) as sp, \
                    torch.profiler.record_function(name):
                yield sp

        obs.span = ranged


def attribute_copies(prof):
    """Device-to-host copies of a profiled step by the innermost engine
    span (``record_function`` range) their host call falls in: count and
    host ms of the ``cudaMemcpy*`` calls, and device ms of the copies."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    ranges = [e for e in events if e.name.startswith(("engine/", "bank/"))
              and getattr(e, "device_type", None) == DeviceType.CPU]

    def stage_of(t0, t1):
        best = None
        for r in ranges:
            if r.time_range.start <= t0 and t1 <= r.time_range.end:
                if best is None or (r.time_range.elapsed_us()
                                    < best.time_range.elapsed_us()):
                    best = r
        return best.name if best is not None else "(outside spans)"

    host, dev = {}, {}
    for e in events:
        if getattr(e, "device_type", None) == DeviceType.CPU and \
                e.name.startswith("cudaMemcpy"):
            k = stage_of(e.time_range.start, e.time_range.end)
            n, ms = host.get(k, (0, 0.0))
            host[k] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
        elif getattr(e, "device_type", None) != DeviceType.CPU and \
                "DtoH" in e.name:
            k = stage_of(e.time_range.start, e.time_range.start)
            n, ms = dev.get(k, (0, 0.0))
            dev[k] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return host, dev


# stages that partition a traced step: ``ell_refresh`` is inside ``apply``
# and gray_wait inside ``device_wait``, so the sum leaves ell_refresh out
STAGE_PARTS = ("apply", "prune", "pem", "extract", "rwr", "seeds", "gray",
               "device_wait", "merge", "feedback")


def phase_serve_traced(stream, inc, inc_stores, inc_launches, n_steps: int,
                       profile: bool = False):
    """A FULL Inc server with tracing on replays serve-inc's batches: its
    stores and launch counts must equal serve-inc's untraced ones; each
    warm step's stages are printed beside its wall time. Serve-inc's
    dendrogram is handed over (a function of the warm graph and the seed),
    so this phase pays no host Louvain build."""
    import torch
    from repro_torch.config.base import ObsConfig, ServingConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.kernels.spmv_ell import ops
    from repro_torch.obs.export import validate_events
    from repro_torch.serving.server import MatchServer
    from torch.profiler import ProfilerActivity, profile as tprofile
    srv = MatchServer(FULL, query_zoo(16),
                      ServingConfig(adaptive=False,
                                    obs=ObsConfig(enabled=True)),
                      device="cuda")
    pem_restore(srv.pem, pem_snapshot(inc.pem))
    builds = srv.pem.recluster_count
    outs = record_outputs(srv.engine)
    if profile:
        SpanRanges(srv.obs)
    g = stream.graph
    ops.reset_launch_counts()
    per_step = []
    for i, upd in enumerate(stream.updates[:n_steps]):
        ctx = (tprofile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
               if profile and i >= 1 else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            srv.submit_update(upd)
            g, st = srv.step(g)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        stage = outs[-1].stage_s
        parts = sum(stage.get(k, 0.0) for k in STAGE_PARTS)
        share = parts / dt
        say(f"  serve-traced step {i}: {dt:.3f} s, stages sum "
            f"{parts:.3f} s ({100 * share:.1f} % of the step): "
            + " ".join(f"{k}={v * 1e3:.2f}" for k, v in stage.items())
            + " ms")
        row = dict(step=i, s=dt, stages_sum_s=parts,
                   stage_ms={k: v * 1e3 for k, v in stage.items()})
        if i >= 1 and not 0.9 <= share <= 1.1:
            say(f"  serve-traced step {i}: the stages cover {100 * share:.1f}"
                f" % of the step's wall time, outside 90-110 %")
        if prof is not None:
            host, dev = attribute_copies(prof)
            say(f"  serve-traced step {i} device-to-host copies by stage "
                f"(host calls: count, ms | device copies: count, ms):")
            for k in sorted(set(host) | set(dev),
                            key=lambda k: -host.get(k, (0, 0.0))[1]):
                hn, hms = host.get(k, (0, 0.0))
                dn, dms = dev.get(k, (0, 0.0))
                say(f"    {k:24s} host {hn:3d} {hms:8.3f} ms | device "
                    f"{dn:3d} {dms:7.3f} ms")
            row["copies"] = {k: dict(host=host.get(k), device=dev.get(k))
                             for k in set(host) | set(dev)}
        per_step.append(row)
    launches = dict(ops.LAUNCHES)
    say(f"  serve-traced launches: {launches} (serve-inc: {inc_launches})")
    check(launches == inc_launches,
          "serve-traced: kernel launches differ from serve-inc's")
    check(stores_of(srv) == inc_stores,
          "serve-traced: stores differ from serve-inc's untraced stores")
    check(srv.pem.recluster_count == builds,
          "serve-traced: paid a Louvain build")
    events = srv.obs.tracer.events()
    check(validate_events(events) == [], "serve-traced: invalid span events")
    check(srv.obs.tracer.n_spans > 0, "serve-traced: no spans")
    say(f"  serve-traced: stores equal serve-inc's bitwise, "
        f"{srv.obs.tracer.n_spans} spans, no Louvain build")
    return per_step


RT_TICKS, RT_TICK_S, RT_RATE = 48, 0.05, 1000.0


def rt_report(tag: str, srv, stats) -> dict:
    snap = srv.telemetry.snapshot()
    q = srv.queue
    row = dict(steps=len(stats), p50_step_ms=snap["p50_step_ms"],
               p99_step_ms=snap["p99_step_ms"],
               p50_e2e_ms=snap.get("p50_e2e_ms"),
               p99_e2e_ms=snap.get("p99_e2e_ms"),
               dropped=q.n_dropped, evicted=q.n_evicted,
               rejected=q.n_rejected,
               events=sum(s.n_events for s in stats))
    say(f"  runtime {tag}: steps={row['steps']} p50_step="
        f"{row['p50_step_ms']:.1f} ms p99_step={row['p99_step_ms']:.1f} ms "
        f"p50_e2e={row['p50_e2e_ms']} ms p99_e2e={row['p99_e2e_ms']} ms "
        f"events={row['events']} dropped={row['dropped']} (evicted="
        f"{row['evicted']} rejected={row['rejected']})")
    return row


def phase_runtime(stream, inc, card: str):
    """The async runtime on serve-inc's untraced FULL Inc server (reset
    between runs; its PEM state put back each time): the stream's measured
    batches dealt into a seeded flash-crowd process (1,000 events/s, 48
    ticks of 50 ms, 8x bursts for 4 of every 16 ticks, seed 0). Under
    ``VirtualClock`` the sync runner and the lockstep runtime must give
    bitwise-equal stores and graphs, and a 2-executor lockstep run the
    serial one's stores; under ``WallClock`` the open sync runner and the
    shed runtime are timed side by side."""
    import numpy as np
    import torch
    from repro_torch.config.base import RuntimeConfig
    from repro_torch.core.graph import to_numpy
    from repro_torch.kernels.spmv_ell import ops
    from repro_torch.runtime import (ServingRuntime, VirtualClock,
                                     WallClock, deal, flash_crowd,
                                     run_workload_sync)
    sc = flash_crowd(rate=RT_RATE, tick_s=RT_TICK_S, n_ticks=RT_TICKS,
                     burst_amplitude=8.0, burst_period=16, burst_len=4,
                     seed=0, n_vertices=stream.spec.n_vertices)
    wl = deal(sc, stream)
    empty = sum(1 for t in wl.ticks if not t.events)
    say(f"  runtime workload: {wl.n_events} events of {len(stream.updates)} "
        f"batches over {RT_TICKS} ticks of {RT_TICK_S * 1e3:.0f} ms; "
        f"{empty} ticks carried none (the stream ran out)")
    snap = pem_snapshot(inc.pem)
    builds = inc.pem.recluster_count
    buckets = len(inc.engine.buckets)
    say(f"  runtime: the 16-query zoo fills {buckets} buckets"
        + ("" if buckets > 1 else " — one bucket: the pool runs it serially"))
    out = dict(n_events=wl.n_events, empty_ticks=empty, buckets=buckets)

    def fresh():
        inc.reset()
        pem_restore(inc.pem, snap)
        return inc

    def graph_arrays(g):
        return [to_numpy(getattr(g, f)) for f in g._fields]

    srv = fresh()
    t0 = time.perf_counter()
    g_sync, st_sync = run_workload_sync(srv, wl, clock=VirtualClock())
    torch.cuda.synchronize()
    out["virtual_sync_s"] = time.perf_counter() - t0
    sync_stores, sync_graph = stores_of(srv), graph_arrays(g_sync)
    out["virtual_sync"] = rt_report("virtual sync", srv, st_sync)

    srv = fresh()
    ops.reset_launch_counts()
    rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep",
                                           drain_timeout_s=600.0),
                        clock=VirtualClock())
    st_lock = rt.serve(wl)
    torch.cuda.synchronize()
    launches_rt = dict(ops.LAUNCHES)
    out["virtual_lockstep"] = rt_report("virtual lockstep", srv, st_lock)
    check([s.n_events for s in st_lock] == [s.n_events for s in st_sync],
          "runtime: lockstep batches differ from the sync runner's")
    check(stores_of(srv) == sync_stores,
          "runtime: lockstep stores differ from the sync runner's")
    check(all(np.array_equal(a, b) for a, b in
              zip(graph_arrays(rt.graph), sync_graph)),
          "runtime: lockstep graph differs from the sync runner's")
    for name, count in launches_rt.items():
        check(count > 0, f"runtime never launched {name}")
    say(f"  runtime lockstep == sync bitwise (stores, graph, "
        f"{len(st_lock)} steps); launches {launches_rt}")

    srv = fresh()
    ops.reset_launch_counts()
    rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep", n_executors=2,
                                           drain_timeout_s=600.0),
                        clock=VirtualClock())
    rt.serve(wl)
    torch.cuda.synchronize()
    launches_pool = dict(ops.LAUNCHES)
    check(stores_of(srv) == sync_stores,
          "runtime: 2-executor stores differ from the serial run's")
    check(srv.engine._exec_pool is None, "runtime: pool not torn down")
    say(f"  runtime n_executors=2 == serial bitwise; launches "
        f"{launches_pool} ({'equal to' if launches_pool == launches_rt else 'DIFFERENT from'}"
        f" the serial run's)")
    out["launches_pool_equal"] = launches_pool == launches_rt

    srv = fresh()
    t0 = time.perf_counter()
    _, st = run_workload_sync(srv, wl, clock=WallClock(), ingest="open")
    out["wall_s_sync"] = time.perf_counter() - t0
    out["wall_sync_open"] = rt_report("wall sync open", srv, st)
    srv = fresh()
    t0 = time.perf_counter()
    rt = ServingRuntime(srv, RuntimeConfig(ingress="shed",
                                           drain_timeout_s=600.0),
                        clock=WallClock())
    st = rt.serve(wl)
    out["wall_s_async"] = time.perf_counter() - t0
    out["wall_async_shed"] = rt_report("wall async shed", srv, st)
    say(f"  runtime wall-clock figures on {card}")
    check(inc.pem.recluster_count == builds, "runtime: paid a Louvain build")
    return out, launches_rt


# -- phase 15: the closed-loop serving controller --------------------------------

# the reference control bench's flash crowd (benchmarks/serving_bench.py,
# _control_rows), over the stream's measured batches
CTL_SC = dict(rate=350.0, tick_s=0.3, n_ticks=20, burst_amplitude=5.0,
              burst_period=10, burst_len=2, seed=11, closed_loop=True,
              lag_ref_s=0.5, ack_slo_s=0.5)
CTL_EPISODES = 2   # the CLI's default --control-episodes
CTL_TOL = 1e-4     # a tol_ladder rung: all seven actions live


def control_cfg(mode: str, **dqn):
    """``ControlConfig`` deciding at every micro-batch with the control
    bench's DQN overrides (ε 0.3 → 0.05 over 300 observes, γ 0.9), and
    ``dqn`` on top."""
    import dataclasses
    from repro_torch.config.base import ControlConfig
    ccfg = ControlConfig(mode=mode, decide_every=1)
    return dataclasses.replace(ccfg, dqn=dataclasses.replace(
        ccfg.dqn, epsilon=0.3, epsilon_final=0.05, epsilon_decay_steps=300,
        gamma=0.9, **dqn))


class SeededElapsed:
    """Replace the wall time a PEM's reward reads with a seeded schedule
    (one draw per feedback call, restarted by ``reset``), so closed loops
    under ``VirtualClock`` replay exactly; ``restore`` puts the PEM's own
    feedback back."""

    def __init__(self, pem, seed: int = 3):
        self.pem, self.seed, self.feedback = pem, seed, pem.feedback
        self.reset()

    def reset(self) -> None:
        import numpy as np
        rng = np.random.default_rng(self.seed)

        def seeded(g, frac, elapsed):
            return self.feedback(g, frac, float(rng.uniform(0.02, 0.2)))

        self.pem.feedback = seeded

    def restore(self) -> None:
        self.pem.feedback = self.feedback


class HookTimer:
    """Wall time of each call of a controller's ``on_batch`` hook."""

    def __init__(self, ctl):
        self.s = []
        on_batch = ctl.on_batch

        def timed(*args):
            t0 = time.perf_counter()
            on_batch(*args)
            self.s.append(time.perf_counter() - t0)

        ctl.on_batch = timed

    def ms(self):
        return ms_stats(self.s)


def ms_stats(seconds):
    import numpy as np
    a = np.asarray(seconds) * 1e3
    if not len(a):
        return dict(n=0)
    return dict(n=len(a), p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)), max=float(a.max()))


class QTimer:
    """Time each Q-value pass of a frozen controller's agent, alternating
    the stream it runs on: even calls on the calling thread's current
    stream (as the runtime runs them), odd calls on a stream of their own,
    which waits for no other work. Each time is filed by that choice and
    by whether the current stream still held queued work when the pass
    began (the work a device-to-host copy on it would wait for). A frozen
    agent's weights are not written during the run, so the second stream
    needs no ordering against the first."""

    def __init__(self, agent):
        import torch
        self.times = {}
        side = torch.cuda.Stream()
        q_values = agent.q_values
        calls = [0]

        def timed(obs):
            queued = not torch.cuda.current_stream().query()
            own = calls[0] % 2 == 1
            calls[0] += 1
            ctx = torch.cuda.stream(side) if own else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                out = q_values(obs)
            key = (("own stream" if own else "current stream")
                   + (", work queued" if queued else ", idle"))
            self.times.setdefault(key, []).append(time.perf_counter() - t0)
            return out

        agent.q_values = timed

    def ms(self):
        return {k: ms_stats(v) for k, v in sorted(self.times.items())}


def knobs_str(ctl) -> str:
    k = ctl.env.knobs
    return (f"window={k.window} depth={k.queue_depth} rwr_tol={k.rwr_tol:g} "
            f"(idx {ctl.env.knob_state()})")


def phase_control(stream, srv, card: str):
    """The RL serving controller on serve-adaptive's FULL IGPM-PEM server
    (``rwr_tol`` 1e-4; reset between runs, its PEM state — dendrogram,
    cuts, c and learner — put back each time, and the PEM's reward fed
    one seeded elapsed schedule under ``VirtualClock``): 2 training
    episodes, two frozen replays that must be equal, a checkpoint round
    trip of the controller, a traced frozen replay, then the frozen
    policy in the shed runtime under ``WallClock``."""
    import copy
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.config.base import ObsConfig, RuntimeConfig
    from repro_torch.control import ServingController
    from repro_torch.kernels.spmv_ell import ops
    from repro_torch.obs import Obs
    from repro_torch.runtime import (AckLedger, RuntimeKnobs, ServingRuntime,
                                     VirtualClock, WallClock, deal,
                                     flash_crowd, run_closed_loop,
                                     sim_service_model)
    check((srv.serving.microbatch_window, srv.serving.queue_depth)
          == (256, 4096) and srv.pem.adaptive,
          "control: not serve-adaptive's default ServingConfig()")
    sc = flash_crowd(n_vertices=stream.spec.n_vertices, **CTL_SC)
    wl = deal(sc, stream)
    say(f"  control workload: flash crowd {sc.rate:.0f} events/s, "
        f"{sc.n_ticks} ticks of {sc.tick_s * 1e3:.0f} ms, "
        f"{sc.burst_amplitude:g}x bursts, closed loop, pool {wl.n_events} "
        f"events of {len(stream.updates)} batches")
    srv.engine.cfg = dataclasses.replace(srv.engine.cfg, rwr_tol=CTL_TOL)
    pem = srv.pem
    snap, agent0 = pem_snapshot(pem), copy.deepcopy(pem.agent)
    fb0 = (pem._last_obs, pem._last_action, pem._reward_ema)
    builds = pem.recluster_count
    seeded = SeededElapsed(pem)
    outs = record_outputs(srv.engine)
    model = sim_service_model()

    knobs = RuntimeKnobs(srv)
    ledger = AckLedger(slo_s=sc.ack_slo_s)

    def fresh():
        """Reset the server and put its PEM state back. The tol knob goes
        back to its configured rung too: a controller takes its tol
        baseline from the engine's live config, as the reference's does,
        and an earlier controller may have left it elsewhere."""
        srv.reset()
        pem_restore(pem, snap)
        pem.agent = copy.deepcopy(agent0)
        pem._last_obs, pem._last_action, pem._reward_ema = fb0
        seeded.reset()
        knobs.set_rwr_tol(CTL_TOL)
        ledger.reset()
        outs.clear()

    def controller(mode):
        fresh()
        return ServingController(srv, knobs, ledger, control_cfg(mode))

    def episode(ctl, tag):
        n0, l0 = len(ctl.history), len(ctl.losses)
        t0 = time.perf_counter()
        _, st, _ = run_closed_loop(srv, wl, clock=VirtualClock(),
                                   controller=ctl, knobs=knobs,
                                   ledger=ledger, service_model=model)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hist, losses = ctl.history[n0:], ctl.losses[l0:]
        summ = ledger.summary(sc.duration_s)
        sweeps = [o.rwr_sweeps for o in outs]
        say(f"  control {tag}: {len(st)} steps in {dt:.2f} s, "
            f"{len(hist)} decisions {[a for _, a, _ in hist]}, "
            f"goodput {summ['goodput_eps']:.1f} ev/s viol_rate "
            f"{summ['viol_rate']:.3f}, knobs {knobs_str(ctl)}")
        if losses:
            say(f"  control {tag} TD losses: "
                + " ".join(f"{x:.4g}" for x in losses))
        say(f"  control {tag} sweeps per step (cap "
            f"{srv.engine.cfg.rwr_iters}): {sweeps}; skipped columns "
            f"{[o.rwr_cols_skipped for o in outs]}")
        return dict(steps=len(st), s=dt, decisions=len(hist),
                    actions=[a for _, a, _ in hist], losses=losses,
                    sweeps=sweeps, knobs=ctl.env.knob_state(), **summ), hist

    out = {}
    ops.reset_launch_counts()
    # 1. train
    ctl = controller("train")
    check(ctl.env.tol_ladder == (1e-5, 1e-4, 1e-3, 1e-2),
          f"control: tol knob not live ({ctl.env.tol_ladder})")
    check(all(t.is_cuda for t in agent_tensors(ctl.agent)),
          "control: the controller's DQN is not on the card")
    out["train"] = []
    for ep in range(CTL_EPISODES):
        if ep:
            fresh()
        out["train"].append(episode(ctl, f"train episode {ep}")[0])
    check(ctl.n_episodes == CTL_EPISODES, "control: episodes not counted")
    # the replay ring must hold replay_batch = 32 transitions before the
    # learner steps, so two short episodes may end before it does
    say(f"  control training: {ctl.n_decisions} decisions, "
        f"{sum(x > 0 for x in ctl.losses)} learning steps, agent t="
        f"{ctl.agent.t}, replay {ctl.agent.replay.size}")
    sd = ctl.state_dict()
    # 2. freeze: two replays of the frozen policy must be equal
    replays, hook_virtual = [], None
    for rep in range(2):
        fz = controller("frozen")
        fz.load_state_dict(sd)
        timer = HookTimer(fz)
        row, hist = episode(fz, f"frozen replay {rep}")
        check(fz.losses == [], "control: a frozen replay learned")
        replays.append((hist, stores_of(srv), row))
        hook_virtual = timer.ms()
    check(len(replays[0][0]) > 0, "control: no decisions")
    check(replays[0][0] == replays[1][0],
          "control: frozen replays decided differently")
    check(replays[0][1] == replays[1][1],
          "control: frozen replays' stores differ")
    out["frozen"] = replays[0][2]
    out["hook_virtual_ms"] = hook_virtual
    say(f"  control frozen replays equal: {len(replays[0][0])} decisions, "
        f"stores equal; on_batch under VirtualClock {hook_virtual}")
    # 3. checkpoint round trip of the attached controller
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ctl_", dir=ROOT / "build"))
    try:
        srv.engine.control = fz
        t0 = time.perf_counter()
        srv.save(str(tmp))
        save_s = time.perf_counter() - t0
        back = ServingController(srv, RuntimeKnobs(srv),
                                 AckLedger(slo_s=sc.ack_slo_s),
                                 control_cfg("frozen"))
        check(back.env.tol_ladder == fz.env.tol_ladder,
              "control: the round trip's ladders differ")
        srv.engine.control = back
        t0 = time.perf_counter()
        srv.load(stream.graph, str(tmp))
        load_s = time.perf_counter() - t0
    finally:
        srv.engine.control = None
        shutil.rmtree(tmp, ignore_errors=True)
    probe = np.asarray(replays[0][0][-1][0], np.float32)
    check(np.array_equal(back.agent.q_values(probe), fz.agent.q_values(probe)),
          "control: Q-values differ after the checkpoint round trip")
    check(back.env.knob_state() == fz.env.knob_state(),
          "control: knob indices differ after the checkpoint round trip")
    check((back.n_decisions, back.n_episodes)
          == (fz.n_decisions, fz.n_episodes),
          "control: counters differ after the checkpoint round trip")
    say(f"  control checkpoint: save {save_s:.3f} s, load {load_s:.3f} s; "
        f"Q-values bitwise, knobs {back.env.knob_state()}")
    out["checkpoint"] = dict(save_s=save_s, load_s=load_s)
    # 4. the frozen policy in the shed runtime under WallClock
    fresh()
    seeded.restore()
    rt = ServingRuntime(srv, RuntimeConfig(ingress="shed",
                                           drain_timeout_s=600.0,
                                           control=control_cfg("frozen")),
                        clock=WallClock())
    rt.controller.load_state_dict(sd)
    timer, q_timer = HookTimer(rt.controller), QTimer(rt.controller.agent)
    t0 = time.perf_counter()
    st = rt.serve(wl)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    srv.engine.control = None
    cs = rt.closed_summary(wl)
    hook, q_ms = timer.ms(), q_timer.ms()
    row = rt_report("control wall shed", srv, st)
    say(f"  control wall: {wall_s:.2f} s, goodput {cs['goodput_eps']:.1f} "
        f"ev/s, viol_rate {cs['viol_rate']:.3f}, throttled "
        f"{cs.get('events_throttled', 0):.0f}, offered "
        f"{cs.get('events_offered', 0):.0f}, acked {cs['events_acked']:.0f}; "
        f"{len(rt.controller.history)} decisions, knobs "
        f"{knobs_str(rt.controller)}; on_batch {hook}; sweeps per step "
        f"{[o.rwr_sweeps for o in outs]}")
    say(f"  control wall: the Q-value pass inside the hook, ms, by the "
        f"stream it ran on and whether the current stream held queued work "
        f"when it began: {q_ms}")
    out["wall"] = dict(row, s=wall_s, decisions=len(rt.controller.history),
                       knobs=rt.controller.env.knob_state(), hook_ms=hook,
                       q_values_ms=q_ms,
                       sweeps=[o.rwr_sweeps for o in outs], **cs)
    say(f"  control launches (train, frozen, round trip, wall): {launches}")
    for name in ("ell_spmm", "ell_reach"):
        check(launches.get(name, 0) > 0, f"control never launched {name}")
    # a traced frozen replay: stage_s["rwr"] beside the sweeps it ran
    obs0 = srv.engine.obs
    srv.engine.obs = Obs(ObsConfig(enabled=True))
    try:
        fz = controller("frozen")
        fz.load_state_dict(sd)
        episode(fz, "traced frozen replay")
    finally:
        srv.engine.obs = obs0
    rwr_ms = [o.stage_s["rwr"] * 1e3 for o in outs]
    say("  control traced: per step sweeps/skipped, rwr ms, pipeline ms: "
        + "  ".join(f"{o.rwr_sweeps}/{o.rwr_cols_skipped} {r:.2f} "
                    f"{o.elapsed * 1e3:.1f}" for o, r in zip(outs, rwr_ms)))
    out["traced"] = dict(sweeps=[o.rwr_sweeps for o in outs], rwr_ms=rwr_ms,
                         pipeline_ms=[o.elapsed * 1e3 for o in outs])
    seeded.restore()
    del srv.engine.step   # record_outputs' wrapper
    check(pem.recluster_count == builds, "control: paid a Louvain build")
    say(f"  control figures on {card}")
    return out, launches


def phase_control_agreement():
    """The controller on the toy closed loop, card against CPU: a policy
    trained on the CPU is loaded frozen on both, the two PEMs share one
    learner state and one seeded elapsed schedule; decision histories
    (obs bitwise), sweeps per step and stores must be equal."""
    from repro_torch.config.base import IGPMConfig, ServingConfig
    from repro_torch.control import ServingController
    from repro_torch.core.query import query_zoo
    from repro_torch.runtime import (AckLedger, RuntimeKnobs, VirtualClock,
                                     build_workload, flash_crowd,
                                     run_closed_loop, sim_service_model)
    from repro_torch.serving.server import MatchServer
    cfg = IGPMConfig(n_max=128, e_max=8192, ell_width=8, rwr_iters=30,
                     rwr_iters_incremental=4, top_k_patterns=4,
                     init_community_size=32, backend="ell", rwr_tol=CTL_TOL)
    sc = flash_crowd(rate=2000.0, tick_s=0.01, n_ticks=8, n_vertices=128,
                     seed=3, closed_loop=True)

    def run(dev, ccfg, state=None, pem_state=None):
        wl = build_workload(sc, u_max=256, device=dev)
        srv = MatchServer(cfg, query_zoo(2),
                          ServingConfig(microbatch_window=64), seed=0,
                          device=dev)
        if pem_state is not None:
            srv.pem.agent.load_state_dict(pem_state)
        pem0 = srv.pem.agent.state_dict()
        SeededElapsed(srv.pem)
        outs = record_outputs(srv.engine)
        knobs, ledger = RuntimeKnobs(srv), AckLedger(slo_s=0.25)
        ctl = ServingController(srv, knobs, ledger, ccfg)
        if state is not None:
            ctl.load_state_dict(state)
        run_closed_loop(srv, wl, clock=VirtualClock(), controller=ctl,
                        knobs=knobs, ledger=ledger,
                        service_model=sim_service_model())
        return ctl, stores_of(srv), [o.rwr_sweeps for o in outs], pem0

    trained, _, _, _ = run("cpu", control_cfg("train", replay_batch=4,
                                              target_update_every=4))
    check(sum(x > 0 for x in trained.losses) >= 2,
          "control agreement: the CPU policy never learned")
    sd = trained.state_dict()
    cpu, cpu_st, cpu_sw, pem0 = run("cpu", control_cfg("frozen"), sd)
    card, card_st, card_sw, _ = run("cuda", control_cfg("frozen"), sd, pem0)
    say(f"phase control-agreement: sweeps per step card {card_sw} / CPU "
        f"{cpu_sw} (cap {cfg.rwr_iters})")
    check(card_sw == cpu_sw, "control agreement: sweep counts differ")
    check(card.history == cpu.history,
          "control agreement: decision histories differ")
    check(len(set(cpu_sw)) > 1 or min(cpu_sw) < cfg.rwr_iters,
          "control agreement: the tolerance never ended a sweep loop")
    for a, b in zip(card_st, cpu_st):
        check(sorted(a) == sorted(b), "control agreement: stores differ")
        for key, (good, exact) in a.items():
            check(exact == b[key][1] and abs(good - b[key][0]) <= 1e-4,
                  "control agreement: stored goodness or exact flags differ")
    say(f"phase control-agreement: CUDA == CPU on {len(card.history)} "
        f"decisions {[a for _, a, _ in card.history]} (obs bitwise), "
        f"{sum(len(s) for s in card_st)} patterns")
    return dict(decisions=len(card.history), sweeps=card_sw)


# -- phase 5: adaptive agreement, card against CPU ------------------------------

def phase_small_adaptive_agreement():
    """The toy stream served adaptively on the card and on the CPU: the
    card agent loads the CPU agent's state before step 0, and both PEMs'
    feedback get one seeded elapsed schedule in place of wall time."""
    import numpy as np
    from repro_torch.config.base import IGPMConfig, ServingConfig
    from repro_torch.core.query import query_zoo
    from repro_torch.data.temporal import TemporalGraphSpec, generate_stream
    from repro_torch.serving.server import MatchServer
    spec = TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                             n_edges=4096, n_steps=40, seed=7)
    cfg = IGPMConfig(n_max=512, e_max=16384, rwr_iters=12,
                     rwr_iters_incremental=4, top_k_patterns=8,
                     init_community_size=32, backend="ell",
                     replay_batch=4, target_update_every=2)
    out, state = {}, None
    for dev in ("cpu", "cuda"):
        st = generate_stream(spec, n_measured_steps=8, u_max=128, device=dev)
        srv = MatchServer(cfg, query_zoo(4), ServingConfig(), device=dev)
        if state is None:
            state = srv.pem.agent.state_dict()
        else:
            srv.pem.agent.load_state_dict(state)
        SeededElapsed(srv.pem)
        _, stats = srv.run(st.graph, st.updates)
        out[dev] = (stats, [dict(s._patterns) for s in srv.stores])
    (cpu, cpu_st), (card, card_st) = out["cpu"], out["cuda"]
    check([s.deltas for s in card] == [s.deltas for s in cpu],
          "adaptive agreement: match deltas differ")
    c_card = [s.community_size for s in card]
    check(c_card == [s.community_size for s in cpu],
          "adaptive agreement: c trajectories differ")
    check(len(set(c_card)) > 1, "adaptive agreement: c never moved")
    worst = 0.0
    for a, b in zip(card_st, cpu_st):
        check(sorted(a) == sorted(b), "adaptive agreement: stores differ")
        for key, (good, exact) in a.items():
            check(exact == b[key][1], "adaptive agreement: exact flags differ")
            worst = max(worst, abs(good - b[key][0]))
    check(worst <= 1e-4, "adaptive agreement: goodness differs by > 1e-4")
    loss_card = np.array([s.rl_loss for s in card])
    loss_cpu = np.array([s.rl_loss for s in cpu])
    check(int((loss_cpu > 0).sum()) >= 3,
          "adaptive agreement: fewer than 3 learning steps")
    rel = float(np.max(np.abs(loss_card - loss_cpu)
                       / np.maximum(np.abs(loss_cpu), 1e-30)))
    check(rel <= LOSS_RTOL,
          f"adaptive agreement: rl_loss differs by {rel:.3e} relative")
    say(f"phase adaptive-agreement: CUDA == CPU plain on {len(card)} steps, "
        f"c {c_card}, {sum(len(s) for s in card_st)} patterns, max goodness "
        f"diff {worst:.3e}, rl_loss max rel diff {rel:.3e}")
    return dict(c=c_card, max_goodness_diff=worst, rl_loss_rel=rel)


# -- phase 13: the port's CLI ----------------------------------------------------

def phase_cli():
    """``repro_torch.launch.serve --arch igpm-pem`` on the card, twice with
    one policy directory: the second run restores the first's policy."""
    import os
    import shutil
    import subprocess
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_policy_",
                                dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "igpm-pem", "--steps", "4", "--policy-dir", str(tmp)]
    outs = []
    try:
        for run in (1, 2):
            t0 = time.perf_counter()
            p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                               text=True, timeout=300)
            for line in p.stdout.splitlines():
                say(f"  cli run {run}: {line}")
            check(p.returncode == 0, f"cli run {run} exited {p.returncode}: "
                                     f"{p.stderr[-2000:]}")
            say(f"  cli run {run}: {time.perf_counter() - t0:.2f} s")
            outs.append(p.stdout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("no policy in" in outs[0] and "saved PEM policy" in outs[0],
          "cli run 1 did not start fresh and save its policy")
    check("restored PEM policy" in outs[1],
          "cli run 2 did not restore the saved policy")
    say("phase cli: the second run restored the first run's policy")



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
    from repro_torch.kernels.measure import card_line
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
    rows.update(phase_train_kernels(REPS))
    say("phase config-kernels:")
    rows.update(phase_config_kernels(REPS))
    phase_small_agreement()
    adapt_agree = phase_small_adaptive_agreement()
    ctl_agree = phase_control_agreement()
    launches_agree = phase_lm_agreement()
    train_agree, launches_train_agree = phase_train_agreement()
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.data.temporal import generate_stream, scaled_twin
    spec = scaled_twin("transactions", 1.0)
    t0 = time.perf_counter()
    stream = generate_stream(spec, n_max=FULL.n_max, e_max=FULL.e_max,
                             n_measured_steps=max(INC_STEPS, BATCH_STEPS,
                                                  ADAPT_STEPS),
                             u_max=512, device="cuda")
    say(f"phase stream: {spec.name} n_vertices={spec.n_vertices} "
        f"warm arcs={int(stream.graph.edge_mask.sum())} "
        f"({time.perf_counter() - t0:.2f} s)")
    say("phase serve-inc:")
    launches_inc, inc_steps, captured, inc_srv = phase_serve_inc(
        stream, INC_STEPS, args.profile)
    louvain_s = inc_srv.pem.clustering_time
    inc_stores = stores_of(inc_srv)
    cap = check_captured(captured)
    del captured
    say("phase serve-batch:")
    launches_batch, batch_steps, captured, batch_record = phase_serve_batch(
        stream, BATCH_STEPS, args.profile)
    check("bfs" in captured, "serve-batch handed no BFS sweep to a kernel")
    cap["batch_bfs"] = time_captured_bfs(captured["bfs"], "serve-batch")
    del captured
    say("phase serve-sharded:")
    sharded, block_rows = phase_serve_sharded(
        stream, BATCH_STEPS, batch_record, batch_steps, REPS)
    del batch_record
    torch.cuda.empty_cache()
    say("phase serve-adaptive:")
    launches_adapt, adapt_steps, adapt_cap, srv = phase_serve_adaptive(
        stream, ADAPT_STEPS, args.profile)
    cap["adaptive"] = check_captured_adaptive(adapt_cap)
    adapt_louvain_s = srv.pem.clustering_time
    round_trips = phase_round_trips(srv, stream.graph)
    del adapt_cap
    torch.cuda.empty_cache()
    say("phase serve-traced:")
    traced = phase_serve_traced(stream, inc_srv, inc_stores, launches_inc,
                                INC_STEPS, args.profile)
    say("phase runtime:")
    runtime, launches_rt = phase_runtime(stream, inc_srv, card)
    del inc_srv
    say("phase control:")
    control, launches_ctl = phase_control(stream, srv, card)
    control["agreement"] = ctl_agree
    del srv, stream
    torch.cuda.empty_cache()
    phase_cli()
    say("phase serve-lm:")
    launches_lm, lm = phase_serve_lm(args.profile)
    say("phase serve-lm-configs:")
    launches_configs, lm_configs = phase_serve_lm_configs()
    say("phase train-lm:")
    launches_train, train = phase_train_lm(args.profile)
    say("phase train-smollm:")
    launches_smol, train_smol = phase_train_smollm()
    serve = dict(inc_steps=inc_steps, batch_steps=batch_steps,
                 louvain_s=louvain_s, adaptive_steps=adapt_steps,
                 adaptive_louvain_s=adapt_louvain_s,
                 adaptive_agreement=adapt_agree, round_trips=round_trips,
                 traced=traced, runtime=runtime, control=control,
                 captured=cap, lm=lm, sharded=sharded, train=train,
                 lm_configs=lm_configs, train_smollm=train_smol,
                 train_agreement=train_agree,
                 lse={lb: rows[("lse", lb)] for lb in
                      ("prefill", "hd40", "f32 hd16")},
                 gemm_transposes={lb: rows[("gemm transposes", lb)]
                                  for lb in ("gate", "down")})

    kernels = []
    for name, src, line in (
            ("ell_spmm", "src/repro_torch/kernels/spmv_ell/csrc/ell_spmm.cu",
             "src/repro/kernels/spmv_ell/spmv_ell.py:60"),
            ("ell_reach", "src/repro_torch/kernels/spmv_ell/csrc/ell_reach.cu",
             "src/repro/kernels/spmv_ell/spmv_ell.py:91")):
        head = rows[(name, 320)]
        served = cap["adaptive"]["label_rwr" if name == "ell_spmm" else "bfs"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches_adapt[name],
            "launches_path": "serve-adaptive",
            "launches_inc": launches_inc[name],
            "launches_batch": launches_batch[name],
            "launches_runtime": launches_rt[name],
            "launches_control": launches_ctl[name],
            "launches_sharded": {run: r["launches"][name]
                                 for run, r in sharded["runs"].items()},
            "max_abs_err": max(head["max_abs_err"], served["max_abs_err"],
                               *(block_rows[(name, d)]["max_abs_err"]
                                 for d in (4, 160))),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "gather_floor_ms": head.get("gather_floor_ms"),
            "variant": head.get("variant"),
            "shape": "R=393216 K=64 n=262144 d=320",
            "by_d": {str(d): rows[(name, d)] for d in (4, 320)},
            "by_block_d": {str(d): block_rows[(name, d)] for d in (4, 160)},
        })
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/"
    flash_tpu = "src/repro/kernels/flash_attention/flash_attention.py:80"
    gemm_src = "src/repro_torch/kernels/expert_gemm/csrc/"
    gemm_tpu = "src/repro/kernels/expert_gemm/expert_gemm.py:44"
    flash_bwd_tpu = (f"backward of {flash_tpu}, XLA autodiff of "
                     f"src/repro/models/layers.py:43 in the reference")
    # the shapes of the other LM configs (phase config-kernels), beside the
    # qwen3-moe shapes each kernel is held at
    config_labels = {
        "flash_attention_fwd_wgmma": ("smollm train", "deepseek prefill"),
        "flash_attention_bwd_wgmma": ("smollm train", "deepseek G1",
                                      "dbrx G6"),
        "expert_gemm_wgmma": tuple(f"dbrx prefill {p}"
                                   for p in ("gate", "up", "down")),
        "expert_gemm_skinny": tuple(f"dbrx decode {p}"
                                    for p in ("gate", "up", "down"))}
    for name, src, line, labels, launches, path in (
            ("flash_attention_fwd_wgmma",
             flash_src + "flash_attention_fwd_wgmma.cu", flash_tpu,
             ("prefill", "ragged"), launches_lm, "serve-lm"),
            # the first kernel keeps the f32 and the odd-hd bf16 calls: the
            # SMOKE model's f32 attention on the card launches it
            ("flash_attention_fwd", flash_src + "flash_attention_fwd.cu",
             flash_tpu, ("hd40",), launches_agree, "lm-agreement"),
            ("flash_attention_bwd_wgmma",
             flash_src + "flash_attention_bwd_wgmma.cu", flash_bwd_tpu,
             ("train", "ragged"), launches_train, "train-lm"),
            # the first backward kernel keeps f32 and the other head dims:
            # the SMOKE model's f32 training on the card launches it
            ("flash_attention_bwd", flash_src + "flash_attention_bwd.cu",
             flash_bwd_tpu, ("f32 hd16", "hd40"), launches_train_agree,
             "train-agreement"),
            ("expert_gemm_wgmma", gemm_src + "expert_gemm_wgmma.cu",
             gemm_tpu, ("prefill gate", "prefill up", "prefill down",
                        "train gate dX", "train gate dW", "train down dX",
                        "train down dW"),
             launches_lm, "serve-lm"),
            ("expert_gemm_skinny", gemm_src + "expert_gemm_wgmma.cu",
             gemm_tpu, ("decode gate", "decode down"), launches_lm,
             "serve-lm"),
            # the first GEMM kernel keeps f32 and the bf16 calls TMA cannot
            # address: the SMOKE model's f32 MoE on the card launches it
            ("expert_gemm", gemm_src + "expert_gemm.cu", gemm_tpu,
             ("decode gate f32", "decode gate bf16 misaligned"),
             launches_agree, "lm-agreement")):
        check(launches[name] > 0, f"{path} never launched {name}")
        labels = labels + config_labels.get(name, ())
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
            "launches_train": launches_train[name],
            "launches_train_agreement": launches_train_agree[name],
            "launches_serve_lm_configs": launches_configs.get(name, 0),
            "launches_train_smollm": launches_smol[name],
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
