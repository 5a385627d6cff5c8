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
   backward products at the train shapes (dX = dY·Wᵀ on
   ``expert_gemm_dx`` and dW = Σ_g Xᵀ·dY on ``expert_gemm_dw``, of the gate
   and down products, G 4, C 88) against their plain versions (within
   2e-2 of each element and of the output's RMS; two launches bitwise
   equal), timed beside ``torch.bmm`` (dX: W as op T; dW: on transposed
   copies), the first backward's route (the tiles variant on the copies)
   and the plain-torch copies it needed. Then
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
   wgmma backward kernel and none on the first one, 6 expert GEMMs of
   the tiles variant — 3 forward, 3 recompute — and 3 each of the
   backward's ``expert_gemm_dx`` and ``expert_gemm_dw``), and
   the same 5 steps run again from the same seed without the loop (no
   checkpoint): losses and grad norms must be bitwise equal, and the
   first run's final state is kept as a 64-bit digest per leaf; then
   train-sharded — the same model, batches and schedule on a 2 × 2
   ("data", "model") mesh (the first four cards, or ``cuda:0`` four
   times on one card) under the reference train cell's ``fsdp`` rules:
   (a) ZeRO-3 (batch P("data", None)) for 2 steps, the elastic plan for 2
   failed devices ((2, 2) → (1, 2), half the batch rows lost), the state
   resharded onto the first two positions and 3 more steps — losses, grad
   norms and every leaf's digest must equal train-lm's first run bit for
   bit; (b) expert parallelism (``act_spec`` P("data", None, None): each
   "model" shard computes its 64 experts where they live, and the head's
   vocab blocks stay where they lie) for 2 steps twice on the 2 × 2 mesh,
   bitwise equal, and on ``make_host_mesh()``, the losses within
   ``SHARD_LOSS_RTOL`` of the host mesh's and of train-lm's first two;
   (c) the cell's one microbatch and (d) a MoE group over both shards
   (see ``phase_train_sharded``); the head's and the gathers' bytes held
   to ``head_want`` and ``fsdp_gather_want`` a step; per step
   the time, tokens/s, peak memory, state bytes per mesh position and
   the mesh's collective bytes, and the launches checked exactly (per
   step 8 flash forwards and 4 backwards on the TMA + wgmma kernels; the
   expert GEMM 24 tiles, 12 dX and 12 dW with the experts gathered, 48,
   24 and 24 with 2 expert shards; the first kernels none); then
   train-smollm — smollm-135m ``FULL`` at its whole depth (30 layers, tied
   embeddings, ``remat="dots"``), f32 masters, 5 ``TrainLoop`` steps of
   8 × 4,096 tokens in 2 microbatches on ``TokenPipeline(49152, 8, 4096,
   seed=0)``: per step loss, grad norm, step time and tokens/s, the peak
   memory; the loss must fall, every flash launch must be on the TMA +
   wgmma kernels (2 forwards — the forward and the dots recompute — and 1
   backward per step, microbatch and layer), and one more step's
   gradients under ``"dots"`` and under ``"none"`` must be bitwise equal;
   then train-sharded-tp2d — training on the 2 × 2 mesh under the
   reference's ``tp2d`` rules, split as its partitioner splits them
   (``train.state.make_tp2d_train_step``: Megatron over "model" × ZeRO
   over "data" — each weight's "model" block gathered along "data" and
   multiplied at every position, a row block's partials and a column
   block's dX partials summed over "model", the heads and the experts
   split over "model", the cross entropy per vocab block with only
   per-row statistics crossing "model"; one round per microbatch, its
   rows split over "data"; the clip's norm one scalar all-reduce): (i)
   train-lm's model, batches and schedule (``act_spec``, batch over
   "data") at the reference train cell's one microbatch, 2 steps, then 2
   more from the seed, bitwise equal; (iii) (i) with ``moe_shard="ffn"``
   (each expert's d_ff over "model"), 2 steps; (ii) smollm-135m whole with
   its tied head (d over "data", V over "model"; its 9 heads gathered at
   both "model" positions), train-smollm's batches in its 2 microbatches,
   2 steps; each step's loss
   within ``TP_TRAIN_LOSS_RTOL`` and grad norm within
   ``TP_TRAIN_NORM_RTOL`` of a bf16 one-card run at the same
   microbatches ((i), (iii): one made in the phase at the mesh's one
   microbatch; (ii): train-smollm's), every collective's bytes
   equal to ``tp2d_bytes_want`` (none of ``block_matmul``'s), the peak
   under ``TP_TRAIN_PEAK``, the launches exactly ``tp2d_launch_want``'s
   (per position, layer and round a flash forward, again in the
   recompute, and a backward; 3 expert products, 3 dX, 3 dW); per step
   the bytes by collective, time, tokens/s, peak and state bytes per
   position, and for (i) and (iii) step 0's top-8 choices that differ
   from one card's per layer; each leaf's AdamW first moment after the 2
   steps (a sum of gradients of the initial weights) within
   ``TP_LEAF_FACTOR`` times an f32 one-card run's gap from that bf16
   one-card run's, at the same microbatches; and the first input that each kernel took at each
   shape ((i)'s second run and (iii): flash forward and backward, the
   expert GEMM's tiles, dX and dW; (ii): flash) held against its plain
   version and timed beside SDPA or cuBLAS, with its bound;
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

16. bst-agreement — BST ``SMOKE`` in f32 on the card and on the CPU from
    one set of weights: serve_p99 click probabilities and retrieval scores
    within 1e-5 relative, the train cell's loss within 1e-4 relative and
    every gradient leaf within train-agreement's tolerance; then
    serve-bst — BST ``FULL`` (embed 32, 20 + 1 positions, 8 heads, MLP
    1,024-512-256, a 4,194,304-item table; seeded f32 weights) serving
    serve_p99 (512 users), serve_bulk (262,144) and retrieval_cand (1 user
    against 1,000,448 candidates): p50/p99 over 20 warm calls and peak
    memory each; then train-bst — ``FULL`` at train_batch's 65,536 users,
    3 steps of ``make_train_step(model.loss, TrainConfig())`` twice from
    one seed, losses and grad norms bitwise equal, step s, samples/s, peak
    memory;
17. gnn-agreement — SchNet, DimeNet, MeshGraphNet and GraphCast ``SMOKE``
    (f32) on their full_graph_sm cells, card against CPU: predictions
    within 1e-5 of the largest, loss and every gradient leaf within
    train-agreement's tolerances; then train-gnn — each at ``FULL`` widths
    (bf16 message passing) on minibatch_lg's published sizes (N 169,984, E
    168,960, d_feat 602; DimeNet 1,351,680 triplets; GraphCast's
    refinement-6 multimesh under that grid), SchNet and DimeNet also on
    molecule (N 3,840, E 16,384): 3 steps twice from one seed, bitwise
    equal, step s, arcs/s, peak memory. No kernel of the port lies on
    these paths: every launch count set to 0 before each phase must read
    0 after it.
18. serve-sharded-lm (after serve-lm-configs) — on a 2 × 2 ("data",
    "model") mesh (the first four cards, or ``cuda:0`` four times: a
    check, not a speedup), the KV cache placed by ``lm_cache_specs`` and
    never gathered (``distrib/serving.py``), split as the reference's
    partitioner splits its jitted steps. (i) qwen3-moe-30b-a3b at its
    published widths, serve-lm's 8 layers and seeded bf16 weights,
    serve-lm's 2 × 4,096 prompt and 16 tokens, the batch whole: prefill
    under the reference prefill cell's ``fsdp`` rules, decode with the
    weights where they lie (every product on its weight blocks' holders,
    ``embed`` looked up where its blocks lie, the experts where they
    live; cache sequence-split over all four positions). (ii) the same
    model, 16 × 2,048 and 8 tokens, the batch over "data" (the cache's
    sequence over "model"): prefill under ``fsdp`` (the prefill cell's
    default: each batch shard's home gathers each layer from its group,
    ``all_gather``, the experts where they live, ``expert_send``; the
    cache assembled from both homes), decode under ``tp2d`` as the
    reference's HLO splits it: each position holds its batch shard's
    rows, gathers the column weights' "model" blocks along "data"
    (``tp_zero_gather``), moves the rows to the row blocks and the head
    where they lie (``tp_rows_gather``, ``tp_rows_scatter``), sums over
    "model" (``tp_model_sum``), the heads and experts over "model", the
    attention split over the cache's sequence slices. (iii) deepseek-7b
    at its published widths and all 30 layers, 16 × 1,024 and 8 tokens,
    the prefill too under ``tp2d`` split as the reference's HLO splits it
    (every weight's "model" block gathered along "data" but the head's)
    (its one-card run first, its caches freed before the mesh is
    placed). (iv) qwen3-moe as (ii) with ``moe_shard="ffn"`` (every
    expert's d_ff over "model"), the prefill under ``tp2d`` as in (iii).
    Against the model on one card: prefill logits bitwise in (i), within
    serve-lm's bf16 consistency bounds (``LM_CONSIST_ATOL``,
    ``LM_CONSIST_CORR``) in (ii)–(iv); decode teacher-forced with the
    one-card run's tokens within them at every step; greedy tokens
    agreeing printed; two mesh runs bitwise equal; the bytes per
    collective and per receiving position: in (i) a decode step moves no
    parameter (no ``all_gather``; the lookup's looked-up rows only,
    ``emb_rows_model`` and ``emb_rows_home`` as ``lookup_bytes`` works
    them out), in (ii)–(iv) a decode step's bytes and the ``tp2d``
    prefills' equal ``serve_tp2d_bytes_want`` by name (the lookup as the
    reference's partitioner forms it, ``lookup_want``; one line a case
    prints its bytes by name and axis), (ii)'s ``fsdp`` prefill's
    ``serve_fsdp_bytes_want``, the weights move along "data" only
    and the sums along "model" only (by axis, from ``Mesh.moves``); the
    launches exactly ``sharded_lm_launches``' (in (i) each of the 2
    expert shards launches its own products, in (ii)–(iv) every position
    its heads and experts); for qwen3-moe the decode
    tokens whose top-8 experts differ from one card's, per layer; the
    flash and expert GEMM inputs of the second run captured (one per
    kernel and shape) and held against their plain versions within
    LM_KERNEL_RTOL, as phase 3 holds serve-lm's, and timed in (ii)–(iv)
    beside SDPA and batched ``torch.matmul``; wall times and the step's
    roofline (``launch/roofline.py``: ``lm_model_flops`` /
    ``lm_memory_bytes`` at the run's batch, length and depth over the
    H100's rates) with the measured time's share of it. (v) fault 6's
    input: the qwen3-moe SMOKE config with 16 experts in f32,
    ``moe_group_size`` 16, 16 × 16 tokens with every row row 0's, so one
    decode step's MoE group spans both batch shards and the reference
    drops the second shard's slots: the split prefill and one decode step
    within 1e-5 of the largest logit of one card's ``prefill`` /
    ``decode_step``, the step's bytes ``serve_tp2d_bytes_want``'s with the
    group's exchange (``moe_group_probs``, ``moe_group_dispatch``). (vi)
    fault 7's case: qwen3-moe-30b-a3b at its published widths, serve-lm's
    8 layers, an ``fsdp`` prefill of 16 × 256 tokens with the batch over
    "data" and ``moe_group_size`` 4,096, so one group spans both batch
    shards: both shards' rows run at the first home and the second's keys
    and values go to its home (``prefill_span``; the head multiplies the
    run's last rows where its blocks lie); logits within
    serve-lm's bf16 consistency bounds of one card's (bitwise printed),
    bytes ``serve_fsdp_bytes_want``'s, launches exactly (flash once a
    layer, the expert products at both expert shards), the flash and tiles
    inputs held and timed (``hold_captured``);
19. igpm-cells (after the CLI) — the paper's own cell at the four Table
    III shapes' published sizes (friends2008: 224,879 vertices, 7,744,000
    arcs; L 4, 5 sweeps): the label-RWR refresh on one card through an ELL
    mirror and ``ell_spmm`` (3 runs, bitwise equal), the arc-sharded
    refresh on the 2 × 2 mesh (two arc blocks, one mirror each) and the
    plain COO refresh on the CPU; card ≡ CPU and mesh ≡ card within
    ``IGPM_RWR_TOL`` of the largest entry; ELL build s, refresh ms, the
    mesh's bytes, launches (checked exactly), the refresh's bound by the
    kernel table's rule (per sweep the mirror, the iterate and the sum once
    each: ``spmm_bound``) with its gather floor and share, and the
    reference's analytic roofline (``igpm_model_flops`` /
    ``igpm_memory_bytes``) with its share.
20. examples (after the CLI) — the port's three example entry points
    (``src/repro_torch/examples``) on the card. quickstart at its own
    settings (the friends2008 twin at 0.01: 2,248 vertices, 38,719 edges;
    Batch, Inc and Adaptive, a warm and a measured pass of 8 steps each;
    the sweeps on ``ell_spmm`` / ``ell_reach``): Batch's and Inc's
    per-step counts and stores after every step equal a CPU run of the
    same function with ``backend="ell"`` (keys and exact flags, goodness
    within 1e-4, ``phase_small_agreement``'s rule), the ELL launches
    counted and the first input of each sweep kind held against the plain
    versions; pipeline and wall time per matcher and the speed-ups
    printed. dynamic_gnn_serving (2,048 nodes, 16,384 edges, 6 steps; the
    encoder's weights, the features and the DQN drawn on the CPU and
    copied): recompute masks, fractions and c equal a CPU run's under one
    seeded reward time, embeddings within 1e-5 of their largest entry, no
    port kernel launched. train_lm: ``tiny`` 60 steps whole, and 50 steps
    then a restart from the step-49 checkpoint to 60 whose steps 50–59
    and final state are bitwise the whole run's; the f32 flash forward
    and backward (``flash_attention_fwd.cu``, ``flash_attention_bwd.cu``)
    launched once per layer and step and their captured inputs held
    against the plain versions; ``smollm`` 10 steps with a finite, falling
    loss.

Then a ``{"kernels": [...]}`` JSON line (every kernel with its serve and
train launches, train-sharded's and train-sharded-tp2d's among them, both
flash backward kernels too), the card line,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line. ``--profile`` adds a device-time profile of one step of each
served path (on the mesh, the device and host time under each
collective's range, the lookup's ``emb_*`` ranges summed on a line of
their own).
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
# train-sharded (b): losses against train-lm's first two, relative. The
# parameters are train-lm's (step 0's lr is 0 under its warmup); only the
# cross entropy differs: all logits in one product (the vocab-parallel
# form) against 512-token chunks, bf16 logits rounded from sums in
# another order. Also (b) on 2 x 2 against the host mesh and (c), (d)
# against one card: the head's vocab blocks where they lie fold the
# log-sum-exp and add the dX partials over the blocks
SHARD_LOSS_RTOL = 1e-4
# train-sharded-tp2d: the tp2d step's losses and grad norms against the
# one-card runs' first two steps (train-lm's, train-smollm's), relative:
# the row blocks' partials and the vocab blocks' statistics fold over
# "model" in another order than one product, so the router may flip a
# near-tie among the top 8; the peak allowed on the card
TP_TRAIN_LOSS_RTOL, TP_TRAIN_NORM_RTOL = 1e-3, 1e-2
TP_TRAIN_STEPS = 2
TP_TRAIN_PEAK = 75e9
# train-sharded-tp2d (i), (iii): the reference train cell's microbatches
# (``make_train_step(model.loss, TCFG)``), the rows of each split over
# "data"; (ii) takes train-smollm's SMOL_MICRO
TP_MICRO = 1
# train-sharded (d) and train-sharded-tp2d (iv): train-lm's model on 2 x
# 2,048 tokens with MoE groups of 4,096 (the cells' cap), so one group
# spans both batch shards of the 2 x 2 mesh (fault 8 under tp2d)
SPAN_BATCH, SPAN_SEQ, SPAN_GROUP = 2, 2048, 4096
# train-sharded-tp2d's leaf check: per leaf, ||m - m_card|| / ||m_card||
# of AdamW's first moment after TP_TRAIN_STEPS steps (a sum of both steps'
# clipped gradients, all of the initial weights), mesh against one card,
# at most this many times the same gap of an f32 one-card run (the
# control: what bf16 rounding and the router flips it causes do to that
# leaf)
TP_LEAF_FACTOR = 2.0
# train-agreement: card against CPU, 3 steps of 2 microbatches
AGREE_STEPS = 3
AGREE_LOSS_RTOL = 1e-4
# step-0 gradients, card against CPU: rtol plus this share of the leaf's
# largest entry (f32 sums in another order through routing and softmax,
# the tolerance tests/test_torch_train.py holds the port to against JAX)
AGREE_GRAD_RTOL, AGREE_GRAD_FLOOR = 1e-4, 1e-5
# bst-agreement and gnn-agreement, card against CPU in f32: BST's click
# probabilities and retrieval scores to this rtol (atol a tenth of it),
# GNN predictions to this share of the largest; the losses and gradients
# take train-agreement's tolerances (those of the CPU tests against JAX)
BST_AGREE_TOL = 1e-5
BST_REPS = 20          # serve-bst warm calls per shape
BST_TRAIN_STEPS = 3    # train-bst steps per run (two runs, bitwise)
# train-gnn: (arch, cell) at FULL widths and the published cell sizes;
# ogb_products (61,859,328 arcs) runs in the dry run only: MeshGraphNet's
# edge-MLP input alone is 47.5 GB a layer, more than one card holds
# (ROADMAP item 5)
GNN_TRAIN_CELLS = (("schnet", "minibatch_lg"), ("schnet", "molecule"),
                   ("dimenet", "minibatch_lg"), ("dimenet", "molecule"),
                   ("meshgraphnet", "minibatch_lg"),
                   ("graphcast", "minibatch_lg"))
GNN_TRAIN_STEPS = 3    # per run (two runs, bitwise)
# train-sharded-gnn: the four GNNs of train-gnn on minibatch_lg over a 2 × 2
# mesh, the edge arrays in 2 blocks. The blocks' bf16 partial sums fold in
# block order where one card adds every edge in one serial sum, so each fold
# on the path to the loss may move it by one more bf16 rounding: step 0's
# loss is held to FOLDS[kind] · 2^-7 (one bf16 ulp, relative, per fold: one
# per layer, DimeNet's triplet scatter per block plus its output sum),
# written before the first card run
GNN_FOLDS = {"schnet": 3, "dimenet": 7, "meshgraphnet": 15, "graphcast": 16}
GNN_FOLD_ULP = 2.0 ** -7
# train-sharded-bst: the mesh's serve outputs against one card's, as a share
# of the largest |value| (f32: a row subset may take another GEMM kernel)
BST_MESH_TOL = 1e-5
# train-sharded-bst: the cell's step at its one microbatch over the two
# batch shards against one card's at one microbatch, loss and grad norm
# relative (f32, TF32 off: the loss a sum of two half-batch sums, each
# half's products perhaps on another GEMM kernel); also its two
# microbatches against one card's at two (mlp_w0's column blocks where
# they lie: the next product's partials added over them)
BST_M1_RTOL = 1e-5
# LSE of the forward kernels against a plain logsumexp (f32 statistics)
LSE_RTOL, LSE_ATOL = 1e-5, 1e-4
REPS = 20          # timed launches per kernel measurement
INC_STEPS = 4      # serve-inc steps
BATCH_STEPS = 2    # serve-batch steps
# serve-adaptive steps: transitions reach the replay ring from step 1 on, so
# the ring holds replay_batch = 16 at step 16 and steps 16-19 learn
ADAPT_STEPS = 20
LOSS_RTOL = 1e-5   # TD losses, card against CPU (adaptive agreement)
# serve-sharded-lm: traffic (ii) and (iv), the batch split over "data"
SHARD_SERVE_BATCH, SHARD_SERVE_PROMPT, SHARD_SERVE_TOKENS = 16, 2048, 8
# serve-sharded-lm (iii): deepseek-7b whole, prefill and decode under tp2d
TP_SERVE_BATCH, TP_SERVE_PROMPT, TP_SERVE_TOKENS = 16, 1024, 8
# serve-sharded-lm (vi), fault 7: an fsdp prefill of 16 prompts of 256
# tokens with the batch over "data" (the cells' rule at B >= 16) and MoE
# groups of 4,096 tokens (the cells' cap), so one group spans both batch
# shards of 8 x 256
FAULT7_BATCH, FAULT7_PROMPT, FAULT7_GROUP = 16, 256, 4096
# sharded logits against one card's: serve-lm's bf16 consistency bounds
# (LM_CONSIST_ATOL on |diff|, LM_CONSIST_CORR on the correlation), which
# hold one function computed in two orders in bf16. The split decode
# attention adds its slices' partials in f32 in another order and rounds to
# bf16, and each block product rounds its bf16 partials before the home adds
# them in f32; through 8 layers the logits moved by up to 0.0752 in (i),
# 0.0636 in (ii), 0.0236 in (iii) (an H100 80GB HBM3 at 700 W; PERF.md §6).
# The phase prints the decode tokens whose top-8 experts differ per layer,
# and holds the flash and both GEMM variants against their plain versions
# at the run's shapes.
# igpm-cells: refreshes timed per shape on one card; card vs CPU and mesh
# vs card as a share of the table's largest entry (f32 sums of a vertex's
# messages in another order: tens of terms, a few ulps each)
IGPM_REPS = 3
IGPM_RWR_TOL = 1e-5


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
    from repro_torch.kernels.expert_gemm.ref import (expert_gemm_dw_ref,
                                                     expert_gemm_dx_ref)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.measure import cuda_ms
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
    # TRAIN_GROUP tokens of one microbatch, capacity 88; each beside the
    # first backward's route (the tiles variant on transposed copies)
    moe = FULL.moe
    E, d, f = moe.n_experts, FULL.d_model, moe.d_ff_expert
    G = TRAIN_SEQ // TRAIN_GROUP
    C = moe_capacity(TRAIN_GROUP, E, moe.top_k)
    s_in = (2.0 / (d + f)) ** 0.5
    for label, din, dout in (("gate", d, f), ("down", f, d)):
        x = randn(G * E, C, din)
        w = randn(E, din, dout, scale=s_in)
        dy = randn(G * E, C, dout, scale=(G * C) ** -0.5)

        def x_dy_copies():
            return (x.view(G, E, C, din).permute(1, 3, 0, 2)
                    .reshape(E, din, G * C),
                    dy.view(G, E, C, dout).transpose(0, 1)
                    .reshape(E, G * C, dout))
        t_w = cuda_ms(lambda: w.transpose(1, 2).contiguous(), reps)
        t_xy = cuda_ms(x_dy_copies, reps)
        wt = w.transpose(1, 2).contiguous()
        xt, dyt = x_dy_copies()
        # the yardsticks: for dX, cuBLAS on dY as (E, G·C, f) with W read
        # where it lies (op T); for dW, cuBLAS on the copies
        for name, prod, inputs, fn, ref, lib, copies_route in (
                (gemm_ops.DX, "dX", (dy, w),
                 lambda: gemm_ops.expert_gemm_dx(dy, w),
                 lambda: expert_gemm_dx_ref(dy, w),
                 lambda: torch.bmm(dyt, w.mT),
                 lambda: gemm_ops.expert_gemm(dy, wt)),
                (gemm_ops.DW, "dW", (x, dy),
                 lambda: gemm_ops.expert_gemm_dw(x, dy, E),
                 lambda: expert_gemm_dw_ref(x, dy, E),
                 lambda: torch.bmm(xt, dyt),
                 lambda: gemm_ops.expert_gemm(xt, dyt))):
            rows[(name, f"train {label}")] = gemm_bwd_row(
                name, f"train {label} {prod}", fn, ref, lib, copies_route,
                inputs, G * E * C * din * dout, reps)
        say(f"  expert GEMM backward copies (plain torch, the first "
            f"backward's route), train {label}: W^T {t_w:.4f} ms, X and dY "
            f"for dW {t_xy:.4f} ms")
        rows[("gemm transposes", label)] = dict(w_ms=t_w, x_dy_ms=t_xy)
        del x, w, dy, wt, xt, dyt
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows


def gemm_bwd_row(name: str, label: str, fn, ref, lib, copies_route, inputs,
                 macs: int, reps: int) -> dict:
    """One backward product ``fn()`` held against its plain version
    ``ref()`` (one launch of kernel ``name`` and none other, two launches
    bitwise equal, within ``LM_KERNEL_RTOL`` of each element and of the
    output's RMS), timed beside one PyTorch call ``lib()``, the first
    backward's route ``copies_route()`` (its copies not included), and its
    bound over ``inputs`` and the output."""
    import torch
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.measure import H100_BF16_FLOPS, cuda_ms
    before = dict(gemm_ops.LAUNCHES)
    y = fn()
    check({k: gemm_ops.LAUNCHES[k] - before[k] for k in before}
          == {k: int(k == name) for k in before},
          f"{name} {label}: not one launch of {name} ({gemm_ops.LAUNCHES})")
    want = ref()
    atol = LM_KERNEL_RTOL * float(want.float().pow(2).mean().sqrt())
    err, used = lm_check(f"{name} {label}", y, fn(), want, atol)
    del want
    torch.cuda.empty_cache()
    ms = cuda_ms(fn, reps)
    plain = cuda_ms(ref, 3, warmup=1)
    lib_ms = cuda_ms(lib, reps)
    old_ms = cuda_ms(copies_route, reps)
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, y))
    b_ms, b_by = bound(nbytes, 2 * macs, H100_BF16_FLOPS)
    say(f"  {name} {label}: {tuple(inputs[0].shape)} x "
        f"{tuple(inputs[1].shape)} -> {tuple(y.shape)} bf16: max_abs_err="
        f"{err:.3e} ({used:.3f} of the allowance) run-to-run bitwise equal;"
        f" {ms:.4f} ms, plain {plain:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
        f"first backward's product on the copies {old_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes} B, {2 * macs} flop)")
    out = dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=2 * macs,
               copies_route_ms=old_ms, max_abs_err=err, tol_used=used,
               shape=f"{tuple(inputs[0].shape)} x {tuple(inputs[1].shape)} "
                     f"bf16")
    del y
    torch.cuda.empty_cache()
    return out


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
                 "expert_gemm": 0, "expert_gemm_dx": 0, "expert_gemm_dw": 0}
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
                "expert_gemm": 0, "expert_gemm_dx": 0, "expert_gemm_dw": 0}
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
    """Dicts, lists and named tuples of tensors (``None`` kept) on
    ``dev``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(v, dev) for v in tree))
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
    # backward passes (one flash backward; a dX and a dW per product, with
    # no transposed copy and no tiles launch)
    per = TRAIN_STEPS * TRAIN_MICRO * TRAIN_LAYERS
    want = {"flash_attention_fwd_wgmma": 2 * per,
            "flash_attention_bwd_wgmma": per, "flash_attention_bwd": 0,
            "flash_attention_fwd": 0, "expert_gemm_wgmma": 6 * per,
            "expert_gemm_dx": 3 * per, "expert_gemm_dw": 3 * per,
            "expert_gemm_skinny": 0, "expert_gemm": 0}
    got = {k: launches[k] for k in want}
    check(got == want, f"train-lm launches {got}, want {want}")
    # the final state's bits, which train-sharded must reach across its
    # mesh and its elastic re-mesh
    t0 = time.perf_counter()
    digests = state_digests(loop.state)
    say(f"  train-lm final state: {len(digests)} leaf digests "
        f"({time.perf_counter() - t0:.2f} s)")
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
        repeat_bitwise=again == first, digests=digests)


def leaf_digest(t) -> int:
    """A 64-bit digest of a 4-byte tensor's bits, on its device: per chunk
    of 2**24 elements Σ bits·w mod 2**64 with fixed odd pseudo-random
    weights w, the chunk sums folded in order (acc·1,000,003 + sum). Equal
    bits give equal digests; a changed bit changes the chunk's sum."""
    import torch
    bits = t.detach().reshape(-1).view(torch.int32)
    chunk = 1 << 24
    gen = torch.Generator(device=bits.device).manual_seed(1)
    w = torch.randint(0, 1 << 62, (min(chunk, max(bits.numel(), 1)),),
                      generator=gen, device=bits.device) * 2 + 1
    acc = torch.zeros((), dtype=torch.int64, device=bits.device)
    for lo in range(0, bits.numel(), chunk):
        part = bits[lo:lo + chunk].to(torch.int64)
        acc = acc * 1_000_003 + torch.sum(part * w[:part.numel()])
    return int(acc) ^ bits.numel()


def state_digests(state):
    """``leaf_digest`` of every params, m and v leaf of a train state in
    ``tree_leaves`` order, a sharded leaf gathered whole first (one leaf at
    a time)."""
    from repro_torch.distrib.sharding import ShardedTensor, gather
    from repro_torch.optim.adamw import tree_leaves
    out = []
    for tree in (state.params, state.opt.m, state.opt.v):
        for x in tree_leaves(tree):
            whole = gather(x) if isinstance(x, ShardedTensor) else x
            out.append(leaf_digest(whole))
            del whole
    return out


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


def sharded_launch_want(n_model: int,
                        forwards: int = TRAIN_MICRO) -> dict:
    """Launches of one train-sharded step (``forwards`` forwards of 2
    layers, one a microbatch at a home, ``remat="full"``): per forward and
    layer 2 flash forwards (forward and recompute) and 1 backward on the
    TMA + wgmma kernels, and per expert shard 6 tiles products (3 forward,
    3 recompute), 3 dX and 3 dW; ``n_model`` expert shards (1 when the
    experts are gathered whole)."""
    per = forwards * TRAIN_LAYERS
    return {"flash_attention_fwd_wgmma": 2 * per,
            "flash_attention_bwd_wgmma": per, "flash_attention_bwd": 0,
            "flash_attention_fwd": 0,
            "expert_gemm_wgmma": 6 * per * n_model,
            "expert_gemm_dx": 3 * per * n_model,
            "expert_gemm_dw": 3 * per * n_model,
            "expert_gemm_skinny": 0, "expert_gemm": 0}


def sharded_steps(tag, step, state, mesh, pipe, first: int, n: int,
                  n_model: int, total: dict, prof=None, want=None,
                  label: str = "train-sharded",
                  tokens: int = TRAIN_BATCH * TRAIN_SEQ, lookup=None,
                  head=None):
    """Run ``n`` sharded steps on batches ``first``, …: per step the
    launches (set to 0 before, read after, checked exactly against
    ``want``, by default ``sharded_launch_want(n_model)``), loss, grad
    norm, time, tokens/s, peak memory, bytes held per mesh position and
    the collectives' bytes, the lookup's (``emb_*``) checked exactly
    against ``lookup`` where given, the head's (``head_*``) and the
    gathers' (``all_gather*``) against ``head`` (:func:`head_want`,
    :func:`fsdp_gather_want`) where given. Returns (state, rows)."""
    import torch
    from repro_torch.distrib.sharding import position_bytes
    rows = []
    want = sharded_launch_want(n_model) if want is None else want
    for i in range(first, first + n):
        batch = [torch.as_tensor(a, device="cuda") for a in pipe.batch_at(i)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_bytes()
        reset_all_counts()
        t0 = time.perf_counter()
        if prof is not None and i == first + 1:
            state, m = prof.step(1, lambda: step(state, *batch))
        else:
            state, m = step(state, *batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: v for k, v in read_all_counts().items() if k in want}
        for k, v in read_all_counts().items():
            total[k] = total.get(k, 0) + v
        held = position_bytes(state)
        row = dict(step=i, loss=loss, grad_norm=gnorm, step_s=dt,
                   tokens_per_s=tokens / dt,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   position_bytes=held, collective_bytes=dict(mesh.bytes),
                   lookup=lookup_by_axis(mesh), launches=got)
        rows.append(row)
        say(f"  {label} {tag} step {i} on {mesh.shape}: loss "
            f"{loss:.4f} grad_norm {gnorm:.4f} step {dt:.3f} s "
            f"({tokens / dt:.1f} tok/s) peak {row['peak_bytes']} B; state "
            f"bytes per position {held}; collective bytes "
            f"{dict(mesh.bytes)}")
        check(got == want, f"{label} {tag} step {i}: launches {got}, "
                           f"want {want}")
        emb = {k: v for k, v in mesh.bytes.items() if k.startswith("emb_")}
        check(lookup is None or emb == lookup,
              f"{label} {tag} step {i}: the lookup moved {emb}, the formula "
              f"{lookup}")
        moved = {k: v for k, v in mesh.bytes.items()
                 if k.startswith(("head_", "all_gather"))}
        check(head is None or moved == head,
              f"{label} {tag} step {i}: the head and the gathers moved "
              f"{moved}, the formulas {head}")
    return state, rows


def phase_train_sharded(train_lm: dict, profile: bool = False):
    """qwen3-moe-30b-a3b at train-lm's widths, depth, batches and
    schedule on a 2 × 2 ("data", "model") mesh — the first four cards, or
    ``cuda:0`` four times on one card — under the reference train cell's
    ``fsdp`` rules. (a) ZeRO-3, batch P("data", None): 2 steps, the
    elastic plan for 2 failed devices ((2, 2) → (1, 2)), the state
    resharded onto the first 2 positions' devices, 3 more steps: losses,
    grad norms and every gathered leaf's digest bitwise train-lm's.
    (b) expert parallelism, ``act_spec`` P("data", None, None), the head
    where its blocks lie: 2 steps twice on the 2 × 2 mesh, bitwise equal,
    and on ``make_host_mesh()``, the losses within ``SHARD_LOSS_RTOL`` of
    the host mesh's and of train-lm's first two (the cross entropy's
    route and the head's blocks differ). (c) the LM cell's step: (b)'s model at
    the reference cell's one microbatch, its rows over the two batch
    shards, 2 steps, against a one-card ``make_train_step`` at one
    microbatch run here from the same seed, batches and schedule: losses
    within ``SHARD_LOSS_RTOL``; grad norms and each leaf's AdamW first
    moment within ``TP_LEAF_FACTOR`` times an f32 one-card control's gap;
    bytes (b)'s at M = D plus the sums over the homes (``loss_sum``,
    ``moe_aux_sum``), exactly, but the lookup and the head, whose two
    batch shards are looked up and multiplied at once; the peak printed.
    Every case's lookup of the table where its rows lie (``emb_*``) is
    held to :func:`fsdp_lookup_want` exactly, a step at a time, and its
    gathers (``all_gather*``) and (b)–(d)'s head where its blocks lie
    (``head_*``, the vocab-parallel route) to :func:`fsdp_gather_want` and
    :func:`head_want`: the head (qwen3's 151,936 entries, ``fit_spec``'s
    fallback over "data") is never gathered there. (d) (b)'s model on
    ``SPAN_BATCH`` x ``SPAN_SEQ`` tokens with MoE groups of
    ``SPAN_GROUP``: one group spans both batch shards, which run at the
    first home (``train_span``): held as (c) is, against one card's step
    at one microbatch and its f32 control. Launches checked exactly per
    step."""
    import dataclasses
    import torch
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.config.base import TrainConfig
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.distrib.fault import plan_elastic, reshard
    from repro_torch.distrib.sharding import (P, lm_param_specs,
                                              state_specs_like)
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.state import (make_sharded_train_step,
                                         new_sharded_train_state)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(FULL, n_layers=TRAIN_LAYERS)
    # train-lm's schedule (TrainConfig() would not give its bits)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    n_cards = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(4)] if n_cards >= 4
               else ["cuda:0"] * 4)
    mesh = Mesh((2, 2), ("data", "model"), devices)
    bspec = P("data", None)
    total = {}
    out = dict(mesh=str(mesh))

    def fresh(model, on):
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.float32)
        specs = state_specs_like(lm_param_specs(params, cfg, "fsdp"))
        state = new_sharded_train_state(params, on, specs)
        del params
        torch.cuda.empty_cache()
        return specs, state

    # (a) ZeRO-3 across the elastic re-mesh
    t0 = time.perf_counter()
    model = TransformerLM(cfg, moe_group_size=TRAIN_GROUP)
    specs, state = fresh(model, mesh)
    say(f"  train-sharded (a): {mesh}, fsdp specs: embed "
        f"{specs.params['embed']!r}, head {specs.params['head']!r}, "
        f"layer wq {specs.params['layers'][0]['wq']!r}, experts "
        f"{specs.params['layers'][0]['moe']['wg']!r}; placed in "
        f"{time.perf_counter() - t0:.2f} s")
    step = make_sharded_train_step(model.loss, tcfg, mesh, specs, bspec,
                                   TRAIN_MICRO)
    prof = CollectiveProfiler("train-sharded (a) 2x2") if profile else None
    # each batch shard's microbatch looked up alone, where the table's
    # rows lie (fsdp_lookup_want)
    per_shard = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
    calls_2x2 = [[(0, per_shard)], [(1, per_shard)]]
    lookup_2x2 = fsdp_lookup_want(cfg, (2, 2), calls_2x2, True)
    # the chunked route keeps its gathered head (fsdp_gather_want)
    state, rows_a = sharded_steps(
        "(a)", step, state, mesh, pipe, 0, 2, 1, total, prof,
        lookup=lookup_2x2,
        head=fsdp_gather_want(cfg, (2, 2), calls_2x2, False))
    if prof is not None:
        out["profile_a"] = prof.spans
    plan = plan_elastic(mesh.shape, mesh.axis_names, failed_devices=2)
    check(plan.new_shape == (1, 2) and plan.lost_batch_fraction == 0.5,
          f"train-sharded: elastic plan {plan}")
    small = Mesh(plan.new_shape, plan.axes,
                 mesh.devices[:plan.new_shape[0] * plan.new_shape[1]])
    t0 = time.perf_counter()
    mesh.reset_bytes()
    state = reshard(state, small, specs, donate=True)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    say(f"  train-sharded (a): {plan}; resharded onto {small} in "
        f"{reshard_s:.2f} s, {dict(mesh.bytes)} B moved")
    step = make_sharded_train_step(model.loss, tcfg, small, specs, bspec,
                                   TRAIN_MICRO)
    calls_small = [[(0, per_shard)]] * TRAIN_MICRO
    state, rows_a2 = sharded_steps(
        "(a)", step, state, small, pipe, 2, TRAIN_STEPS - 2, 1, total,
        lookup=fsdp_lookup_want(cfg, small.shape, calls_small, True),
        head=fsdp_gather_want(cfg, small.shape, calls_small, False))
    rows_a += rows_a2
    got = [(r["loss"], r["grad_norm"]) for r in rows_a]
    want = list(zip(train_lm["losses"], train_lm["grad_norm"]))
    digests = state_digests(state)
    same = [i for i, (a, b) in enumerate(zip(digests, train_lm["digests"]))
            if a != b]
    say(f"  train-sharded (a): (loss, grad_norm) {got}; bitwise train-lm's: "
        f"{got == want}; leaf digests equal: {len(digests) - len(same)} of "
        f"{len(digests)}")
    check(got == want, f"train-sharded (a): {got}, train-lm {want}")
    check(len(digests) == len(train_lm["digests"]) and not same,
          f"train-sharded (a): leaves {same} differ from train-lm's")
    del state, step
    torch.cuda.empty_cache()
    out.update(a=rows_a, plan=dict(new_shape=plan.new_shape,
                                   lost_batch_fraction=plan.
                                   lost_batch_fraction),
               reshard_s=reshard_s, bitwise_train_lm=True)

    # (b) expert parallelism and the head where it lies, twice on the
    # mesh and against the host mesh
    model = TransformerLM(cfg, moe_group_size=TRAIN_GROUP,
                          act_spec=P("data", None, None))
    head_b = dict(head_want(cfg, (2, 2), calls_2x2, True))
    gather_b = fsdp_gather_want(cfg, (2, 2), calls_2x2, True)
    parent = fsdp_gather_want(cfg, (2, 2), calls_2x2, True,
                              head_in_place=False)
    runs = {}
    for name, on, n_model in (("2x2", mesh, 2), ("2x2 again", mesh, 2),
                              ("host", make_host_mesh("cuda:0"), 1)):
        specs, state = fresh(model, on)
        step = make_sharded_train_step(model.loss, tcfg, on, specs, bspec,
                                       TRAIN_MICRO)
        prof = (CollectiveProfiler(f"train-sharded (b) {name}")
                if profile and name == "2x2" else None)
        state, rows = sharded_steps(
            f"(b) {name}", step, state, on, pipe, 0, 2, n_model, total, prof,
            lookup=lookup_2x2 if on is mesh else {},
            head={**head_b, **gather_b} if on is mesh else {})
        if prof is not None:
            out["profile_b"] = prof.spans
        runs[name] = (rows, state_digests(state))
        del state, step
        torch.cuda.empty_cache()
    (rows_ep, dig_ep), (rows_ep2, dig_ep2) = runs["2x2"], runs["2x2 again"]
    rows_host = runs["host"][0]
    ep = [(r["loss"], r["grad_norm"]) for r in rows_ep]
    ep2 = [(r["loss"], r["grad_norm"]) for r in rows_ep2]
    host = [(r["loss"], r["grad_norm"]) for r in rows_host]
    rel = max(abs(r["loss"] - w) / abs(w)
              for r, w in zip(rows_ep, train_lm["losses"]))
    rel_host = [abs(a / b - 1) for (a, _), (b, _) in zip(ep, host)]
    norm_host = [abs(a / b - 1) for (_, a), (_, b) in zip(ep, host)]
    say(f"  train-sharded (b): 2x2 {ep}; again {ep2}; bitwise equal: "
        f"{ep == ep2 and dig_ep == dig_ep2}; host mesh {host}: losses' "
        f"relative differences {rel_host}, grad norms' {norm_host} "
        f"(losses' bound {SHARD_LOSS_RTOL}); losses against train-lm's "
        f"first two: largest relative difference {rel:.3e} (tolerance "
        f"{SHARD_LOSS_RTOL})")
    say(f"  train-sharded (b): the head where its blocks lie, a step "
        f"(head_want) {head_b} = {sum(head_b.values())} B; all_gather "
        f"{gather_b.get('all_gather')} B and all_gather_grad "
        f"{gather_b.get('all_gather_grad')} B, where the parent, gathering "
        f"the head whole at each home, moved {parent.get('all_gather')} B "
        f"and {parent.get('all_gather_grad')} B")
    check(ep == ep2 and dig_ep == dig_ep2,
          "train-sharded (b): two runs on the 2x2 mesh differ")
    check(max(rel_host) <= SHARD_LOSS_RTOL,
          f"train-sharded (b): losses {ep} against the host mesh's {host}")
    check(rel <= SHARD_LOSS_RTOL,
          f"train-sharded (b): losses {rel:.3e} from train-lm's")
    out.update(b_2x2=rows_ep, b_host=rows_host, b_loss_max_rel=rel,
               b_host_rel=rel_host, b_host_norm_rel=norm_host,
               head_bytes=head_b, gather_bytes=gather_b,
               parent_gather_bytes=parent)

    # (c) the cell's step: the reference cell's one microbatch, its rows
    # over the two batch shards, one forward over both homes
    act = P("data", None, None)
    kw = dict(moe_group_size=TRAIN_GROUP, act_spec=act)
    card = one_card_steps(cfg, kw, tcfg, pipe, 1)
    ref = card.pop("moments")
    control = one_card_steps(dataclasses.replace(cfg, dtype="float32"), kw,
                             tcfg, pipe, 1, ref)
    specs, state = fresh(model, mesh)
    names = leaf_names(state.params)
    step = make_sharded_train_step(model.loss, tcfg, mesh, specs, bspec, 1,
                                   moe_span=model.moe_span)
    # the microbatch's two batch shards looked up, and their rows
    # multiplied by the head's blocks, at once
    half = TRAIN_BATCH // 2 * TRAIN_SEQ
    calls_c = [[(0, half), (1, half)]]
    lookup_c = fsdp_lookup_want(cfg, (2, 2), calls_c, True)
    head_c = head_want(cfg, (2, 2), calls_c, True)
    state, rows_c = sharded_steps(
        "(c)", step, state, mesh, pipe, 0, TP_TRAIN_STEPS, 2, total,
        lookup=lookup_c,
        head={**head_c, **fsdp_gather_want(cfg, (2, 2), calls_c, True)})
    gaps = moment_gaps(state, ref)
    del state, step, ref
    torch.cuda.empty_cache()
    E, L = cfg.moe.n_experts, cfg.n_layers
    again = 2 if cfg.remat in ("full", "dots") else 1
    # (b)'s moves at M = D but the lookup and the head, the lookup and the
    # head of both shards at once, and the sums over the two homes: each
    # home's loss sum and count, each layer's E aux means and E counts
    # (again in remat's recompute)
    bytes_want = {k: v for k, v in rows_ep[0]["collective_bytes"].items()
                  if not k.startswith(("emb_", "head_"))}
    bytes_want.update(lookup_c)
    bytes_want.update(head_c, loss_sum=2 * 8,
                      moe_aux_sum=again * L * 2 * 8 * E)
    off = [{k: (r["collective_bytes"].get(k), bytes_want.get(k))
            for k in set(r["collective_bytes"]) | set(bytes_want)
            if r["collective_bytes"].get(k) != bytes_want.get(k)}
           for r in rows_c]
    got = [(r["loss"], r["grad_norm"]) for r in rows_c]
    want = list(zip(card["losses"], card["grad_norm"]))
    rel = [abs(a / c - 1) for (a, _), (c, _) in zip(got, want)]
    norm = [abs(b / d - 1) for (_, b), (_, d) in zip(got, want)]
    norm_f32 = [abs(f / d - 1)
                for f, (_, d) in zip(control["grad_norm"], want)]
    peak = max(r["peak_bytes"] for r in rows_c)
    say(f"  train-sharded (c): the cell's step at 1 microbatch on {mesh}, "
        f"its rows over the 2 batch shards: (loss, grad_norm) {got}; one "
        f"card at 1 microbatch {want}; losses' relative differences {rel} "
        f"(bound {SHARD_LOSS_RTOL}); grad norms' {norm} against the f32 "
        f"control's {norm_f32} (bound {TP_LEAF_FACTOR} times); peak {peak} "
        f"B ((b) at 2 microbatches: "
        f"{max(r['peak_bytes'] for r in rows_ep)} B); bytes a step by the "
        f"formula {bytes_want}, steps off it {off}; warm step "
        f"{rows_c[-1]['step_s']:.3f} s against one card's "
        f"{card['step_s'][-1]:.3f} s")
    check(max(rel) <= SHARD_LOSS_RTOL,
          f"train-sharded (c): losses {got}, one card {want}")
    check(all(a <= TP_LEAF_FACTOR * b for a, b in zip(norm, norm_f32)),
          f"train-sharded (c): grad norms {norm} from one card's, the f32 "
          f"control's {norm_f32}")
    check(not any(off), f"train-sharded (c): bytes off the formula (got, "
                        f"want): {off}")
    out["c"] = dict(steps=rows_c, rel=rel, norm_rel=norm,
                    norm_rel_f32=norm_f32, peak_bytes=peak,
                    bytes_want=bytes_want,
                    leaves=hold_leaves("train-sharded (c)", names, gaps,
                                       control))

    # (d) a MoE group over both batch shards: the shards it spans computed
    # at the first one's home, the other's rows sent there
    model = TransformerLM(cfg, moe_group_size=SPAN_GROUP, act_spec=act)
    pipe_d = TokenPipeline(cfg.vocab_size, SPAN_BATCH, SPAN_SEQ, seed=0)
    kw_d = dict(moe_group_size=SPAN_GROUP, act_spec=act)
    card = one_card_steps(cfg, kw_d, tcfg, pipe_d, 1)
    ref = card.pop("moments")
    control = one_card_steps(dataclasses.replace(cfg, dtype="float32"),
                             kw_d, tcfg, pipe_d, 1, ref)
    specs, state = fresh(model, mesh)
    step = make_sharded_train_step(model.loss, tcfg, mesh, specs, bspec, 1,
                                   moe_span=model.moe_span)
    calls_d = [[(0, SPAN_BATCH * SPAN_SEQ)]]
    state, rows_d = sharded_steps(
        "(d)", step, state, mesh, pipe_d, 0, TP_TRAIN_STEPS, 2, total,
        want=sharded_launch_want(2, forwards=1),
        tokens=SPAN_BATCH * SPAN_SEQ,
        lookup=fsdp_lookup_want(cfg, (2, 2), calls_d, True),
        head={**head_want(cfg, (2, 2), calls_d, True),
              **fsdp_gather_want(cfg, (2, 2), calls_d, True)})
    gaps = moment_gaps(state, ref)
    del state, step, ref
    torch.cuda.empty_cache()
    got = [(r["loss"], r["grad_norm"]) for r in rows_d]
    want = list(zip(card["losses"], card["grad_norm"]))
    rel_d = [abs(a / c - 1) for (a, _), (c, _) in zip(got, want)]
    span_bytes = SPAN_BATCH // 2 * SPAN_SEQ * 4 * 2   # tokens and labels
    moved = [(r["collective_bytes"].get("train_span"),
              r["collective_bytes"].get("loss_sum"),
              r["collective_bytes"].get("moe_aux_sum")) for r in rows_d]
    say(f"  train-sharded (d): {SPAN_BATCH} x {SPAN_SEQ} tokens in MoE "
        f"groups of {SPAN_GROUP}: one group over both batch shards, both "
        f"computed at the first home; (loss, grad_norm) {got}; one card "
        f"{want}; losses' relative differences {rel_d} (bound "
        f"{SHARD_LOSS_RTOL}); bitwise: {got == want}; (train_span, "
        f"loss_sum, moe_aux_sum) bytes a step {moved} (want {span_bytes}, "
        f"none, none); peak {max(r['peak_bytes'] for r in rows_d)} B")
    check(max(rel_d) <= SHARD_LOSS_RTOL,
          f"train-sharded (d): {got} against one card's {want}")
    check(all(m == (span_bytes, None, None) for m in moved),
          f"train-sharded (d): moves {moved}")
    out["d"] = dict(steps=rows_d, rel=rel_d, span_bytes=span_bytes,
                    leaves=hold_leaves("train-sharded (d)", names, gaps,
                                       control))
    phase_s = time.perf_counter() - t_phase
    say(f"phase train-sharded: {phase_s:.1f} s wall")
    out["phase_s"] = phase_s
    return total, out


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
    record, moments = [], []

    def step_fn(st, *batch):
        st, m = inner(st, *batch)
        record.append({k: float(v) for k, v in m.items()})
        if len(record) == TP_TRAIN_STEPS:  # train-sharded-tp2d's leaf check
            moments.append(host_moments(st))
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
            "expert_gemm_dx": 0, "expert_gemm_dw": 0,
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
        dots_equals_none=not differ, phase_s=phase_s, moments=moments[0])


def leaf_names(tree, prefix: str = "") -> list:
    """The path of every leaf of a params tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, node in enumerate(tree)
                for n in leaf_names(node, f"{prefix}{i}.")]
    return [prefix[:-1]]


def host_moments(state) -> list:
    """A one-card train state's AdamW first moments, each leaf copied to
    the host, in ``tree_leaves`` order."""
    from repro_torch.optim.adamw import tree_leaves
    return [t.detach().cpu() for t in tree_leaves(state.opt.m)]


def moment_gaps(state, ref) -> list:
    """Per leaf, in ``tree_leaves`` order: ||m - m_ref|| / ||m_ref|| of a
    train state's AdamW first moment m (a sharded leaf gathered whole
    first, one leaf at a time) against ``ref`` (``host_moments``); 0 where
    both are 0."""
    from repro_torch.distrib.sharding import ShardedTensor, gather
    from repro_torch.optim.adamw import tree_leaves
    out = []
    for x, r in zip(tree_leaves(state.opt.m), ref):
        whole = gather(x) if isinstance(x, ShardedTensor) else x
        r = r.to(whole.device)
        diff, norm = float((whole - r).norm()), float(r.norm())
        out.append(diff / norm if norm else (0.0 if diff == 0 else
                                             float("inf")))
        del whole, r
    return out


def one_card_steps(cfg, model_kw: dict, tcfg, pipe, micro: int,
                   ref=None) -> dict:
    """``cfg``'s one-card step (``make_train_step`` at ``micro``
    microbatches; masters, seed and batches as the mesh's),
    ``TP_TRAIN_STEPS`` steps: each step's loss, grad norm and time. Without
    ``ref``, the AdamW first moments after the steps (``host_moments``):
    the reference that train-sharded-tp2d's mesh is held to at its own
    microbatches. With ``ref`` (such a run's moments), per leaf
    ``moment_gaps`` against it instead: run in f32 compute, the control of
    the leaf check — the size of a rounding-only difference in each leaf's
    gradients, router flips included."""
    import torch
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.state import make_train_step, new_train_state
    model = TransformerLM(cfg, **model_kw)
    state = new_train_state(model.init(
        torch.Generator(device="cuda").manual_seed(0), dtype=torch.float32))
    step = make_train_step(model.loss, tcfg, microbatches=micro)
    losses, norms, times = [], [], []
    for i in range(TP_TRAIN_STEPS):
        batch = [torch.as_tensor(a, device="cuda") for a in pipe.batch_at(i)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    tokens = pipe.batch * pipe.seq_len
    out = dict(losses=losses, grad_norm=norms, step_s=times,
               tokens_per_s=[tokens / t for t in times])
    if ref is None:
        out["moments"] = host_moments(state)
    else:
        out["gaps"] = moment_gaps(state, ref)
    del state, step, model
    torch.cuda.empty_cache()
    return out


class KernelCapture:
    """Wrap the flash and expert-GEMM wrappers a path calls to keep copies
    of the first inputs each kernel takes at each shape while ``armed``:
    ``inputs[(wrapper, kernel, shapes)] = (args, keywords)``. ``path``
    "serve": the flash forward as ``models.layers`` calls it and the expert
    GEMM; "train": the names the autograd functions ``FlashAttention``
    (forward and backward) and ``ExpertGemm`` (forward, dX, dW) look up in
    the ``ops`` modules when they run."""

    def __init__(self, path: str):
        from repro_torch.kernels.expert_gemm import ops as gemm_ops
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.models import layers
        if path == "serve":
            self.wrappers = [(layers, "flash_attention", flash_ops),
                             (gemm_ops, "expert_gemm", gemm_ops)]
        else:
            self.wrappers = (
                [(flash_ops, n, flash_ops)
                 for n in ("flash_attention", "flash_attention_bwd")]
                + [(gemm_ops, n, gemm_ops) for n in
                   ("expert_gemm", "expert_gemm_dx", "expert_gemm_dw")])
        self._orig = [getattr(m, n) for m, n, _ in self.wrappers]
        self.inputs = {}
        self.armed = False

    @staticmethod
    def _launched(before, after):
        names = [k for k in after if after[k] != before.get(k, 0)]
        return names[0] if len(names) == 1 else None

    def __enter__(self):
        import torch
        cap = self

        def spy(fn, ops, orig):
            def wrapped(*args, **kw):
                before = dict(ops.LAUNCHES)
                out = orig(*args, **kw)
                name = cap._launched(before, ops.LAUNCHES)
                key = (fn, name, tuple(tuple(a.shape) for a in args
                                       if torch.is_tensor(a)))
                if cap.armed and name and key not in cap.inputs:
                    cap.inputs[key] = (tuple(a.clone() if torch.is_tensor(a)
                                             else a for a in args), dict(kw))
                return out
            return wrapped

        for (mod, fn, ops), orig in zip(self.wrappers, self._orig):
            setattr(mod, fn, spy(fn, ops, orig))
        return self

    def __exit__(self, *exc):
        for (mod, fn, _), orig in zip(self.wrappers, self._orig):
            setattr(mod, fn, orig)
        return False

    def check_complete(self, label: str) -> None:
        """Fail unless every wrapper took at least one input."""
        got = {k[0] for k in self.inputs}
        want = {fn for _, fn, _ in self.wrappers}
        check(got == want, f"{label}: no input of {sorted(want - got)} "
                           f"captured")


def flash_bwd_terms(q, k, v, o, do, lse, causal: bool = True,
                    q_offset: int = 0):
    """For each element of the flash backward's dq, dk, dv (f32, the model
    layout), the magnitude its rounding error scales with, from the terms
    ``flash_attention_bwd_ref`` computes: scale·W |k|, scale·Wᵀ |q| and
    Pᵀ |dO|, summed over the G query heads of a KV head, where W = |dS| +
    hd·2⁻¹⁶·P·(|dO| |v|ᵀ + rowsum(|dO·O|)). A bf16 flash backward rounds P
    and dS to bf16 (one bf16 step, 2⁻⁸, of |dS| and P) after computing
    dS = P·(dP − D) in f32 from sums over hd that cancel (hd f32 steps,
    2⁻²⁴ = 2⁻¹⁶ bf16 steps each, of their terms' magnitudes), so its error
    is a few bf16 steps of this magnitude however much the result cancels
    (each row of dS sums to 0, so dq cancels k's common component; query
    0's dq is 0)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import causal_mask
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    mask = (causal_mask(Sq, Sk, q_offset, q.device) if causal
            else torch.ones((Sq, Sk), dtype=torch.bool, device=q.device))
    tq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    tk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    tv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for b in range(B):
        for kv in range(KV):
            heads = slice(kv * G, (kv + 1) * G)
            qg = q[b, :, heads].float().transpose(0, 1)         # (G, Sq, hd)
            dog = do[b, :, heads].float().transpose(0, 1)
            og = o[b, :, heads].float().transpose(0, 1)
            kf, vf = k[b, :, kv].float(), v[b, :, kv].float()
            s = torch.einsum("gqd,kd->gqk", qg, kf) * scale
            p = torch.where(mask, torch.exp(s - lse[b, heads, :, None]), 0.0)
            dp = torch.einsum("gqd,kd->gqk", dog, vf)
            ds = (p * (dp - (dog * og).sum(-1)[..., None])).abs()
            del dp
            ds += hd * 2.0 ** -16 * p * (
                torch.einsum("gqd,kd->gqk", dog.abs(), vf.abs())
                + (dog * og).abs().sum(-1)[..., None])
            tv[b, :, kv] = torch.einsum("gqk,gqd->kd", p, dog.abs())
            tk[b, :, kv] = torch.einsum("gqk,gqd->kd", ds, qg.abs()) * scale
            tq[b, :, heads] = (torch.einsum("gqk,kd->gqd", ds, kf.abs())
                               * scale).transpose(0, 1)
    return tq, tk, tv


def terms_used(got, want, terms, share=LM_KERNEL_RTOL) -> float:
    """The largest share of its allowance ``share`` · ``terms`` that any
    element of ``got`` uses against ``want`` (an element whose terms are
    all 0 must equal ``want``)."""
    import torch
    err = (got.float() - want.float()).abs()
    allow = share * terms
    return float(torch.where(allow > 0, err / allow,
                             torch.where(err > 0, float("inf"), 0.0)).max())


def sdpa_backward(q, k, v, do):
    """(dq, dk, dv) of causal ``scaled_dot_product_attention`` (GQA) for
    the output gradient ``do``, in the model layout (B, S, H, hd)."""
    import torch
    import torch.nn.functional as F
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         enable_gqa=True)
    return [g.transpose(1, 2) for g in
            torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2))]


def captured_times(fn: str, args, kw, got) -> dict:
    """One captured call timed (``cuda_ms``) beside one PyTorch call on the
    same inputs — SDPA forward or backward for flash, batched
    ``torch.matmul`` for the GEMM's tiles, ``torch.bmm`` on (E, G·C, ·)
    copies for dX and dW (the copies not timed) — with its bound (the
    inputs read once, the outputs written once; the products' bf16
    operations)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.measure import H100_BF16_FLOPS, cuda_ms
    ops = flash_ops if fn.startswith("flash") else gemm_ops
    ms = cuda_ms(lambda: getattr(ops, fn)(*args, **kw), REPS)
    outs = got if isinstance(got, (tuple, list)) else (got,)
    tensors = [a for a in args if torch.is_tensor(a)] + list(outs)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if fn.startswith("flash"):
        q, k, v = args[:3]
        B, S, H, hd = q.shape
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        if fn == "flash_attention":
            flops = 4 * B * H * hd * causal_pairs(S, S)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), REPS)
        else:
            flops = 10 * B * H * hd * causal_pairs(S, S)
            qs, ks, vs = (t.detach().requires_grad_() for t in (qs, ks, vs))
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=True)
            dos = args[4].transpose(1, 2)
            lib = cuda_ms(lambda: torch.autograd.grad(
                out, (qs, ks, vs), dos, retain_graph=True), REPS)
            del out
    else:
        if fn == "expert_gemm":
            x, w = args
            E = w.shape[0]
            G, C = x.shape[0] // E, x.shape[1]
            x4 = x.view(G, E, C, x.shape[2])
            lib = cuda_ms(lambda: torch.matmul(x4, w), REPS)
            macs = x.numel() * w.shape[2]
        elif fn == "expert_gemm_dx":
            dy, w = args
            E = w.shape[0]
            G, C = dy.shape[0] // E, dy.shape[1]
            dyt = dy.view(G, E, C, -1).transpose(0, 1).reshape(E, G * C, -1)
            lib = cuda_ms(lambda: torch.bmm(dyt, w.mT), REPS)
            macs = dy.numel() * w.shape[1]
            del dyt
        else:
            x, dy, E = args
            G, C = x.shape[0] // E, x.shape[1]
            xt = (x.view(G, E, C, -1).permute(1, 3, 0, 2)
                  .reshape(E, -1, G * C))
            dyt = dy.view(G, E, C, -1).transpose(0, 1).reshape(E, G * C, -1)
            lib = cuda_ms(lambda: torch.bmm(xt, dyt), REPS)
            macs = x.numel() * dy.shape[2]
            del xt, dyt
        flops = 2 * macs
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
    return dict(ms=ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, flops=flops)


def hold_captured(inputs, tag: str,
                  timed: bool = False) -> list:
    """Each input ``KernelCapture`` kept, run again by the kernel that took
    it (one launch of that kernel, two launches bitwise equal) and held
    against its plain version: the flash forward's O within ``row_atol``
    + LM_KERNEL_RTOL and its log-sum-exp within LSE_ATOL + LSE_RTOL; the
    expert GEMM within LM_GEMM_ATOL + LM_KERNEL_RTOL; its dX and dW within
    LM_KERNEL_RTOL of each element and of the output's RMS
    (``gemm_bwd_row``'s rule: a train step's gradients are far below
    LM_GEMM_ATOL); the flash backward's dq, dk, dv within LM_KERNEL_RTOL
    of each element's sum of term magnitudes (``flash_bwd_terms``), with
    ``flash_bwd_row``'s row rule and SDPA's backward's readings printed
    beside it."""
    import torch
    from repro_torch.kernels.expert_gemm import ops as gemm_ops
    from repro_torch.kernels.expert_gemm.ref import (expert_gemm_dw_ref,
                                                     expert_gemm_dx_ref,
                                                     expert_gemm_ref)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    refs = {"flash_attention": flash_attention_ref,
            "flash_attention_bwd": flash_attention_bwd_ref,
            "expert_gemm": expert_gemm_ref,
            "expert_gemm_dx": expert_gemm_dx_ref,
            "expert_gemm_dw": expert_gemm_dw_ref}
    out = []
    for key in sorted(inputs, key=str):
        fn, name, shapes = key
        args, kw = inputs[key]
        ops = flash_ops if fn.startswith("flash") else gemm_ops
        label = f"{tag} captured {fn} ({name})"
        before = dict(ops.LAUNCHES)
        got = getattr(ops, fn)(*args, **kw)
        check({k: ops.LAUNCHES[k] - before[k] for k in before}
              == {k: int(k == name) for k in before},
              f"{label}: not one launch of {name} ({ops.LAUNCHES})")
        again = getattr(ops, fn)(*args, **kw)
        want = refs[fn](*args, **kw)
        if fn == "flash_attention":
            got, lse = got if kw.get("return_lse") else (got, None)
            again = again[0] if lse is not None else again
            if lse is not None:
                want, want_lse = want
                lse_used = float(((lse - want_lse).abs()
                                  / (LSE_ATOL + LSE_RTOL * want_lse.abs()))
                                 .max())
                check(lse_used <= 1.0, f"{label}: LSE off its plain "
                                       f"version ({lse_used:.2f})")
            err, used = lm_check(label, got, again, want, row_atol(want))
        elif fn == "flash_attention_bwd":
            check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                  f"{label}: two launches differ")
            check(all(bool(torch.isfinite(g.float()).all()) for g in got),
                  f"{label}: non-finite gradient")
            terms = flash_bwd_terms(*args, **kw)
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            used = max(terms_used(g, w, t)
                       for g, w, t in zip(got, want, terms))
            # beside it: flash_bwd_row's row rule, and both readings of
            # the library's backward on the same inputs
            lib = sdpa_backward(*args[:3], args[4])
            row = [max(grad_allowance_used(g, w, LM_KERNEL_RTOL)
                       for g, w in zip(got, want)),
                   max(grad_allowance_used(g, w, LM_KERNEL_RTOL)
                       for g, w in zip(lib, want)),
                   max(terms_used(g, w, t)
                       for g, w, t in zip(lib, want, terms))]
            del lib, terms
            say(f"  {label}: {used:.3f} of LM_KERNEL_RTOL times each "
                f"element's sum of term magnitudes (SDPA's backward on the "
                f"same inputs {row[2]:.3f}); by flash_bwd_row's row rule "
                f"{row[0]:.3f} (SDPA's {row[1]:.3f})")
            check(used <= 1.0, f"{label}: {used:.2f} of the allowance")
        else:
            atol = (LM_GEMM_ATOL if fn == "expert_gemm" else LM_KERNEL_RTOL
                    * float(want.float().pow(2).mean().sqrt()))
            err, used = lm_check(label, got, again, want, atol)
        times = {}
        if timed:
            times = captured_times(fn, args, kw, got)
            lib = ("sdpa" if fn == "flash_attention" else "sdpa backward"
                   if fn.startswith("flash") else "torch.bmm"
                   if fn != "expert_gemm" else "torch.matmul")
            say(f"  {label} {shapes}: {times['ms']:.4f} ms, {lib} "
                f"{times['library_ms']:.4f} ms, bound "
                f"{times['bound_ms']:.4f} ms ({times['bound_by']}: "
                f"{times['bytes']} B, {times['flops']} flop)")
        say(f"  {label} {shapes}: max_abs_err={err:.3e} ({used:.3f} of the "
            f"allowance), two launches bitwise equal")
        out.append(dict(wrapper=fn, kernel=name, shapes=str(shapes),
                        max_abs_err=err, tol_used=used, **times))
        if fn == "flash_attention_bwd":
            out[-1].update(row_rule_used=row[0], sdpa_row_rule_used=row[1],
                           sdpa_tol_used=row[2])
        del got, again, want
        torch.cuda.empty_cache()
    return out


def hold_leaves(label, names, gaps, control):
    """Each leaf's gradients after the steps: the mesh's AdamW first
    moment against one card's (every term a gradient of the initial
    weights: step 0's lr is 0), within TP_LEAF_FACTOR times the f32
    control's gap."""
    ratio = [g / c if c else (0.0 if g == 0 else float("inf"))
             for g, c in zip(gaps, control["gaps"])]
    worst = sorted(range(len(names)), key=lambda k: -ratio[k])[:3]
    say(f"  {label} leaves: AdamW first moment after "
        f"{TP_TRAIN_STEPS} steps against one card's, ||m - m_card|| / "
        f"||m_card|| over {len(names)} leaves: max {max(gaps):.3e} "
        f"({names[max(range(len(gaps)), key=gaps.__getitem__)]}), "
        f"median {sorted(gaps)[len(gaps) // 2]:.3e}; the f32 one-card "
        f"control's (losses {control['losses']}): max "
        f"{max(control['gaps']):.3e}, median "
        f"{sorted(control['gaps'])[len(gaps) // 2]:.3e}; largest ratios "
        f"mesh / control "
        + ", ".join(f"{names[k]} {gaps[k]:.3e} / "
                    f"{control['gaps'][k]:.3e} = {ratio[k]:.3f}"
                    for k in worst)
        + f" (bound {TP_LEAF_FACTOR})")
    check(max(ratio) <= TP_LEAF_FACTOR,
          f"{label}: leaf {names[worst[0]]}'s moment "
          f"{ratio[worst[0]]:.3f} times the f32 control's gap")
    return dict(names=names, gaps=gaps, control=control, ratio=ratio)


def lookup_want(shape, counts, rows: int, d: int, c: int, id_bytes: int,
                kind: str) -> dict:
    """The two-axis lookup's bytes (``embed``, blocks ``counts`` = (K, C)
    over "model" and "data") of one batch split over "data" on a ("data",
    "model") mesh of ``shape``, each position holding ``rows`` ids of its
    batch shard (``id_bytes`` each), the rows ``d`` wide in a ``c``-byte
    dtype, as the reference's partitioner forms it: on a square mesh the
    ids permuted from (d, m) to (m, d) (``emb_ids_permute``), then every
    position's ids gathered from the D − 1 other shards
    (``emb_ids_gather``: along "model" after the permute, else along
    "data"); each position's partial rows of its line's D shards in its
    (V/K, d/C) block reduce-scattered and all-gathered over the K vocab
    blocks' holders, 2(K − 1)/K of them into each (``emb_rows_model``);
    its shard's rows of the C − 1 column blocks it does not hold from
    their holders (``kind`` "train" or "prefill":
    ``emb_rows_data``, the reference's all-to-all; "decode": the port's
    re-layout, ``emb_rows_relayout``); in training the gradient rows
    the same way back (``emb_grad_data``)."""
    D, M = shape
    N = D * M
    K, C = counts
    need = D if C > 1 else 1             # the shards a position looks up
    out = {}
    if D == M > 1 and C > 1:
        out["emb_ids_permute"] = D * (M - 1) * rows * id_bytes
    out["emb_ids_gather"] = N * (need - 1) * rows * id_bytes
    out["emb_rows_model"] = N // K * 2 * (K - 1) * need * rows * d // C * c
    name = "emb_rows_relayout" if kind == "decode" else "emb_rows_data"
    out[name] = N * (C - 1) * rows * d // C * c
    if kind == "train":
        out["emb_grad_data"] = out[name]
    return {k: v for k, v in out.items() if v}


def row_lookup_want(shape, axes, lookups, e: int, c: int, id_bytes: int,
                    train: bool) -> dict:
    """The bytes of lookups in a table split along its rows only, over
    the mesh axes ``axes`` (("data", "model"): the ``fsdp`` LM table;
    ("model",): BST's tables; ("data",): the ``fsdp`` LM table where 256
    does not divide its rows), on a ("data", "model") mesh of ``shape``
    with the batch over "data" (batch shard d at its home (d, 0)), as the
    reference's partitioner forms them: ``lookups`` holds per lookup its
    homes' (d, ids) in batch order, each row ``e`` wide in a ``c``-byte
    dtype, ``id_bytes`` an id. A home reads the blocks of its group where
    it holds them (each block's first holder else); of a table over
    "data" alone, with "model" longer than 1, the blocks of its "model"
    column (``collectives._column``: shard d on column d when the axes are
    equal, D / M shards a column when M divides D, one column a shard when
    D divides M). A lookup's homes that read the same blocks are looked up
    together. Each home's ids go to the positions of its group on the
    lines of those blocks along "data" (``emb_ids_home``: the port's batch
    lies at the home only), then along "data" to each block's position
    (``emb_ids_gather``); on a column straight to where they land
    (``emb_ids_permute``, or ``emb_ids_home`` inside the group), then
    along "data" to the rest of it. The partial rows of the K blocks are
    reduce-scattered over their positions ((K − 1)·T, T all the homes'
    rows) and every folded chunk all-gathered to each home, or on a column
    to the first position where the home's ids land (T less the
    receiver's own chunk: ``emb_rows_fold``), which sends the home its
    rows (``emb_rows_permute``); in training the gradient rows go the
    ids' way (``emb_grad_home``, ``emb_grad_permute``,
    ``emb_grad_gather``)."""
    import collections
    D, M = shape
    out = collections.Counter()
    columns = tuple(axes) == ("data",) and M > 1

    def column(d):
        if D > M and D % M == 0:
            g = D // M
            return d // g, [M * (d % g) + k for k in range(M)]
        return d * M // D, list(range(D))
    def blocks(d):
        """Home d's blocks' positions (data, model), block order."""
        if set(axes) == {"data", "model"}:
            return tuple((a, b) for a in range(D) for b in range(M))
        if tuple(axes) == ("model",):
            return tuple((d, b) for b in range(M))
        if tuple(axes) == ("data",):
            return tuple((a, column(d)[0] if columns else 0)
                         for a in range(D))
        raise ValueError(f"row_lookup_want: rows over {axes}")
    sets = []
    for homes in lookups:       # the homes that read the same blocks
        by = {}
        for d, n in homes:
            by.setdefault(blocks(d), []).append((d, n))
        sets.extend(by.items())
    for srcs, homes in sets:
        srcs = list(srcs)
        K = len(srcs)
        T = sum(n for _, n in homes) * e     # entries; chunks cut by entry
        cut = [k * T // K for k in range(K + 1)]
        out["emb_rows_fold"] += (K - 1) * T * c
        relays = {}
        for d, n in homes:
            hops = set()
            for q in srcs:
                if q == (d, 0):
                    continue
                if columns:
                    col, land = column(d)
                    r = q if q[0] in land else (land[0] + q[0] % len(land),
                                                col)
                    relays[d] = (land[0], col)
                    hops.add(("home" if r[0] == d else "permute",
                              (d, 0), r))
                    hops.add(("gather", r, q))
                elif q[0] == d:
                    hops.add(("home", (d, 0), q))
                else:
                    hops.add(("home", (d, 0), (d, q[1])))
                    hops.add(("gather", (d, q[1]), q))
            relays.setdefault(d, (d, 0))
            if relays[d] != (d, 0):
                out["emb_rows_permute"] += n * e * c
            for kind, frm, to in hops:
                if frm == to:
                    continue
                out[f"emb_ids_{kind}"] += n * id_bytes
                if train:
                    out[f"emb_grad_{kind}"] += n * e * c
        for r in dict.fromkeys(relays.values()):
            own = srcs.index(r) if r in srcs else None
            out["emb_rows_fold"] += (T - (0 if own is None else
                                          cut[own + 1] - cut[own])) * c
    return {k: v for k, v in out.items() if v}


def fsdp_lookup_want(cfg, shape, lookups, train: bool,
                     id_bytes: int = 4, lies: bool = True) -> dict:
    """:func:`row_lookup_want` of the LM table under the ``fsdp`` rules
    (its spec on a meta mesh of ``shape``), rows in the compute dtype; for
    a tied table only where the head stays where it lies (``lies``: the
    vocab-parallel route, and :func:`head_layout` gives it a form), else
    none: the head gathers the table whole and the lookup reads it
    there."""
    import torch
    if cfg.tie_embeddings and not (lies and head_layout(cfg, shape)[0]):
        return {}
    from repro_torch.distrib.sharding import entry_axes, lm_param_specs
    from repro_torch.models.transformer import TransformerLM
    params = TransformerLM(cfg).init(torch.Generator(), device="meta")
    spec = lm_param_specs(params, cfg, "fsdp")["embed"]
    c = 2 if cfg.dtype == "bfloat16" else 4
    return row_lookup_want(shape, entry_axes(spec[0]), lookups,
                           cfg.d_model, c, id_bytes, train)


def head_layout(cfg, shape):
    """The LM head's form under the ``fsdp`` rules on a ("data", "model")
    mesh of ``shape`` (``params["head"]``, or the tied table read as its
    transpose): ``"lie"`` where the vocabulary splits into one block a
    position (one block on a mesh of one position), ``"column"`` where it
    splits over "data" alone on a square mesh (``fit_spec``'s fallback),
    else None; and the number of vocab blocks."""
    import torch
    from repro_torch.distrib.sharding import Layout, lm_param_specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import TransformerLM
    D, M = shape
    mesh = Mesh(shape, ("data", "model"), ["meta"] * (D * M))
    params = TransformerLM(cfg).init(torch.Generator(), device="meta")
    key = "embed" if cfg.tie_embeddings else "head"
    lay = Layout(mesh, lm_param_specs(params, cfg, "fsdp")[key],
                 params[key].shape)
    v = 0 if cfg.tie_embeddings else 1
    K = lay.counts[v]
    if lay.counts[1 - v] != 1 or (K == 1 and D * M > 1):
        return None, K
    if K == D * M:
        return "lie", K
    if tuple(lay.axes[v]) == ("data",) and D == M:
        return "column", K
    return None, K


def head_want(cfg, shape, calls, train: bool, id_bytes: int = 4) -> dict:
    """The bytes of the LM head's moves where it stays where it lies on
    the vocab-parallel route (``collectives.vocab_parallel_xent`` in a
    train step, ``head_logits`` in a prefill) under the ``fsdp`` rules on
    a ("data", "model") mesh of ``shape``, the batch over "data" (batch
    shard d at its home (d, 0)), as the reference's partitioner forms the head
    (:func:`head_layout`): ``calls`` holds per call its homes' (d, rows)
    in batch order, rows ``d_model`` wide in the compute dtype, labels
    ``id_bytes`` an entry, the head's masters f32.

    One vocab block a position (K of them): each position forms every
    row's logits of its block, the rows reaching it from the home through
    the home's group (``head_rows_home``) and along "data"
    (``head_rows_gather``). The fallback on a square mesh: position (a, b)
    forms block a, the rows going from the home (s, 0) to (s, a), to
    (a, s) (``head_rows_permute``) and along "model" to (a, b); a move
    that two routes share moves once, under the name of the first site
    (in position order) that needs it. In a train step the labels go the
    rows' way (``head_labels``); the row maxima and the sums of the
    exponentials are all-reduced over each group of the blocks' sites
    (``head_stats``: 2 × 2(K − 1) f32 per row, one group; the fallback's D
    groups along "data"); every other site of the home's statistics group
    sends it its target logits (``head_target``, f32 a row), and the
    home's gradient goes to every site that forms a logit gradient of it
    (``head_scale``, 4 B). The backward, one block a position: every row's
    dX partial (f32) all-reduced along "data" over each line of D sites
    (``head_grad_data``), then each home's rows over its group of M to the
    home (``head_grad_model``: (M − 1)·T + T − ⌊T / M⌋ entries, T its
    rows' entries); the fallback: for each home s and block m, the logit
    gradient from (m, m) to (s, m) (``head_grad_relayout``, compute dtype),
    the block from (m, s) to (s, m) and its gradient back
    (``head_block_permute``, ``head_wgrad_permute``), the dX partials over
    the home's group (``head_grad_model``). A prefill sends every block's
    logits (its first site's) to position 0 (``logits_gather``)."""
    import collections
    form, K = head_layout(cfg, shape)
    if form is None:
        return {}
    D, M = shape
    d, V = cfg.d_model, cfg.vocab_size
    Vb = V // K
    c = 2 if cfg.dtype == "bfloat16" else 4
    out = collections.Counter()

    def at(a, b):
        return a * M + b
    sites = [at(a, b) for a in range(D) for b in range(M)]
    if form == "column" and not train:
        sites = [at(a, 0) for a in range(D)]
    for homes in calls:
        N = sum(n for _, n in homes)
        for s, n in homes:
            h = at(s, 0)
            seen = {}
            for q in sites:
                a, b = divmod(q, M)
                if form == "lie":
                    hops = ([("home", h, at(s, b))] if a == s else
                            [("home", h, at(s, b)), ("gather", at(s, b), q)])
                else:
                    hops = [("home", h, at(s, a)),
                            ("permute", at(s, a), at(a, s)),
                            ("gather", at(a, s), q)]
                for kind, frm, to in hops:
                    if frm != to:
                        seen.setdefault((frm, to), kind)
            for kind in seen.values():
                out[f"head_rows_{kind}"] += n * d * c
                if train:
                    out["head_labels"] += n * id_bytes
            if not train:
                continue
            T = n * d
            if form == "lie":
                out["head_target"] += (K - 1) * n * 4
                out["head_scale"] += (K - 1) * 4
                if M > 1:
                    out["head_grad_model"] += ((M - 1) * T + T - T // M) * 4
            else:
                out["head_target"] += (D - 1) * n * 4
                out["head_scale"] += (D - (s == 0)) * 4
                out["head_grad_relayout"] += (D - 1) * n * Vb * c
                out["head_block_permute"] += (D - 1) * d * Vb * 4
                out["head_wgrad_permute"] += (D - 1) * d * Vb * 4
                out["head_grad_model"] += ((D - 1) * T + T - T // D) * 4
        if not train:
            out["logits_gather"] += (len(set(
                q // M if form == "column" else q for q in sites)) - 1) \
                * N * Vb * c
            continue
        groups = 1 if form == "lie" else D
        size = K if form == "lie" else D
        out["head_stats"] += groups * 2 * 2 * (size - 1) * N * 4
        if form == "lie" and D > 1:
            out["head_grad_data"] += M * 2 * (D - 1) * N * d * 4
    return {k: v for k, v in out.items() if v}


def fsdp_gather_want(cfg, shape, calls, act: bool,
                     head_in_place: bool = True) -> dict:
    """The ``all_gather`` and ``all_gather_grad`` bytes of one
    ``make_sharded_train_step`` step under the ``fsdp`` rules on a
    ("data", "model") mesh of ``shape`` (each leaf's blocks from its spec
    on a meta mesh of that shape), the batch over "data", f32 masters:
    per call (``calls``: its homes' (d, rows), as :func:`head_want`'s) each
    home gathers every leaf it reads whole, each block from a position of
    its group that holds it, else from its first holder (the remote blocks
    move): every layer's leaves (again in ``remat``'s recompute), but the
    experts under ``act`` and ``moe_shard="expert"`` (they stay where they
    live), and of the top-level leaves ``ln_f``, the table where it is not
    looked up in place (:func:`fsdp_lookup_want`), the head where it does
    not stay where it lies (``act`` and :func:`head_layout`; with
    ``head_in_place`` false, as the parent of this form gathered it); the
    backward sends each remote block's gradient back once."""
    import collections
    import torch
    from repro_torch.distrib.collectives import batch_groups
    from repro_torch.distrib.sharding import (Layout, lm_param_specs,
                                              map_with_specs)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import TransformerLM
    D, M = shape
    mesh = Mesh(shape, ("data", "model"), ["meta"] * (D * M))
    params = TransformerLM(cfg).init(torch.Generator(), device="meta")
    specs = lm_param_specs(params, cfg, "fsdp")
    homes, groups = batch_groups(mesh, "data")
    again = 2 if cfg.remat in ("full", "dots") else 1
    out = collections.Counter()

    def remote(x, s, home):
        ly = Layout(mesh, s, x.shape)
        grp = groups[homes.index(home)]
        n = sum(([p for p in ly.holders(b) if p in grp]
                 or ly.holders(b))[0] != home for b in ly.blocks())
        return n * x.numel() // len(ly.blocks()) * 4
    kept = act and cfg.moe is not None and cfg.moe.moe_shard == "expert"
    lies = (act and head_in_place
            and head_layout(cfg, shape)[0] is not None)
    table = Layout(mesh, specs["embed"], params["embed"].shape).counts
    looked = (table[0] > 1 and table[1] == 1
              and (not cfg.tie_embeddings or lies))
    top = [k for k in params if k != "layers"
           and not (k == "embed" and looked)
           and not (k == "head" and lies)
           and not (k == "embed" and cfg.tie_embeddings and lies)]
    for homes_of in calls:
        for s, _ in homes_of:
            home = homes[s]
            n = [0]

            def add(x, sp):
                n[0] += remote(x, sp, home)
            for lp, sp in zip(params["layers"], specs["layers"]):
                if kept:
                    lp = {**lp, "moe": {"router": lp["moe"]["router"]}}
                    sp = {**sp, "moe": {"router": sp["moe"]["router"]}}
                map_with_specs(add, lp, sp)
            layers = n[0]
            n[0] = 0
            map_with_specs(add, {k: params[k] for k in top},
                           {k: specs[k] for k in top})
            out["all_gather"] += again * layers + n[0]
            out["all_gather_grad"] += layers + n[0]
    return {k: v for k, v in out.items() if v}


def bst_lookup_want(cfg, shape, homes, train: bool = True) -> dict:
    """:func:`row_lookup_want` of BST's item table (P("model", None)) and
    user tables (P(None, "model", None)), f32 rows, int32 ids: per entry
    ``(d, b)`` of ``homes`` batch shard d's home looks up its ``b`` users'
    S + 1 items and F user features once, in two lookups of its own."""
    import collections
    out = collections.Counter()
    for n in (cfg.seq_len + 1, cfg.n_user_feats):
        out.update(row_lookup_want(shape, ("model",),
                                   [[(d, b * n)] for d, b in homes],
                                   cfg.embed_dim, 4, 4, train))
    return dict(out)


def bst_mlp_want(cfg, shape, homes, train: bool = True) -> dict:
    """The bytes of BST's ``mlp_w0`` where its column blocks lie
    (``collectives.column_row_product``), as the reference's partitioner
    forms it, on a ("data", "model") mesh of ``shape``: per entry ``(d,
    b)`` of ``homes`` batch shard d's home sends its ``b`` rows of the MLP's
    input (F_in f32 entries each) to the other M − 1 positions of its group
    (``mlp_rows_home``) with the slices of ``mlp_b0`` and ``mlp_w1`` each
    one reads (``mlp_weights_home``, their gradients back in training), and
    the partial products of ``mlp_w1`` (b × mlp_dims[1] f32) are all-reduced
    to the home ((M − 1)·T + T − ⌊T / M⌋ entries, ``mlp_sum``); the
    backward sends the sum's gradient to the group (``mlp_grad_home``) and
    all-reduces the dX partials (b × F_in) to the home
    (``mlp_grad_sum``)."""
    import collections
    M = shape[1]
    out = collections.Counter()
    e, F = cfg.embed_dim, cfg.n_user_feats
    f_in = (cfg.seq_len + 1) * 2 * e + F * e
    w, w_out = cfg.mlp_dims[0], cfg.mlp_dims[1]
    if M == 1:
        return {}
    slices = (M - 1) * (w // M + w // M * w_out) * 4
    for _, b in homes:
        out["mlp_rows_home"] += (M - 1) * b * f_in * 4
        out["mlp_weights_home"] += slices * (2 if train else 1)
        T = b * w_out
        out["mlp_sum"] += ((M - 1) * T + T - T // M) * 4
        if train:
            out["mlp_grad_home"] += (M - 1) * b * w_out * 4
            T = b * f_in
            out["mlp_grad_sum"] += ((M - 1) * T + T - T // M) * 4
    return dict(out)


def tp2d_bytes_want(cfg, shape, rows: int, rounds: int, group: int) -> dict:
    """Every collective's bytes of one ``make_tp2d_train_step`` step on a
    ("data", "model") mesh of ``shape``, the batch split over "data", one
    round per microbatch (``rounds`` of them), each position holding
    ``rows`` of the microbatch's rows (B/(M·D)·S), from the config and the
    ``tp2d`` rules (each leaf's blocks from its spec on a meta mesh of that
    shape): per round the weights gathered along "data" in the compute
    dtype and reduce-scattered back in f32, the sums over "model" (a
    reduce-scatter of the partial, an all-gather of the rounded sum), the
    heads and experts over "model", the loss's statistics, its sum and
    count over "data" (a 4-byte f32 and a 4-byte int32 from each other
    batch shard, ``loss_sum``), each MoE layer's aux terms over "data" (E
    f32 means and E int32 counts, ``moe_aux_sum``), where a MoE group of
    ``group`` tokens spans batch shards its probabilities along "data"
    (``moe_group_probs``, their gradients back: ``moe_group_probs_grad``)
    and each position's dispatch rows from the others
    (``moe_group_dispatch``), and the two-axis lookup as the
    reference's partitioner forms it (:func:`lookup_want`, the rows in the
    compute dtype), the forward's moves inside a layer again in
    ``remat``'s recompute; per step the replicas' sums, the norm's 4-byte
    scalar from every position to every other (``norm_sum``) and AdamW's
    sends (f32)."""
    import collections
    import math
    import torch
    from repro_torch.distrib.sharding import Layout, lm_param_specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import _groups, moe_capacity
    from repro_torch.models.transformer import TransformerLM
    D, M = shape
    N = D * M
    mesh = Mesh(shape, ("data", "model"), ["meta"] * N)
    params = TransformerLM(cfg).init(torch.Generator(), dtype=torch.float32,
                                     device="meta")
    specs = lm_param_specs(params, cfg, "tp2d")
    c = 2 if cfg.dtype == "bfloat16" else 4
    R, d, hd = rows, cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    again = 2 if cfg.remat in ("full", "dots") else 1
    out = collections.Counter()

    def lay(x, s):
        return Layout(mesh, s, x.shape)

    def on(layout, axis):
        return math.prod(mesh.axis_size(a) for axes in layout.axes
                         for a in axes if a == axis)

    def allreduce(n, p):                 # N / M groups of M
        return N // M * (M - 1) * n * (p + c)

    def gathered(x, s, times):
        ly = lay(x, s)
        Dw, Mw = on(ly, "data"), on(ly, "model")
        out["tp_zero_gather"] += (rounds * times * N * (Dw - 1)
                                  * x.numel() // (Dw * Mw) * c)
        out["tp_zero_scatter"] += rounds * (D - 1) * 4 * x.numel()
        return ly

    direct = 0                           # leaves read where they lie
    for lp, sp in zip(params["layers"], specs["layers"]):
        direct += lp["ln1"].numel() + lp["ln2"].numel()
        for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "sg", "su",
                     "sd"):
            if name not in lp:
                continue
            ly = gathered(lp[name], sp[name], again)
            if M > 1 and "model" in ly.axes[0]:      # a row block's sum
                out["tp_model_sum"] += rounds * again * allreduce(R * d, 4)
            if M > 1 and "model" in ly.axes[1]:      # a column block's dX
                out["tp_model_sum"] += rounds * allreduce(R * d, 4)
        for name in ("bq", "bk", "bv"):
            direct += lp[name].numel() if name in lp else 0
        q = lay(lp["wq"], sp["wq"])
        if M > 1 and "model" in q.axes[1] and not (H % M == 0
                                                   and KV % M == 0):
            per, g = H // M, H // KV
            if H % M == 0 and g % per == 0:  # each position's k, v head
                w = KV * hd // M
                fwd = 0
                for m in range(M):
                    lo = m * per // g * hd
                    fwd += 2 * (hd - max(0, min(lo + hd, (m + 1) * w)
                                         - max(lo, m * w))) * R * c
                fwd *= D
                out["tp_heads_gather"] += rounds * (again + 1) * fwd
            else:                            # q, k, v whole; o's part back
                share = N * (M - 1) * R * hd * c // M
                out["tp_heads_gather"] += rounds * (
                    again * share * (H + 2 * KV) + share * H)
        if "moe" in lp:
            moe, mp, ms = cfg.moe, lp["moe"], sp["moe"]
            gathered(mp["router"], ms["router"], again)
            direct += sum(mp[k].numel() for k in ("wg", "wu", "wd"))
            E = moe.n_experts
            spans = max(1, group // R)       # batch shards a group spans
            G, S = (1, group) if spans > 1 else _groups(R, max(1, R // group))
            n = G * E * moe_capacity(S, E, moe.top_k) * d
            wg = lay(mp["wg"], ms["wg"])
            by_model = M > 1 and wg.counts[0] > 1
            if by_model:                     # the experts over "model"
                out["expert_gather"] += (rounds * (again + 1) * N * (M - 1)
                                         * n * c // M)
            elif M > 1 and wg.counts[2] > 1:  # their d_ff over "model"
                out["tp_model_sum"] += rounds * (again + 1) * allreduce(n, c)
            if spans > 1:    # the group's probabilities and dispatch rows
                probs = rounds * N * (spans - 1) * R * E * 4
                out["moe_group_probs"] += again * probs
                out["moe_group_probs_grad"] += probs
                out["moe_group_dispatch"] += (rounds * again * N
                                              * (spans - 1) * n * c
                                              // (M if by_model else 1))
            out["moe_aux_sum"] += rounds * again * N * (D - 1) * 8 * E
    direct += params["ln_f"].numel()
    head = specs["embed"] if cfg.tie_embeddings else specs["head"]
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    ly = gathered(w, head, 1)
    vocab_dim = 0 if cfg.tie_embeddings else 1
    if M > 1 and "model" in ly.axes[vocab_dim]:
        out["xent_stats"] += rounds * N * (M - 1) * 12 * R
        out["tp_model_sum"] += rounds * allreduce(R * d, 4)
    emb = lay(params["embed"], specs["embed"])
    for k, v in lookup_want(shape, emb.counts, R, d, c, 4, "train").items():
        out[k] += rounds * v
    out["grad_psum"] += (D - 1) * 4 * direct
    out["loss_sum"] += rounds * N * (D - 1) * 8
    out["norm_sum"] += N * (N - 1) * 4

    def leaves(p, s):
        if isinstance(p, dict):
            for k in p:
                yield from leaves(p[k], s[k])
        elif isinstance(p, list):
            for a, b in zip(p, s):
                yield from leaves(a, b)
        else:
            yield p, lay(p, s)
    for x, ly in leaves(params, specs):
        blocks = math.prod(ly.counts)
        out["grad_send"] += x.numel() * 4 * (N - blocks) // blocks
    return {k: v for k, v in out.items() if v}


def serve_tp2d_bytes_want(cfg, shape, batch: int, seq: int, kind: str,
                          group: int, capacity: int = 0,
                          id_bytes: int = 4) -> dict:
    """Every collective's bytes of one ``tp2d`` prefill (``kind``
    "prefill", ``seq`` prompt positions, the cache placed with room for
    ``capacity``) or decode step ("decode", one token against a cache of
    ``capacity`` positions) with the batch of ``batch`` sequences split
    over "data" on a ("data", "model") mesh of ``shape``
    (``distrib/serving.py``), from the config and the ``tp2d`` rules (each
    leaf's blocks from its spec on a meta mesh of that shape) in the
    compute dtype: every position holds its batch shard's rows; a product
    gathers its weight's "model" block along "data" (``tp_zero_gather``)
    unless, at a decode step, it is the router (split over "data" on its
    input dimension only), re-split over "model" where it lies
    (``tp_resplit``) with its logits' partials summed over "model", or the
    weight splits over "data" on its output dimension only — a
    decode step's ``wo`` / ``wd`` and the untied head, in a prefill the
    head alone — where each position gathers the batch line's rows
    instead (``tp_rows_gather``), the f32 partials of an input split over
    "model" are summed over "model", and each position takes its batch
    shard's rows of the other column blocks (``tp_rows_scatter``); the sums
    over "model" reduce-scatter the partial and all-gather the rounded sum
    (``tp_model_sum``); the heads over "model" as the train step splits
    them in a prefill and gathered whole in a decode step
    (``tp_heads_gather``), the tied head's vocab blocks joined over "model"
    (``tp_logits_gather``), the experts' outputs gathered along "model"
    (``expert_gather``) or the ``ffn`` down products summed, with ``group``
    tokens a MoE group over the whole batch: where a group spans batch
    shards, each position's router probabilities gathered along its
    line of the group's shards (``moe_group_probs``, f32) and the dispatch
    rows its experts read taken from the other shards' buffers
    (``moe_group_dispatch``); the lookup as the reference's partitioner
    forms it (:func:`lookup_want`; a decode step's rows re-laid out into
    the port's batch shards, ``emb_rows_relayout``); a
    decode step's attention partials crossing "model" (``attn_partial``);
    a prefill's cache blocks filled with the heads their position did not
    compute (``cache_scatter``); the batch shards' logits to position 0
    (``logits_gather``). The token ids take ``id_bytes`` each."""
    import collections
    import math
    import torch
    from repro_torch.distrib.sharding import (Layout, lm_cache_specs,
                                              lm_param_specs)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import moe_capacity, shard_groups
    from repro_torch.models.transformer import TransformerLM
    D, M = shape
    N = D * M
    decode = kind == "decode"
    mesh = Mesh(shape, ("data", "model"), ["meta"] * N)
    params = TransformerLM(cfg).init(torch.Generator(), device="meta")
    specs = lm_param_specs(params, cfg, "tp2d")
    c = 2 if cfg.dtype == "bfloat16" else 4
    Bd = batch // D
    R = Bd * (1 if decode else seq)     # rows a position holds
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H, KV, V = cfg.n_heads, cfg.n_kv_heads, cfg.vocab_size
    out = collections.Counter()

    def on(ly, dim, model):
        return math.prod(mesh.axis_size(a) for a in ly.axes[dim]
                         if (a == "model") == model)

    def allreduce(n, p):                 # N / M groups of M
        return N // M * (M - 1) * n * (p + c)

    def product(x, s, rows, moves, transposed=False):
        """One product with the (n_in, n_out) weight ``x`` placed by
        ``s``."""
        ly = Layout(mesh, s, x.shape)
        i, o = (1, 0) if transposed else (0, 1)
        n_in, n_out = x.shape[i], x.shape[o]
        Dw = on(ly, 0, False) * on(ly, 1, False)
        data = any(a != "model" for axes in ly.axes for a in axes)
        if not moves or not data or any(a != "model" for a in ly.axes[i]):
            Mw = on(ly, 0, True) * on(ly, 1, True)
            out["tp_zero_gather"] += N * (Dw - 1) * x.numel() // (Dw * Mw) * c
            if M > 1 and on(ly, i, True) > 1:          # a row block's sum
                out["tp_model_sum"] += allreduce(rows * n_out, 4)
            return ly
        D_in, D_out = on(ly, i, True) * on(ly, i, False), \
            on(ly, o, True) * on(ly, o, False)
        out["tp_rows_gather"] += N * (D - 1) * rows * n_in // D_in * c
        if D_in > 1:
            out["tp_model_sum"] += allreduce(D * rows * n_out // D_out, 4)
        out["tp_rows_scatter"] += N * (D_out - 1) * rows * n_out // D_out * c
        return ly

    for lp, sp in zip(params["layers"], specs["layers"]):
        q = None
        for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "sg", "su",
                     "sd"):
            if name in lp:
                ly = product(lp[name], sp[name], R, decode)
                q = ly if name == "wq" else q
        if M > 1 and "model" in q.axes[1]:
            per, g = H // M, H // KV
            if decode or not (H % M == 0 and (KV % M == 0
                                              or g % per == 0)):
                # q, k and v gathered whole along "model"
                out["tp_heads_gather"] += (N * (M - 1) * R * hd * c // M
                                           * (H + 2 * KV))
            elif KV % M:                     # each position's k, v head
                w = KV * hd // M
                for m in range(M):
                    lo = m * per // g * hd
                    out["tp_heads_gather"] += D * 2 * (hd - max(
                        0, min(lo + hd, (m + 1) * w) - max(lo, m * w))) \
                        * R * c
        if "moe" in lp:
            moe, mp, ms = cfg.moe, lp["moe"], sp["moe"]
            E = moe.n_experts
            rl = Layout(mesh, ms["router"], mp["router"].shape)
            if decode and rl.axes[0] and not rl.axes[1] \
                    and "model" not in rl.axes[0]:
                # the router re-split over "model" where it lies: each
                # position's d / M input rows from the data blocks it
                # lacks, the logits' f32 partials summed over "model"
                b_in, b_out = d // rl.counts[0], d // M
                for pos in range(N):
                    lo = mesh.coords(pos)["model"] * b_out
                    own = mesh.coords(pos)["data"] * b_in
                    keep = max(0, min(lo + b_out, own + b_in) - max(lo, own))
                    out["tp_resplit"] += (b_out - keep) * E * c
                if M > 1:
                    out["tp_model_sum"] += allreduce(R * E, 4)
            else:
                product(mp["router"], ms["router"], R, decode)
            G, S, span = shard_groups(R, max(1, D * R // group), D)
            n = G * E * moe_capacity(S, E, moe.top_k) * d
            wg = Layout(mesh, ms["wg"], mp["wg"].shape)
            Me = M if M > 1 and wg.counts[0] > 1 else 1
            if span > 1:       # one group over span batch shards
                out["moe_group_probs"] += N * (span - 1) * R * E * 4
                out["moe_group_dispatch"] += N * (span - 1) * n * c // Me
            if Me > 1:                       # the experts over "model"
                out["expert_gather"] += N * (M - 1) * n * c // M
            elif M > 1 and wg.counts[2] > 1:  # their d_ff over "model"
                out["tp_model_sum"] += allreduce(n, c)
    # the head (its last rows in a prefill), the tied head's vocab blocks
    # joined over "model"
    if cfg.tie_embeddings:
        ly = product(params["embed"], specs["embed"], Bd, True, True)
        if M > 1 and on(ly, 0, True) > 1:
            out["tp_logits_gather"] += N * (M - 1) * Bd * V // M * c
    else:
        product(params["head"], specs["head"], Bd, True)
    out["logits_gather"] += (D - 1) * Bd * V * c
    emb = Layout(mesh, specs["embed"], params["embed"].shape)
    out.update(lookup_want(shape, emb.counts, R, d, c, id_bytes, kind))
    cache = Layout(mesh, lm_cache_specs(False, 16), (L, batch, capacity, KV,
                                                     hd))
    Sb = cache.block_shape[2]
    Ms = cache.counts[2]
    if decode and Ms > 1:                # the slices' (m, l, o), f32
        out["attn_partial"] += L * N * (Ms - 1) * Bd * H * (2 + hd) * 4
    if not decode and M > 1 and "model" in q.axes[1]:
        lo_hi = []                       # the heads each position computed
        for m in range(M):
            per, g = H // M, H // KV
            if H % M == 0 and KV % M == 0:
                lo_hi.append((m * KV // M, (m + 1) * KV // M))
            elif H % M == 0 and g % per == 0:
                lo_hi.append((m * per // g, m * per // g + 1))
            else:
                lo_hi.append((0, KV))
        for m in range(Ms):
            held = set(range(*lo_hi[m]))
            valid = max(0, min(Sb, seq - m * Sb))
            out["cache_scatter"] += (D * 2 * (KV - len(held)) * L * Bd
                                     * valid * hd * 2)
    return {k: v for k, v in out.items() if v}


def serve_fsdp_bytes_want(cfg, shape, batch: int, seq: int, group: int,
                          capacity: int, id_bytes: int = 4,
                          act_spec: bool = True) -> dict:
    """Every collective's bytes of one ``fsdp`` prefill of ``batch``
    sequences of ``seq`` tokens split over "data" on a ("data", "model")
    mesh of ``shape`` (``distrib/serving.py``), the cache placed with room
    for ``capacity``, from the config and the ``fsdp`` rules (each leaf's
    blocks from its spec on a meta mesh of that shape): each batch shard's
    home gathers every leaf whole, each block from a position of its group
    that holds it, else from the block's first holder (``all_gather``),
    but for the experts under ``moe_shard="expert"``, which stay where
    they live: each remote expert block gets its slice of the home's
    dispatch buffer (``group`` tokens a routing group) and sends its
    outputs back (``expert_send``); the cache blocks of the group's other
    positions are filled from the home (``cache_scatter``, bf16); the
    batch shards' last logits go to position 0 (``logits_gather``). Where
    a routing group spans several batch shards, each run of them is
    computed at its first home over the run's rows, and the run's other
    shards get their last logits and their keys and values from there
    (``prefill_span``). A table split along its rows only is not gathered
    (but for a tied head that does not stay where it lies): every run's
    tokens (``id_bytes`` an id) are looked up at once where the rows lie
    (:func:`fsdp_lookup_want`). With ``act_spec`` (the model's
    vocab-parallel route) a head that :func:`head_layout` gives a form is
    not gathered either: every run's last rows go to its blocks and the
    blocks' logits to position 0 (:func:`head_want`), and a spanned shard
    gets only its keys and values from its run's home."""
    import collections
    import torch
    from repro_torch.distrib.collectives import batch_groups
    from repro_torch.distrib.sharding import (Layout, lm_cache_specs,
                                              lm_param_specs, map_with_specs)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import _groups, moe_capacity
    from repro_torch.models.transformer import TransformerLM
    D, M = shape
    mesh = Mesh(shape, ("data", "model"), ["meta"] * (D * M))
    params = TransformerLM(cfg).init(torch.Generator(), device="meta")
    homes, groups = batch_groups(mesh, "data")
    c = 2 if cfg.dtype == "bfloat16" else 4
    Bd = batch // D
    span = TransformerLM(cfg, moe_group_size=group).moe_span(batch, seq, D)
    moved = collections.Counter()

    def remote(ly):
        """Per run's home, the blocks of ``ly`` that it reads from
        elsewhere."""
        return [block for home, grp in zip(homes[::span], groups[::span])
                for block in ly.blocks()
                if ([p for p in ly.holders(block) if p in grp]
                    or ly.holders(block))[0] != home]

    def gathered(x, s):
        ly = Layout(mesh, s, x.shape)
        moved["all_gather"] += (len(remote(ly)) * x.numel()
                                // len(ly.blocks()) * c)
    specs = lm_param_specs(params, cfg, "fsdp")
    kept = cfg.moe is not None and cfg.moe.moe_shard == "expert"
    for lp, sp in zip(params["layers"], specs["layers"]):
        if kept:                         # the experts where they live
            ly = Layout(mesh, sp["moe"]["wg"], lp["moe"]["wg"].shape)
            E, d = cfg.moe.n_experts, cfg.d_model
            G, S = _groups(span * Bd * seq, max(1, span * Bd * seq // group))
            C = moe_capacity(S, E, cfg.moe.top_k)
            moved["expert_send"] += (2 * len(remote(ly)) * G
                                     * ly.block_shape[0] * C * d * c)
            lp = {**lp, "moe": {"router": lp["moe"]["router"]}}
            sp = {**sp, "moe": {"router": sp["moe"]["router"]}}
        map_with_specs(gathered, lp, sp)
    table = Layout(mesh, specs["embed"], params["embed"].shape).counts
    lies = act_spec and head_layout(cfg, shape)[0] is not None
    looked = (table[0] > 1 and table[1] == 1
              and (not cfg.tie_embeddings or lies))
    head = "embed" if cfg.tie_embeddings else "head"
    top = [k for k in params if k != "layers"
           and not (k == "embed" and looked) and not (k == head and lies)]
    map_with_specs(gathered, {k: params[k] for k in top},
                   {k: specs[k] for k in top})
    runs = [[(r, span * Bd * seq) for r in range(0, D, span)]]
    if looked:
        moved.update(fsdp_lookup_want(cfg, shape, runs, False, id_bytes,
                                      lies))
    if lies:
        moved.update(head_want(cfg, shape, [[(r, span * Bd)
                                             for r in range(0, D, span)]],
                               False))
    cache = Layout(mesh, lm_cache_specs(False, batch),
                   (cfg.n_layers, batch, capacity, cfg.n_kv_heads,
                    cfg.head_dim))
    Bb, Sb = cache.block_shape[1], cache.block_shape[2]
    for pos in range(mesh.size):
        if pos not in homes:
            valid = max(0, min(Sb, seq - cache.block_of(pos)[2] * Sb))
            moved["cache_scatter"] += (2 * cfg.n_layers * Bb * valid
                                       * cfg.n_kv_heads * cfg.head_dim * 2)
    if not lies:
        moved["logits_gather"] += (D - 1) * Bd * cfg.vocab_size * c
    moved["prefill_span"] += (D - D // span) * (
        (0 if lies else Bd * cfg.vocab_size * c)
        + 2 * cfg.n_layers * Bd * seq * cfg.n_kv_heads * cfg.head_dim * 2)
    return {k: v for k, v in moved.items() if v}


def tp2d_launch_want(cfg, n_positions: int, rounds: int) -> dict:
    """Launches of one ``make_tp2d_train_step`` step in bf16: per position,
    layer and round a flash forward (again in ``remat``'s recompute) and a
    backward on the TMA + wgmma kernels, and per MoE layer three expert
    products on the tiles kernel (again in the recompute), three dX and
    three dW: every position attends over its heads and runs its experts
    (its E / M, or all of them on its d_ff columns, or all)."""
    per = n_positions * cfg.n_layers * rounds
    again = 2 if cfg.remat in ("full", "dots") else 1
    experts = 3 * per if cfg.moe is not None else 0
    return {"flash_attention_fwd_wgmma": again * per,
            "flash_attention_bwd_wgmma": per, "flash_attention_bwd": 0,
            "flash_attention_fwd": 0, "expert_gemm_wgmma": again * experts,
            "expert_gemm_dx": experts, "expert_gemm_dw": experts,
            "expert_gemm_skinny": 0, "expert_gemm": 0}


def tp2d_flips(plain_calls, mesh_calls, n_layers: int, n_homes: int,
               n_positions: int) -> list:
    """Per MoE layer, the tokens of step 0 whose top-k expert set differs
    between one card (one routing call per microbatch and layer, in that
    order, each microbatch one batch shard's rows) and the ``tp2d`` mesh
    (one per layer and position, in that order; batch shard d takes rows
    block d of the mesh's one microbatch at its positions, the first of
    which is read)."""
    check(len(plain_calls) == n_layers * n_homes
          and len(mesh_calls) >= n_layers * n_positions,
          f"routing calls: {len(plain_calls)} one card, {len(mesh_calls)} "
          f"on the mesh for {n_layers} layers of {n_positions} positions")
    flips = [0] * n_layers
    per = n_positions // n_homes
    for i in range(n_layers):
        for d in range(n_homes):
            want = plain_calls[d * n_layers + i].sort(-1).values
            got = mesh_calls[i * n_positions + d * per].sort(-1).values
            flips[i] += int((got != want).any(-1).sum())
    return flips


def phase_train_sharded_tp2d(train_smol: dict, profile: bool = False):
    """LM training on a 2 × 2 ("data", "model") mesh (the first four cards,
    or ``cuda:0`` four times) under the reference's ``tp2d`` rules, split as
    its partitioner splits them (``train.state.make_tp2d_train_step``):
    Megatron over "model" × ZeRO over "data" — each weight gathered along
    "data" into the position's "model" block and multiplied there, the
    heads and the experts split over "model", the partial products and the
    dX partials summed over "model", ``embed`` looked up where its blocks
    lie, the cross entropy per vocab block. (i) qwen3-moe-30b-a3b at
    train-lm's widths, depth, batches and schedule (``act_spec`` P("data",
    None, None), batch P("data", None)) at the reference train cell's one
    microbatch (``TP_MICRO``), its rows split over "data", 2 steps, then 2
    more from the same seed, which must repeat bit for bit;
    (ii) smollm-135m whole (30 layers, tied head: d over "data", V over
    "model"; 9 heads on 2 "model" positions, so q, k and v are gathered and
    every position attends over all of them; ``remat="dots"``) on
    train-smollm's batches in its 2 microbatches, each split over "data",
    2 steps; (iii) (i)'s model with
    ``moe_shard="ffn"`` (each expert's d_ff over "model"), 2 steps; (iv)
    fault 8: (i)'s model on ``SPAN_BATCH`` x ``SPAN_SEQ`` tokens in one
    microbatch with MoE groups of ``SPAN_GROUP``, each group spanning both
    batch shards and routed once over them, 2 steps. Each
    step's loss within ``TP_TRAIN_LOSS_RTOL`` and grad norm within
    ``TP_TRAIN_NORM_RTOL`` of a one-card run at the same microbatches
    ((i), (iii), (iv): ``one_card_steps`` at one microbatch, run here,
    since train-lm's 2 microbatches take the aux loss over other groups;
    (ii): train-smollm's; ``moe_shard`` changes only the placement); every
    collective's bytes equal to ``tp2d_bytes_want``, none of
    ``block_matmul``'s; the peak under ``TP_TRAIN_PEAK``; the launches
    exactly (``tp2d_launch_want``); the router's top-8 choices at step 0
    that differ from one card's, per layer, printed. Each leaf's AdamW
    first moment after the 2 steps against the one-card run's, within
    ``TP_LEAF_FACTOR`` times the gap of an f32 one-card run from it at
    the same microbatches (``one_card_steps``); the kernels' first inputs
    at each shape, kept by
    ``KernelCapture`` in (i)'s second run, (ii), (iii) and (iv), held
    against their plain versions and timed (``hold_captured``)."""
    import dataclasses
    import torch
    from repro_torch.config.base import TrainConfig
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.configs.smollm_135m import FULL as SMOL
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.distrib.sharding import (P, lm_param_specs,
                                              state_specs_like)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.state import (make_tp2d_train_step,
                                         new_sharded_train_state)
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(4)] if n_cards >= 4
               else ["cuda:0"] * 4)
    mesh = Mesh((2, 2), ("data", "model"), devices)
    bspec, act = P("data", None), P("data", None, None)
    D = mesh.axis_size("data")
    stationary = ("tp_act", "tp_partial", "tp_grad_act", "tp_grad_partial")
    total, out = {}, dict(mesh=str(mesh))

    def run(tag, cfg, model, tcfg, pipe, micro, tokens, prof=None,
            ref=None):
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.float32)
        specs = state_specs_like(lm_param_specs(params, cfg, "tp2d"))
        state = new_sharded_train_state(params, mesh, specs)
        names = leaf_names(params)
        del params
        torch.cuda.empty_cache()
        step = make_tp2d_train_step(model.loss, tcfg, mesh, specs, bspec,
                                    micro)
        want = tp2d_launch_want(cfg, mesh.size, micro)
        state, rows = sharded_steps(tag, step, state, mesh, pipe, 0,
                                    TP_TRAIN_STEPS, 0, total, prof, want,
                                    "train-sharded-tp2d", tokens)
        digests = state_digests(state)
        gaps = None if ref is None else moment_gaps(state, ref)
        del state, step
        torch.cuda.empty_cache()
        return rows, digests, (names, gaps)

    def hold(tag, rows, one_card, cfg, micro, rows_per_position,
             group=TRAIN_GROUP):
        got = [(r["loss"], r["grad_norm"]) for r in rows]
        want = list(zip(one_card["losses"], one_card["grad_norm"]))
        rel = [(abs(a - c) / abs(c), abs(b - d) / abs(d))
               for (a, b), (c, d) in zip(got, want)]
        moved = sum(r["collective_bytes"].get(k, 0) for r in rows
                    for k in stationary)
        bytes_want = tp2d_bytes_want(cfg, mesh.shape, rows_per_position,
                                     micro, group)
        off = [{k: (r["collective_bytes"].get(k), bytes_want.get(k))
                for k in set(r["collective_bytes"]) | set(bytes_want)
                if r["collective_bytes"].get(k) != bytes_want.get(k)}
               for r in rows]
        peak = max(r["peak_bytes"] for r in rows)
        busiest = max(max(r["position_bytes"]) for r in rows)
        warm, card = rows[-1], one_card["step_s"][1]
        say(f"  train-sharded-tp2d {tag}: the lookup's bytes a step by "
            f"name and axis {rows[0]['lookup']}")
        say(f"  train-sharded-tp2d {tag}: (loss, grad_norm) {got}; one card "
            f"{want[:len(got)]}; relative differences {rel} (bounds "
            f"{TP_TRAIN_LOSS_RTOL}, {TP_TRAIN_NORM_RTOL}); warm step "
            f"{warm['step_s']:.3f} s ({warm['tokens_per_s']:.1f} tok/s) "
            f"against one card's {card:.3f} s "
            f"({one_card['tokens_per_s'][1]:.1f} tok/s); peak {peak} B; "
            f"busiest position's state {busiest} B; bytes a step by the "
            f"formula {bytes_want}, steps off it {off}; block_matmul's "
            f"bytes {moved}")
        check(not moved, f"train-sharded-tp2d {tag}: block_matmul's moves "
                         f"ran")
        check(not any(off), f"train-sharded-tp2d {tag}: bytes off the "
                            f"formula (got, want): {off}")
        check(peak <= TP_TRAIN_PEAK,
              f"train-sharded-tp2d {tag}: peak {peak} B")
        check(all(a <= TP_TRAIN_LOSS_RTOL and b <= TP_TRAIN_NORM_RTOL
                  for a, b in rel),
              f"train-sharded-tp2d {tag}: {got} against one card's {want}")
        return dict(steps=rows, rel=rel, peak_bytes=peak,
                    busiest_state_bytes=busiest, bytes_want=bytes_want)

    # (i) qwen3-moe at train-lm's shape
    cfg = dataclasses.replace(FULL, n_layers=TRAIN_LAYERS)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    # one card at the mesh's microbatches, bf16 and f32: the aux loss is
    # taken over a microbatch's groups, so train-lm's two microbatches give
    # another function than the mesh's one, not another rounding
    kw = dict(moe_group_size=TRAIN_GROUP)
    card = one_card_steps(cfg, kw, tcfg, pipe, TP_MICRO)
    ref = card.pop("moments")
    control = one_card_steps(dataclasses.replace(cfg, dtype="float32"), kw,
                             tcfg, pipe, TP_MICRO, ref)
    say(f"  train-sharded-tp2d one card at {TP_MICRO} microbatch (the "
        f"mesh's): bf16 (loss, grad_norm) "
        f"{list(zip(card['losses'], card['grad_norm']))}, steps "
        f"{card['step_s']} s; f32 {control['losses']} (losses), "
        f"{control['grad_norm']} (grad norms)")
    # one card's routing of step 0's microbatches, from the same weights
    one = TransformerLM(cfg, moe_group_size=TRAIN_GROUP)
    params = one.init(torch.Generator(device="cuda").manual_seed(0),
                      dtype=torch.float32)
    tokens = torch.as_tensor(pipe.batch_at(0)[0], device="cuda")
    with torch.no_grad(), RouteSpy() as plain:
        plain.armed = True
        for m in tokens.chunk(TRAIN_MICRO):
            one.forward(params, m)
    del params, one
    torch.cuda.empty_cache()
    model = TransformerLM(cfg, moe_group_size=TRAIN_GROUP, act_spec=act)
    prof = (CollectiveProfiler("train-sharded-tp2d (i) 2x2") if profile
            else None)
    rows_lm = TRAIN_BATCH // TP_MICRO // D * TRAIN_SEQ
    with RouteSpy() as spy:
        spy.armed = True
        rows_i, dig_i, (names, gaps) = run(
            "(i)", cfg, model, tcfg, pipe, TP_MICRO,
            TRAIN_BATCH * TRAIN_SEQ, prof, ref)
    flips = tp2d_flips(plain.calls, spy.calls, cfg.n_layers, D, mesh.size)
    if prof is not None:
        out["profile_i"] = prof.spans
    # the second run also keeps each kernel's first input at each shape
    with KernelCapture("train") as cap:
        cap.armed = True
        rows_again, dig_again, _ = run("(i) again", cfg, model, tcfg, pipe,
                                       TP_MICRO, TRAIN_BATCH * TRAIN_SEQ)
    first = [(r["loss"], r["grad_norm"]) for r in rows_i]
    again = [(r["loss"], r["grad_norm"]) for r in rows_again]
    same = first == again and dig_i == dig_again
    say(f"  train-sharded-tp2d (i): qwen3-moe-30b-a3b FULL widths, "
        f"{cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{TP_MICRO} microbatch split over \"data\" on {mesh}; second run "
        f"from the seed "
        f"bitwise equal (losses, grad norms, {len(dig_i)} leaf digests): "
        f"{same}; step 0 tokens whose top-{cfg.moe.top_k} experts differ "
        f"from one card's, per layer: {flips} of "
        f"{TRAIN_BATCH * TRAIN_SEQ}")
    check(same, f"train-sharded-tp2d (i): the second run gave {again}, "
                f"the first {first}")
    out["i"] = hold("(i)", rows_i, card, cfg, TP_MICRO, rows_lm)
    out["i"].update(repeat_bitwise=same, flips=flips,
                    leaves=hold_leaves("train-sharded-tp2d (i)", names,
                                       gaps, control),
                    kernels=hold_captured(cap.inputs,
                                          "train-sharded-tp2d (i)",
                                          timed=True))
    cap.check_complete("train-sharded-tp2d (i)")
    del cap
    torch.cuda.empty_cache()

    # (iii) the same model with each expert's d_ff over "model"
    cfg_ffn = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, moe_shard="ffn"))
    model = TransformerLM(cfg_ffn, moe_group_size=TRAIN_GROUP, act_spec=act)
    with KernelCapture("train") as cap, RouteSpy() as spy:
        cap.armed = spy.armed = True
        rows_iii, _, (names, gaps) = run(
            "(iii)", cfg_ffn, model, tcfg, pipe, TP_MICRO,
            TRAIN_BATCH * TRAIN_SEQ, ref=ref)
    del ref
    flips = tp2d_flips(plain.calls, spy.calls, cfg.n_layers, D, mesh.size)
    say(f"  train-sharded-tp2d (iii): (i)'s model with moe_shard ffn (d_ff "
        f"{cfg.moe.d_ff_expert} over 'model'); step 0 tokens whose "
        f"top-{cfg.moe.top_k} experts differ from one card's, per layer: "
        f"{flips}")
    out["iii"] = hold("(iii)", rows_iii, card, cfg_ffn, TP_MICRO,
                      rows_lm)
    out["iii"].update(flips=flips,
                      leaves=hold_leaves("train-sharded-tp2d (iii)",
                                         names, gaps, control),
                      kernels=hold_captured(cap.inputs,
                                            "train-sharded-tp2d (iii)",
                                            timed=True))
    cap.check_complete("train-sharded-tp2d (iii)")
    del cap, plain, spy, model
    torch.cuda.empty_cache()

    # (iv) fault 8: one MoE group over both batch shards, routed once
    pipe_iv = TokenPipeline(cfg.vocab_size, SPAN_BATCH, SPAN_SEQ, seed=0)
    card_iv = one_card_steps(cfg, dict(moe_group_size=SPAN_GROUP), tcfg,
                             pipe_iv, 1)
    card_iv.pop("moments")
    model = TransformerLM(cfg, moe_group_size=SPAN_GROUP, act_spec=act)
    with KernelCapture("train") as cap:
        cap.armed = True
        rows_iv, _, _ = run("(iv)", cfg, model, tcfg, pipe_iv, 1,
                            SPAN_BATCH * SPAN_SEQ)
    say(f"  train-sharded-tp2d (iv): (i)'s model on {SPAN_BATCH} x "
        f"{SPAN_SEQ} tokens in one microbatch, MoE groups of {SPAN_GROUP} "
        f"tokens, so each group spans both batch shards (fault 8); one "
        f"card at one microbatch: (loss, grad_norm) "
        f"{list(zip(card_iv['losses'], card_iv['grad_norm']))}")
    out["iv"] = hold("(iv)", rows_iv, card_iv, cfg, 1,
                     SPAN_BATCH // D * SPAN_SEQ, SPAN_GROUP)
    out["iv"].update(kernels=hold_captured(cap.inputs,
                                           "train-sharded-tp2d (iv)",
                                           timed=True))
    cap.check_complete("train-sharded-tp2d (iv)")
    del cap, model
    torch.cuda.empty_cache()

    # (ii) smollm-135m whole, the tied head
    cfg = SMOL
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=SMOL_STEPS)
    pipe = TokenPipeline(cfg.vocab_size, SMOL_BATCH, TRAIN_SEQ, seed=0)
    ref = train_smol.pop("moments")
    control = one_card_steps(dataclasses.replace(cfg, dtype="float32"), {},
                             tcfg, pipe, SMOL_MICRO, ref)
    model = TransformerLM(cfg, act_spec=act)
    with KernelCapture("train") as cap:
        cap.armed = True
        rows_ii, _, (names, gaps) = run("(ii)", cfg, model, tcfg, pipe,
                                        SMOL_MICRO, SMOL_BATCH * TRAIN_SEQ,
                                        ref=ref)
    del ref
    say(f"  train-sharded-tp2d (ii): smollm-135m FULL, {cfg.n_layers} "
        f"layers, tied head, remat {cfg.remat}, {SMOL_BATCH} x {TRAIN_SEQ} "
        f"tokens in {SMOL_MICRO} microbatches, each split over \"data\"")
    out["ii"] = hold("(ii)", rows_ii, train_smol, cfg, SMOL_MICRO,
                     SMOL_BATCH // SMOL_MICRO // D * TRAIN_SEQ)
    out["ii"].update(leaves=hold_leaves("train-sharded-tp2d (ii)", names,
                                        gaps, control),
                     kernels=hold_captured(cap.inputs,
                                           "train-sharded-tp2d (ii)",
                                           timed=True))
    check({k[0] for k in cap.inputs} == {"flash_attention",
                                         "flash_attention_bwd"},
          f"train-sharded-tp2d (ii): captured {sorted(cap.inputs)}")
    del cap
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    say(f"phase train-sharded-tp2d: {phase_s:.1f} s wall")
    out["phase_s"] = phase_s
    return total, out


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
                "gemm_skinny", "gemm_dw", "expert_gemm_bf16",
                "expert_gemm_f32")


class StepProfiler:
    """With ``enabled``, record step 1 (the first warm step) under
    ``torch.profiler`` and report device time by op, the port's kernels
    summed by function, and the device busy share of that step's wall
    time (kept in ``record``). A no-op otherwise."""

    def __init__(self, enabled: bool, label: str):
        self.enabled = enabled
        self.label = label
        self.record = {}

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
        self.report(prof, i, wall_s)
        return out

    def report(self, prof, i: int, wall_s: float) -> None:
        from torch.autograd import DeviceType
        from repro_torch.distrib.collectives import SPANS
        rows = []
        for ev in prof.key_averages():
            # device-side events only (kernels, copies): an aten op's own
            # device time repeats that of the kernels it launched, and so
            # does a profiler range's (the sharded step's SPANS)
            if getattr(ev, "device_type", None) == DeviceType.CPU or \
                    ev.key in SPANS:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy_us = sum(r[0] for r in rows)
        self.record.update(step=i, wall_ms=wall_s * 1e3,
                           busy_ms=busy_us / 1e3,
                           busy_share=busy_us / 1e6 / wall_s)
        say(f"  profile {self.label} step {i}: wall {wall_s * 1e3:.1f} ms "
            f"(profiled), device busy {busy_us / 1e3:.1f} ms "
            f"({100 * busy_us / 1e6 / wall_s:.1f} %) in "
            f"{sum(r[1] for r in rows)} device ops")
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


class CollectiveProfiler(StepProfiler):
    """``StepProfiler`` that also reports, for each collective's profiler
    range (``distrib.collectives.SPANS``), the device time of the kernels
    and copies launched inside it (kept in ``spans``), the host time inside
    it, and the device timeline's interval from the first to the last of
    them, idle gaps included (the range's GPU annotation; all three also
    in ``record``)."""

    def __init__(self, label: str, enabled: bool = True):
        super().__init__(enabled, label)
        self.spans = {}

    def report(self, prof, i: int, wall_s: float) -> None:
        from torch.autograd import DeviceType
        from repro_torch.distrib.collectives import SPANS
        super().report(prof, i, wall_s)
        host, interval = {}, {}
        for ev in prof.key_averages():
            if ev.key not in SPANS:
                continue
            ms = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0)) / 1e3
            # a range appears twice: on the host, with the device time of
            # what it launched, and as its annotation on the device
            if getattr(ev, "device_type", DeviceType.CPU) == DeviceType.CPU:
                self.spans[ev.key] = (ms, ev.count)
                host[ev.key] = ev.cpu_time_total / 1e3
            else:
                interval[ev.key] = ms
        self.record["device_ms"] = {k: ms for k, (ms, _) in
                                    self.spans.items()}
        self.record["host_ms"] = host
        self.record["interval_ms"] = interval
        say(f"  profile {self.label}: device time under each range: "
            + ", ".join(f"{k} {ms:.3f} ms ({n}x)"
                        for k, (ms, n) in sorted(self.spans.items())))
        say(f"  profile {self.label}: host time under each range: "
            + ", ".join(f"{k} {ms:.3f} ms" for k, ms in sorted(host.items())))
        say(f"  profile {self.label}: each range's device interval (gaps "
            f"included): " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in
                                       sorted(interval.items())))
        emb = [k for k in self.spans if k.startswith("emb_")]
        self.record["lookup_ms"] = dict(
            host=sum(host[k] for k in emb),
            device=sum(self.spans[k][0] for k in emb))
        say(f"  profile {self.label}: the lookup's ranges "
            f"({', '.join(sorted(emb)) or 'none'}): host "
            f"{self.record['lookup_ms']['host']:.3f} ms, device "
            f"{self.record['lookup_ms']['device']:.3f} ms")


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



# -- phase 20: the examples (src/repro_torch/examples) on the card --------------

EX_GOOD_ATOL = 1e-4    # stored goodness, card against CPU (small-stream's)
EX_EMB_RTOL = 1e-5     # served embeddings, card against CPU
EX_TRAIN_STEPS = 60    # train_lm tiny, whole and restarted
EX_TRAIN_KILL = 50     # the restarted run's first part (its checkpoint 49)
EX_SMOLLM_STEPS = 10


def store_records(matcher) -> list:
    """The matcher's store ({key: (goodness, exact)}) after every
    ``step`` call."""
    seen, step = [], matcher.step

    def recorded(g, upd):
        out = step(g, upd)
        seen.append(dict(matcher.store._patterns))
        return out
    matcher.step = recorded
    return seen


def seeded_time(seed: int = 3):
    """A seeded reward-time schedule (the examples' ``reward_time``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return lambda elapsed: float(rng.uniform(0.02, 0.2))


def step_counts(st) -> tuple:
    return (st.n_new_patterns, st.n_patterns_total, st.n_exact_total,
            st.n_recompute, st.community_size)


def hold_ell(inputs, path: str) -> dict:
    """Each captured ELL sweep (``Capture``) held against its plain
    version and timed beside its bound: the SpMM within SPMM_RTOL
    (``compare_spmm``), the reach bitwise (``time_captured_bfs``)."""
    import torch
    from repro_torch.kernels.measure import cuda_ms, gather_floor
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    out = {}
    for key in ("label_rwr", "expansion_rwr"):
        if key not in inputs:
            continue
        cols, vals, mask, row_ids, x, n = inputs[key]
        index = build_row_index(mask, row_ids, n)
        abs_err, rel_err = compare_spmm(ops, ref, cols, vals, mask, row_ids,
                                        x, n, index, f"captured {path} {key}")
        ms = cuda_ms(lambda: ops.ell_spmm(cols, vals, mask, row_ids, x, n,
                                          index=index), REPS)
        plain = cuda_ms(lambda: ref.ell_spmm_ref(cols, vals, mask, row_ids,
                                                 x, n), REPS)
        csr = spmm_csr(cols, vals, mask, row_ids, n, x.shape[0])
        lib = cuda_ms(lambda: torch.sparse.mm(csr, x), REPS)
        b_ms, b_by, nbytes, _ = spmm_bound(mask, x, n, True)
        floor = gather_floor(mask, x.shape[1])
        say(f"  ell_spmm captured {path} {key}: nnz={int(mask.sum())} "
            f"{ms:.4f} ms, plain {plain:.4f} ms, torch.sparse.mm(csr) "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B), "
            f"gather floor {floor:.4f} ms")
        out[key] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                        plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                        bound_by=b_by, gather_floor_ms=floor,
                        nnz=int(mask.sum()), R=cols.shape[0], n=n,
                        d=x.shape[1])
    if "bfs" in inputs:
        out["bfs"] = time_captured_bfs(inputs["bfs"], path)
    return out


def phase_examples():
    """Phase 20: ``src/repro_torch/examples`` on the card (the module
    docstring)."""
    import dataclasses
    import math
    import shutil
    import torch
    from repro_torch.examples import dynamic_gnn_serving as EG
    from repro_torch.examples import quickstart as EQ
    from repro_torch.examples import train_lm as ET
    from repro_torch.kernels.spmv_ell import ops as ell_ops
    from repro_torch.optim.adamw import tree_leaves
    t_phase = time.perf_counter()
    total, res = {}, {}
    quiet = lambda *a, **k: None  # noqa: E731

    # quickstart at its own settings, each matcher on the card and (Batch,
    # Inc) on the CPU with the ELL sweeps' plain versions
    spec, cfg, query = EQ.stream_config()
    say(f"  quickstart: stream {spec.n_vertices} vertices, {spec.n_edges} "
        f"edges ({spec.kind}); query {query.name}")
    qs = {}
    for name in EQ.MATCHERS:
        m = EQ.build(name, query, cfg, "cuda")
        stores = store_records(m)
        reset_all_counts()
        with Capture(ell_ops, cfg.n_labels) as cap:
            t0 = time.perf_counter()
            r = EQ.run(m, spec, "cuda")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        launches = {k: v for k, v in read_all_counts().items() if v}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        check(set(launches) <= {"ell_spmm", "ell_reach"}
              and launches.get("ell_spmm", 0) > 0
              and launches.get("ell_reach", 0) > 0,
              f"examples quickstart {name}: launches {launches}")
        check({"label_rwr", "bfs"} <= set(cap.inputs),
              f"examples quickstart {name}: captured {sorted(cap.inputs)}")
        held = hold_ell(cap.inputs, f"quickstart {name}")
        row = dict(igpm_s=r["elapsed"], wall_s=r["wall"], run_s=run_s,
                   patterns=r["patterns"], exact=r["exact"],
                   step_s=[s.elapsed for s in r["steps"]],
                   last_recompute=r["steps"][-1].n_recompute,
                   launches=launches, held=held)
        say(f"  {name:9s} igpm={r['elapsed']:7.3f}s wall={r['wall']:6.1f}s "
            f"patterns={r['patterns']:4d} (exact={r['exact']}) last-step "
            f"recompute={r['steps'][-1].n_recompute}; per step "
            f"{[round(t * 1e3, 2) for t in row['step_s']]} ms; launches "
            f"{launches}")
        if name != "adaptive":
            cm = EQ.build(name, query, dataclasses.replace(cfg, backend="ell"),
                          "cpu")
            cpu_stores = store_records(cm)
            t0 = time.perf_counter()
            cr = EQ.run(cm, spec, "cpu")
            row["cpu_s"] = time.perf_counter() - t0
            check([step_counts(s) for s in r["steps"]]
                  == [step_counts(s) for s in cr["steps"]],
                  f"examples quickstart {name}: card and CPU step counts "
                  f"differ")
            worst = 0.0
            for a, b in zip(stores, cpu_stores, strict=True):
                check(sorted(a) == sorted(b), f"examples quickstart {name}: "
                                              f"card and CPU stores differ")
                for key, (good, exact) in a.items():
                    check(exact == b[key][1],
                          f"examples quickstart {name}: exact flags differ")
                    worst = max(worst, abs(good - b[key][0]))
            check(worst <= EX_GOOD_ATOL, f"examples quickstart {name}: "
                                         f"goodness differs by {worst}")
            row["max_goodness_diff"] = worst
            say(f"  quickstart {name}: card == CPU (backend ell) on "
                f"{len(stores)} steps, {r['patterns']} patterns, max "
                f"goodness diff {worst:.3e}; CPU run {row['cpu_s']:.1f} s")
            del cm, cr
        qs[name] = row
        del m, r, cap
    b, i = qs["batch"]["igpm_s"], qs["inc"]["igpm_s"]
    qs["speedup_inc_vs_batch"] = b / max(i, 1e-9)
    qs["speedup_adaptive_vs_inc"] = i / max(qs["adaptive"]["igpm_s"], 1e-9)
    say(f"  quickstart: incremental speedup vs batch "
        f"{qs['speedup_inc_vs_batch']:.2f}x, adaptive vs inc "
        f"{qs['speedup_adaptive_vs_inc']:.2f}x (at scale 0.01, one card); "
        f"patterns batch={qs['batch']['patterns']} "
        f"adaptive={qs['adaptive']['patterns']}")
    res["quickstart"] = qs
    torch.cuda.empty_cache()

    # dynamic_gnn_serving: the CPU draws the weights, features and agent
    cpu = EG.build("cpu")
    card = EG.build("cuda", params=tree_to(cpu["params"], "cuda"),
                    feats=cpu["feats"].to("cuda"),
                    agent=cpu["pem"].agent.state_dict())
    reset_all_counts()
    t0 = time.perf_counter()
    got = EG.run(card, reward_time=seeded_time(),
                 print_fn=lambda line: say(f"  gnn: {line}"))
    gnn_s = time.perf_counter() - t0
    check_no_launches(read_all_counts(), "examples dynamic_gnn_serving")
    want = EG.run(cpu, reward_time=seeded_time(), print_fn=quiet)
    for a, w in zip(got, want, strict=True):
        check(bool((a["mask"] == w["mask"]).all()) and a["frac"] == w["frac"]
              and a["c"] == w["c"], "examples dynamic_gnn_serving: card and "
                                    "CPU recompute sets or c differ")
        err = float((a["emb"].cpu() - w["emb"]).abs().max())
        check(err <= EX_EMB_RTOL * float(w["emb"].abs().max()),
              f"examples dynamic_gnn_serving: embeddings differ by {err}")
    res["dynamic_gnn_serving"] = dict(
        run_s=gnn_s, c=[a["c"] for a in got],
        recompute=[int(a["mask"].sum()) for a in got],
        drift=[a["drift"] for a in got],
        t_full_ms=[a["t_full"] * 1e3 for a in got],
        t_pem_ms=[a["t_pem"] * 1e3 for a in got])
    say(f"  dynamic_gnn_serving: card == CPU recompute sets and c over "
        f"{len(got)} steps, no port kernel; t_full "
        f"{[round(a['t_full'] * 1e3, 2) for a in got]} ms, t_pem "
        f"{[round(a['t_pem'] * 1e3, 2) for a in got]} ms")
    del cpu, card, got, want

    # train_lm: tiny whole, tiny killed at 50 and restarted, smollm
    base = ROOT / "build" / "examples_train_lm"
    shutil.rmtree(base, ignore_errors=True)
    tiny, batch, seq = ET.preset_config("tiny", 8, 128)
    try:
        reset_all_counts()
        with KernelCapture("train") as kcap:
            kcap.armed = True
            whole = ET.build(tiny, EX_TRAIN_STEPS, batch, seq,
                             str(base / "whole"), "cuda", print_fn=quiet)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mw = ET.run(whole, EX_TRAIN_STEPS)
            torch.cuda.synchronize()
            tiny_s = time.perf_counter() - t0
        launches = {k: v for k, v in read_all_counts().items() if v}
        want_l = {k: tiny.n_layers * EX_TRAIN_STEPS
                  for k in ("flash_attention_fwd", "flash_attention_bwd")}
        check(launches == want_l, f"examples train_lm tiny: launches "
                                  f"{launches}, expected {want_l}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        held = hold_captured(kcap.inputs, "examples train_lm", timed=True)
        for k in want_l:
            check(any(h["kernel"] == k for h in held),
                  f"examples train_lm: no input of {k} captured")
        first = ET.build(tiny, EX_TRAIN_STEPS, batch, seq,
                         str(base / "restart"), "cuda", print_fn=quiet)
        ET.run(first, EX_TRAIN_KILL)
        again = ET.build(tiny, EX_TRAIN_STEPS, batch, seq,
                         str(base / "restart"), "cuda", print_fn=quiet)
        check(again.start_step == EX_TRAIN_KILL,
              f"examples train_lm: restarted at {again.start_step}")
        rest = ET.run(again, EX_TRAIN_STEPS)
        check(rest.losses == mw.losses[EX_TRAIN_KILL:]
              and all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(whole.state), tree_leaves(again.state))),
              "examples train_lm: the restarted run is not bitwise the "
              "whole run's")
        smol, sb, ss = ET.preset_config("smollm", 8, 128)
        loop = ET.build(smol, EX_SMOLLM_STEPS, sb, ss, str(base / "smollm"),
                        "cuda", learning_rate=6e-4, print_fn=quiet)
        t0 = time.perf_counter()
        ms = ET.run(loop, EX_SMOLLM_STEPS)
        torch.cuda.synchronize()
        smol_s = time.perf_counter() - t0
        check(all(math.isfinite(x) for x in ms.losses)
              and ms.losses[-1] < ms.losses[0],
              f"examples train_lm smollm: losses {ms.losses}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    res["train_lm"] = dict(
        tiny_losses=mw.losses, tiny_s=tiny_s,
        tiny_step_ms=[t * 1e3 for t in mw.step_times],
        restart_bitwise=True, launches=launches, held=held,
        smollm_losses=ms.losses, smollm_s=smol_s,
        smollm_step_ms=[t * 1e3 for t in ms.step_times])
    say(f"  train_lm tiny: {EX_TRAIN_STEPS} steps in {tiny_s:.2f} s, loss "
        f"{mw.losses[0]:.4f} -> {mw.losses[-1]:.4f}; restarted at "
        f"{EX_TRAIN_KILL}, steps {EX_TRAIN_KILL}-{EX_TRAIN_STEPS - 1} "
        f"bitwise the whole run's; launches {launches}")
    say(f"  train_lm smollm: {EX_SMOLLM_STEPS} steps in {smol_s:.2f} s, "
        f"losses {[round(x, 4) for x in ms.losses]}")
    del whole, first, again, loop
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"phase examples: {res['phase_s']:.1f} s wall")
    return total, res


# -- phases 16-20: BST and the GNNs (no Pallas kernel lies on these paths) ------

def grads_against(card, cpu):
    """(largest |difference|, largest share of the allowance used) of card
    gradients against CPU ones: ``AGREE_GRAD_RTOL`` of each entry plus
    ``AGREE_GRAD_FLOOR`` of the leaf's largest entry, the tolerance the
    CPU tests hold the port to against JAX."""
    err, used = 0.0, 0.0
    for a, b in zip(card, cpu):
        diff = (a.cpu() - b).abs()
        allow = (AGREE_GRAD_RTOL * b.abs()
                 + AGREE_GRAD_FLOOR * float(b.abs().max()) + 1e-30)
        err = max(err, float(diff.max()))
        used = max(used, float((diff / allow).max()))
    return err, used


def loss_and_grads(loss_fn, params):
    from repro_torch.optim.adamw import tree_leaves
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    loss = loss_fn(params)
    loss.backward()
    grads = [t.grad.detach().clone() for t in leaves]
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return float(loss.detach()), grads


def check_no_launches(counts, path: str) -> None:
    """These paths run no kernel of the port: the reference computes them
    outside any Pallas kernel."""
    launched = {k: v for k, v in counts.items() if v}
    check(not launched, f"{path}: launched {launched}")


def phase_bst_agreement():
    """BST ``SMOKE`` in f32 on the card and on the CPU from one set of
    weights: click probabilities of the serve_p99 cell and retrieval
    scores within ``BST_AGREE_TOL`` (rtol, with atol a tenth of it), the
    train cell's loss within ``AGREE_LOSS_RTOL`` and every gradient leaf
    within ``AGREE_GRAD_RTOL`` plus ``AGREE_GRAD_FLOOR`` of its largest
    entry (the CPU tests' tolerances against JAX); launch counts set to 0
    before and read after."""
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.cells import bst_cell
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("bst", smoke=True)
    reset_all_counts()
    res = {}
    for dev in ("cuda", "cpu"):
        out = {}
        for shape in ("serve_p99", "retrieval_cand", "train_batch"):
            # the cells draw their weights on the CPU, then move them
            cell = bst_cell(arch, shape, "cpu", smoke=True)
            params = (cell.args[0].params if shape == "train_batch"
                      else cell.args[0])
            params = tree_to(params, dev)
            args = tree_to(list(cell.args[1:]), dev)
            if shape == "train_batch":
                out["loss"], out["grads"] = loss_and_grads(
                    lambda p: cell.model.loss(p, args[0]), params)
            else:
                with torch.no_grad():
                    out[shape] = cell.step_fn(params, *args).cpu()
        res[dev] = out
    counts = read_all_counts()
    card, cpu = res["cuda"], res["cpu"]
    errs = {}
    for shape in ("serve_p99", "retrieval_cand"):
        a, b = card[shape], cpu[shape]
        errs[shape] = float((a - b).abs().max())
        check(torch.allclose(a, b, rtol=BST_AGREE_TOL,
                             atol=BST_AGREE_TOL / 10),
              f"bst-agreement: {shape} differs by {errs[shape]:.3e}")
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_err, grad_used = grads_against(card["grads"], cpu["grads"])
    say(f"phase bst-agreement: SMOKE f32, probs[:4] card "
        f"{card['serve_p99'][:4].tolist()} (largest difference "
        f"{errs['serve_p99']:.3e}); retrieval scores largest difference "
        f"{errs['retrieval_cand']:.3e}; loss card {card['loss']:.8f} cpu "
        f"{cpu['loss']:.8f} (relative {loss_rel:.3e}); {len(card['grads'])} "
        f"gradient leaves, largest difference {grad_err:.3e} "
        f"({grad_used:.3f} of the allowance); launches {counts}")
    check(loss_rel <= AGREE_LOSS_RTOL,
          f"bst-agreement: loss differs by {loss_rel:.3e}")
    check(grad_used <= 1.0, "bst-agreement: gradients outside tolerance")
    check_no_launches(counts, "bst-agreement")
    return dict(max_abs=errs, loss_rel=loss_rel, grad_max_abs=grad_err,
                grad_tol_used=grad_used)


def timed_calls(fn, reps: int, prof=None):
    """``reps`` warm calls of ``fn``, each ended by a synchronise: seconds
    per call (two calls before them warm up; under ``--profile`` the
    second is profiled)."""
    import torch
    for i in range(2):
        prof.step(i, fn) if prof is not None else fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_serve_bst(profile: bool = False):
    """BST ``FULL`` (published widths, seeded f32 weights on the card)
    serving its three serve shapes: serve_p99 (512 users), serve_bulk
    (262,144 users) and retrieval_cand (1 user against 1,000,448
    candidates, 1,000,000 padded to a multiple of 512): p50/p99 over
    ``BST_REPS`` warm calls and the peak memory of each; probabilities in
    (0, 1) and finite scores of the expected shapes; launch counts set to
    0 before and read after."""
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.cells import bst_cell
    t_phase = time.perf_counter()
    arch = get_arch("bst")
    cfg = arch.model
    reset_all_counts()
    out = {}
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        t0 = time.perf_counter()
        cell = bst_cell(arch, shape, "cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result = {}

        def call():
            with torch.no_grad():
                result["y"] = cell.step_fn(*cell.args)

        secs = timed_calls(call, BST_REPS,
                           StepProfiler(profile, f"serve-bst {shape}"))
        peak = torch.cuda.max_memory_allocated()
        y = result.pop("y")
        B = cell.meta["batch"]
        want = (B, cell.meta["candidates"]) if shape == "retrieval_cand" \
            else (B,)
        check(tuple(y.shape) == want and bool(torch.isfinite(y).all()),
              f"serve-bst {shape}: shape {tuple(y.shape)}, want {want}, "
              f"finite {bool(torch.isfinite(y).all())}")
        if shape != "retrieval_cand":
            check(bool(((y > 0) & (y < 1)).all()),
                  f"serve-bst {shape}: probabilities outside (0, 1)")
        st = ms_stats(secs)
        say(f"  serve-bst {shape}: batch {B}{', candidates ' + str(cell.meta['candidates']) if shape == 'retrieval_cand' else ''}; "
            f"p50 {st['p50']:.4f} ms, p99 {st['p99']:.4f} ms over "
            f"{st['n']} warm calls ({B / st['p50'] * 1e3:.1f} users/s at "
            f"p50); peak memory {peak} B; cell built in {build_s:.2f} s; "
            f"first outputs {y.reshape(-1)[:4].tolist()}")
        out[shape] = dict(st, peak_bytes=peak, build_s=build_s, batch=B)
        del cell, y, result
        torch.cuda.empty_cache()
    counts = read_all_counts()
    check_no_launches(counts, "serve-bst")
    n_params = ((cfg.n_items + cfg.n_cates) * cfg.embed_dim
                + cfg.n_user_feats * cfg.user_feat_vocab * cfg.embed_dim)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase serve-bst: {out['phase_s']:.1f} s wall (embedding tables "
        f"{n_params} params; launches {counts})")
    return out


def train_repeat(cell, steps: int, fresh_state, prof=None):
    """``steps`` steps of the cell's train step from ``cell.args``, then
    the same steps from ``fresh_state()`` (the same seed): per run the
    losses, grad norms and step seconds (each step ended by a
    synchronise), and the peak memory of the first run. Under
    ``--profile`` step 1 of the first run is profiled (its time then
    includes the profiler's)."""
    import torch
    state, batch = cell.args
    runs = []
    peak = None
    for run in range(2):
        if run:
            del state
            torch.cuda.empty_cache()
            state = fresh_state()
        else:
            torch.cuda.reset_peak_memory_stats()
        losses, gnorms, secs = [], [], []
        for i in range(steps):
            t0 = time.perf_counter()
            if run == 0 and prof is not None:
                state, m = prof.step(i, lambda: cell.step_fn(state, batch))
            else:
                state, m = cell.step_fn(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        if peak is None:
            peak = torch.cuda.max_memory_allocated()
        runs.append((losses, gnorms, secs))
    del state
    return runs, peak


def phase_train_bst(profile: bool = False):
    """BST ``FULL`` trained at train_batch's published batch (65,536
    users): ``BST_TRAIN_STEPS`` steps of ``make_train_step(model.loss,
    TrainConfig())``, then the same steps again from the same seed; losses
    and grad norms must be bitwise equal; step s, samples/s and the peak
    memory are printed; launch counts set to 0 before and read after."""
    import math
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.cells import bst_cell
    from repro_torch.train.state import new_train_state
    t_phase = time.perf_counter()
    arch = get_arch("bst")
    cell = bst_cell(arch, "train_batch", "cuda")
    n_params = sum(t.numel() for t in _leaves(cell.args[0].params))
    B = cell.meta["batch"]
    reset_all_counts()
    runs, peak = train_repeat(
        cell, BST_TRAIN_STEPS, lambda: new_train_state(cell.model.init(
            torch.Generator(device="cuda").manual_seed(0))),
        StepProfiler(profile, "train-bst"))
    counts = read_all_counts()
    (l1, g1, s1), (l2, g2, s2) = runs
    for i, (loss, gn, dt) in enumerate(zip(l1, g1, s1)):
        say(f"  train-bst step {i}: loss {loss!r} grad_norm {gn!r} step "
            f"{dt:.4f} s ({B / dt:.1f} samples/s)")
    same = (l1 == l2) and (g1 == g2)
    say(f"  train-bst second run from the seed: losses {l2}, steps "
        f"{[f'{x:.4f}' for x in s2]} s; bitwise equal: {same}")
    say(f"phase train-bst: FULL, batch {B}, {n_params} params "
        f"({16 * n_params} B of f32 state); peak memory {peak} B; "
        f"{time.perf_counter() - t_phase:.1f} s wall; launches {counts}")
    check(n_params == 153_865_665, f"train-bst: {n_params} params")
    check(all(map(math.isfinite, l1 + g1)), f"train-bst: losses {l1}")
    check(same, f"train-bst: the second run gave losses {l2} grad norms "
                f"{g2}, the first {l1} {g1}")
    check_no_launches(counts, "train-bst")
    del cell
    torch.cuda.empty_cache()
    return dict(batch=B, n_params=n_params, losses=l1, grad_norm=g1,
                step_s=s1 + s2, samples_per_s=[B / dt for dt in s1 + s2],
                peak_bytes=peak, bitwise_repeat=same,
                phase_s=time.perf_counter() - t_phase)


GNN_KINDS = ("schnet", "dimenet", "meshgraphnet", "graphcast")


def phase_gnn_agreement():
    """Each GNN's ``SMOKE`` config (f32) on its full_graph_sm cell, card
    against CPU from one set of weights: predictions within
    ``BST_AGREE_TOL`` of the largest, the loss within ``AGREE_LOSS_RTOL``,
    every gradient leaf within ``AGREE_GRAD_RTOL`` plus
    ``AGREE_GRAD_FLOOR`` of its largest entry; launch counts set to 0
    before and read after."""
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.cells import gnn_cell
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_all_counts()
    out = {}
    for kind in GNN_KINDS:
        cell = gnn_cell(get_arch(kind, smoke=True), "full_graph_sm", "cpu",
                        smoke=True)
        res = {}
        for dev in ("cuda", "cpu"):
            params = tree_to(cell.args[0].params, dev)
            inputs = tree_to(cell.args[1], dev)
            with torch.no_grad():
                pred = cell.model.forward(params, inputs).cpu()
            loss, grads = loss_and_grads(
                lambda p: cell.model.loss(p, inputs), params)
            res[dev] = (pred, loss, grads)
        (pa, la, ga), (pb, lb, gb) = res["cuda"], res["cpu"]
        pred_err = float((pa - pb).abs().max())
        loss_rel = abs(la - lb) / abs(lb)
        grad_err, grad_used = grads_against(ga, gb)
        say(f"phase gnn-agreement: {kind} SMOKE f32 ({cell.meta}): "
            f"predictions largest difference {pred_err:.3e}; loss card "
            f"{la:.8f} cpu {lb:.8f} (relative {loss_rel:.3e}); {len(ga)} "
            f"gradient leaves, largest difference {grad_err:.3e} "
            f"({grad_used:.3f} of the allowance)")
        check(pred_err <= BST_AGREE_TOL * float(pb.abs().max()),
              f"gnn-agreement {kind}: predictions differ by {pred_err:.3e}")
        check(loss_rel <= AGREE_LOSS_RTOL,
              f"gnn-agreement {kind}: loss differs by {loss_rel:.3e}")
        check(grad_used <= 1.0,
              f"gnn-agreement {kind}: gradients outside tolerance")
        out[kind] = dict(pred_max_abs=pred_err, loss_rel=loss_rel,
                         grad_max_abs=grad_err, grad_tol_used=grad_used)
    check_no_launches(read_all_counts(), "gnn-agreement")
    return out


def phase_train_gnn(profile: bool = False):
    """Each GNN at its ``FULL`` widths (bf16 message passing, f32 masters)
    on the reference's published cell sizes: minibatch_lg for all four (N
    169,984, E 168,960, d_feat 602; DimeNet's 1,351,680 triplets,
    GraphCast's refinement-6 multimesh of 40,962 nodes and 245,760 arcs
    under that grid) and molecule for SchNet and DimeNet (N 3,840, E
    16,384). ``GNN_TRAIN_STEPS`` steps of ``make_train_step(model.loss,
    TrainConfig())``, then the same steps from the same seed: losses and
    grad norms must be bitwise equal; step s, arcs/s and peak memory
    printed; launch counts set to 0 before and read after."""
    import math
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.cells import gnn_cell
    from repro_torch.models.gnn.graphcast import mesh_sizes
    from repro_torch.train.state import new_train_state
    t_phase = time.perf_counter()
    reset_all_counts()
    out = {}
    for kind, shape in GNN_TRAIN_CELLS:
        arch = get_arch(kind)
        t0 = time.perf_counter()
        cell = gnn_cell(arch, shape, "cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        state, inputs = cell.args
        d_feat = inputs.node_feat.shape[1]
        n_params = sum(t.numel() for t in _leaves(state.params))
        arcs = (mesh_sizes(arch.model.mesh_refinement)["mesh_arcs"]
                if kind == "graphcast" else cell.meta["n_edges"])
        runs, peak = train_repeat(
            cell, GNN_TRAIN_STEPS, lambda: new_train_state(cell.model.init(
                torch.Generator(device="cuda").manual_seed(0),
                d_feat=d_feat)),
            StepProfiler(profile, f"train-gnn {kind}/{shape}"))
        (l1, g1, s1), (l2, g2, s2) = runs
        same = (l1 == l2) and (g1 == g2)
        extra = ""
        if kind == "dimenet":
            extra = f", T {inputs.trip_kj.shape[0]} triplets"
        if kind == "graphcast":
            extra = (f", mesh {mesh_sizes(arch.model.mesh_refinement)} "
                     f"under the grid")
        warm = s1[1:] + s2[1:]
        say(f"  train-gnn {kind}/{shape}: N {cell.meta['n_nodes']}, E "
            f"{cell.meta['n_edges']}{extra}, d_feat {d_feat}, {n_params} "
            f"params; losses {l1} grad norms {g1}; steps "
            f"{[f'{x:.4f}' for x in s1]} then {[f'{x:.4f}' for x in s2]} s "
            f"({arcs / min(warm):.1f} arcs/s at the fastest warm step); "
            f"peak memory {peak} B; second run bitwise equal: {same}; cell "
            f"built in {build_s:.2f} s")
        # the reference's MeshGraphNet and GraphCast processors have no
        # normalisation, so at full depth on these random cells the
        # activations grow layer by layer (the port matches the reference
        # there: tests/test_torch_gnn.py::test_full_width_and_depth_match_reference)
        # and GraphCast's f32 global grad norm overflows to inf; a NaN
        # would be a fault
        overflow = [g for g in g1 if math.isinf(g)]
        if overflow:
            say(f"  train-gnn {kind}/{shape}: the global grad norm "
                f"overflows f32 ({len(overflow)} of {len(g1)} steps), so "
                f"clipping zeroes the gradient and AdamW only decays")
        check(all(map(math.isfinite, l1))
              and not any(map(math.isnan, g1)),
              f"train-gnn {kind}/{shape}: losses {l1} grad norms {g1}")
        check(same, f"train-gnn {kind}/{shape}: the second run gave "
                    f"losses {l2} grad norms {g2}, the first {l1} {g1}")
        out[f"{kind}/{shape}"] = dict(
            n_nodes=cell.meta["n_nodes"], n_edges=cell.meta["n_edges"],
            arcs=arcs, n_params=n_params, losses=l1, grad_norm=g1,
            step_s=s1 + s2, arcs_per_s=[arcs / dt for dt in s1 + s2],
            peak_bytes=peak, bitwise_repeat=same, build_s=build_s)
        del cell, state, inputs
        torch.cuda.empty_cache()
    counts = read_all_counts()
    check_no_launches(counts, "train-gnn")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase train-gnn: {out['phase_s']:.1f} s wall; launches {counts}")
    return out



def mesh_train_run(cell, steps: int, fresh_state, mesh, prof=None):
    """``steps`` steps of a placed cell's sharded step from ``cell.args``
    and, with ``fresh_state``, the same steps again from
    ``fresh_state()``: per run the losses, grad norms, step seconds, and
    the collective bytes of each step; the peak memory and the bytes each
    position stores after the first run. Under ``--profile`` step 1 of the
    first run is profiled."""
    import torch
    from repro_torch.distrib.sharding import position_bytes
    state, batch = cell.args
    runs, peak, held = [], None, None
    for run in range(2 if fresh_state else 1):
        if run:
            del state
            torch.cuda.empty_cache()
            state = fresh_state()
        else:
            torch.cuda.reset_peak_memory_stats()
        losses, gnorms, secs, coll = [], [], [], []
        for i in range(steps):
            mesh.reset_bytes()
            t0 = time.perf_counter()
            if run == 0 and prof is not None:
                state, m = prof.step(i, lambda: cell.step_fn(state, batch))
            else:
                state, m = cell.step_fn(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            coll.append(dict(mesh.bytes))
        if peak is None:
            peak = torch.cuda.max_memory_allocated()
            held = position_bytes(state)
        runs.append((losses, gnorms, secs, coll))
    return state, runs, peak, held


def phase_train_sharded_gnn(train_gnn: dict, profile: bool = False):
    """The four GNNs of train-gnn (``FULL`` widths, bf16 message passing,
    f32 masters) on minibatch_lg (N 169,984, E 168,960; DimeNet's
    1,351,680 triplets; GraphCast's 245,760 mesh arcs) trained by the
    cells' edge-sharded step: the edge arrays split over "data". On a 2 ×
    2 mesh (``cuda:0`` × 4 on one card) ``GNN_TRAIN_STEPS`` steps, then
    the same steps from the seed, which must repeat bitwise; step 0's loss
    within ``GNN_FOLDS[kind] · GNN_FOLD_ULP`` of train-gnn's one-card loss
    (an inf grad norm on both sides agrees, a NaN is a fault). On a (1, 2)
    mesh, one edge block: losses and grad norms bitwise train-gnn's.
    Bytes per collective, step s, arcs/s and the peak are printed; launch
    counts set to 0 before and read after."""
    import math
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.distrib.sharding import state_specs_like
    from repro_torch.launch.cells import gnn_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.gnn.graphcast import mesh_sizes
    from repro_torch.train.state import new_sharded_train_state
    t_phase = time.perf_counter()
    devices, how = smoke_mesh()
    reset_all_counts()
    out = {}
    for kind in GNN_KINDS:
        arch = get_arch(kind)
        one = train_gnn[f"{kind}/minibatch_lg"]
        res = {}
        for shape in ((2, 2), (1, 2)):
            mesh = Mesh(shape, ("data", "model"),
                        devices[:shape[0] * shape[1]])
            t0 = time.perf_counter()
            cell = gnn_cell(arch, "minibatch_lg", "cuda", mesh=mesh)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            d_feat = cell.args[1].node_feat.shape[1]
            specs = cell.in_shardings[0]

            def fresh(cell=cell, mesh=mesh, specs=specs):
                return new_sharded_train_state(cell.model.init(
                    torch.Generator(device="cuda").manual_seed(0),
                    d_feat=d_feat), mesh, specs)

            mesh2 = shape == (2, 2)
            state, runs, peak, held = mesh_train_run(
                cell, GNN_TRAIN_STEPS, fresh if mesh2 else None, mesh,
                StepProfiler(profile and mesh2,
                             f"train-sharded-gnn {kind}"))
            res[shape] = dict(runs=runs, peak=peak, held=held,
                              build_s=build_s)
            del cell, state
            torch.cuda.empty_cache()
        (l1, g1, s1, c1), (l2, g2, s2, _) = res[(2, 2)]["runs"]
        (lo, go, so, co), = res[(1, 2)]["runs"]
        arcs = one["arcs"]
        same = (l1 == l2) and (g1 == g2)
        one_block = (lo == one["losses"]) and (go == one["grad_norm"])
        bound = GNN_FOLDS[kind] * GNN_FOLD_ULP
        rel = abs(l1[0] - one["losses"][0]) / abs(one["losses"][0])
        norm_ok = (math.isinf(g1[0]) and math.isinf(one["grad_norm"][0])) \
            or (math.isfinite(g1[0]) and math.isfinite(one["grad_norm"][0]))
        warm = s1[1:] + s2[1:]
        say(f"  train-sharded-gnn {kind}/minibatch_lg on 2 x 2 ({how}): "
            f"losses {l1} grad norms {g1}; second run bitwise equal: "
            f"{same}; step 0 loss against one card's {one['losses'][0]!r}: "
            f"relative {rel:.3e}, {rel / bound:.3f} of the bound "
            f"{bound:.4f} ({GNN_FOLDS[kind]} folds x 2^-7); steps "
            f"{[f'{x:.4f}' for x in s1]} then {[f'{x:.4f}' for x in s2]} s "
            f"({arcs / min(warm):.1f} arcs/s at the fastest warm step; one "
            f"card {max(one['arcs_per_s']):.1f}); peak "
            f"{res[(2, 2)]['peak']} B; bytes per position "
            f"{res[(2, 2)]['held']}; collective bytes per step {c1[0]}; "
            f"cell built in {res[(2, 2)]['build_s']:.2f} s")
        say(f"  train-sharded-gnn {kind}/minibatch_lg on 1 x 2 (one edge "
            f"block): losses {lo} grad norms {go}; bitwise train-gnn's: "
            f"{one_block}; steps {[f'{x:.4f}' for x in so]} s; collective "
            f"bytes per step {co[0]}")
        check(all(map(math.isfinite, l1))
              and not any(map(math.isnan, g1 + go)),
              f"train-sharded-gnn {kind}: losses {l1} grad norms {g1} {go}")
        check(same, f"train-sharded-gnn {kind}: the second run gave losses "
                    f"{l2} grad norms {g2}, the first {l1} {g1}")
        check(rel <= bound, f"train-sharded-gnn {kind}: step 0 loss "
                            f"{l1[0]!r} is {rel:.3e} from one card's "
                            f"{one['losses'][0]!r} (bound {bound:.4f})")
        check(norm_ok, f"train-sharded-gnn {kind}: grad norm {g1[0]!r}, "
                       f"one card {one['grad_norm'][0]!r}")
        check(one_block, f"train-sharded-gnn {kind}: one edge block gave "
                         f"losses {lo} grad norms {go}, one card "
                         f"{one['losses']} {one['grad_norm']}")
        out[kind] = dict(
            losses=l1, grad_norm=g1, loss_rel=rel, bound=bound,
            bound_used=rel / bound, bitwise_repeat=same,
            one_block_bitwise=one_block, step_s=s1 + s2,
            arcs_per_s=[arcs / dt for dt in s1 + s2],
            peak_bytes=res[(2, 2)]["peak"],
            position_bytes=res[(2, 2)]["held"], collective_bytes=c1[0],
            one_block_step_s=so)
    counts = read_all_counts()
    check_no_launches(counts, "train-sharded-gnn")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase train-sharded-gnn: {out['phase_s']:.1f} s wall; launches "
        f"{counts}")
    return out


def phase_train_sharded_bst(profile: bool = False):
    """BST ``FULL`` at train_batch's published batch (65,536 users) on a 2
    × 2 mesh (``cuda:0`` × 4 on one card) under the reference's training
    rules: the item table's rows split over "model", looked up where they
    lie. ``BST_TRAIN_STEPS`` steps of the cell's sharded step (the
    reference cell's one microbatch, its rows over the two batch shards):
    losses and grad norms within ``BST_M1_RTOL`` of ``make_train_step(
    model.loss, TCFG)`` on one card, each home's loss sum and count
    crossing once (``loss_sum``); then the same cell's step at two
    microbatches, one a batch shard: losses and grad norms within
    ``BST_M1_RTOL`` of ``make_train_step(model.loss, TCFG,
    microbatches=2)`` on one card (``mlp_w0``'s column blocks stay where
    they lie, the products after them added over the blocks); no
    ``all_gather`` byte at all; at both the lookups' bytes (``emb_*``:
    each home's users' items and features looked up where the tables' rows
    lie) exactly :func:`bst_lookup_want`'s, ``mlp_w0``'s (``mlp_*``)
    :func:`bst_mlp_want`'s. Then serve_p99, serve_bulk and
    retrieval_cand on the mesh
    (serving replicates the item table): within ``BST_MESH_TOL`` of one
    card's outputs, each repeating bitwise, p50 over ``BST_REPS`` warm
    calls. Launch counts set to 0 before and read after."""
    import math
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.cells import TCFG, bst_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.state import (make_sharded_train_step,
                                         make_train_step)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("bst")
    cfg = arch.model
    devices, how = smoke_mesh()
    reset_all_counts()
    # one card at one microbatch (the reference cell's) and at two
    one = {}
    for micro in (1, 2):
        cell = bst_cell(arch, "train_batch", "cuda")
        B = cell.meta["batch"]
        step = make_train_step(cell.model.loss, TCFG, microbatches=micro)
        state, batch = cell.args
        one_l, one_g, one_s = [], [], []
        for _ in range(BST_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            one_s.append(time.perf_counter() - t0)
            one_l.append(float(m["loss"]))
            one_g.append(float(m["grad_norm"]))
        one[micro] = (one_l, one_g, one_s, state_digests(state))
        del cell, state, batch, step
        torch.cuda.empty_cache()
    # the 2 x 2 mesh: the cell's step (one microbatch, its rows over the
    # two batch shards), then two microbatches, one a shard
    mesh = Mesh((2, 2), ("data", "model"), devices[:4])
    cell = bst_cell(arch, "train_batch", "cuda", mesh=mesh)
    check(cell.meta["microbatches"] == 1,
          f"train-sharded-bst: the cell runs {cell.meta['microbatches']} "
          f"microbatches")
    _, runs, peak1, _ = mesh_train_run(
        cell, BST_TRAIN_STEPS, None, mesh,
        StepProfiler(profile, "train-sharded-bst"))
    (l1, g1, s1, c1), = runs
    del cell, runs
    torch.cuda.empty_cache()
    rel1 = [max(abs(a / b - 1), abs(c / d - 1))
            for a, b, c, d in zip(l1, one[1][0], g1, one[1][1])]
    say(f"  train-sharded-bst: the cell's step at 1 microbatch on 2 x 2 "
        f"({how}): losses {l1}, grad norms {g1}; one card at 1 "
        f"microbatch: {one[1][0]}, {one[1][1]}; largest relative "
        f"difference per step {rel1} (bound {BST_M1_RTOL}); steps {s1} s "
        f"(one card {one[1][2]} s); peak {peak1} B; collective bytes "
        f"{c1[0]}")
    check(max(rel1) <= BST_M1_RTOL,
          f"train-sharded-bst: at 1 microbatch {l1} {g1}, one card "
          f"{one[1][0]} {one[1][1]}")
    check(c1[0].get("loss_sum") == 2 * 8,
          f"train-sharded-bst: loss_sum {c1[0].get('loss_sum')} B")
    # each home looks its half of the users up where the tables' rows lie,
    # and multiplies its rows by mlp_w0's column blocks where they lie, at
    # one microbatch and at two (one a batch shard) alike
    lookup = dict(bst_lookup_want(cfg, (2, 2), [(0, B // 2), (1, B // 2)]))
    mlp = bst_mlp_want(cfg, (2, 2), [(0, B // 2), (1, B // 2)])
    lookup.update(mlp)
    w0_bytes = 2 * cfg.mlp_dims[0] * ((cfg.seq_len + 1) * 2 * cfg.embed_dim
                                      + cfg.n_user_feats * cfg.embed_dim)
    emb1 = [{k: v for k, v in c.items() if k.startswith(("emb_", "mlp_"))}
            for c in c1]
    say(f"  train-sharded-bst: the lookups' and mlp_w0's bytes a step at 1 "
        f"microbatch {emb1}, the formulas (bst_lookup_want, bst_mlp_want) "
        f"{lookup}; mlp_w0's moves {sum(mlp.values())} B a step where the "
        f"parent gathered half of it to each home, {w0_bytes} B")
    check(all(e == lookup for e in emb1),
          f"train-sharded-bst: at 1 microbatch the lookups and mlp_w0 moved "
          f"{emb1}, the formulas {lookup}")
    check(all("all_gather" not in c for c in c1),
          f"train-sharded-bst: at 1 microbatch all_gather moved "
          f"{[c.get('all_gather') for c in c1]} B")
    one_l, one_g, one_s, one_d = one[2]
    cell = bst_cell(arch, "train_batch", "cuda", mesh=mesh)
    specs, ispecs = cell.in_shardings
    cell = cell._replace(step_fn=make_sharded_train_step(
        cell.model.loss, TCFG, mesh, specs, ispecs.item_hist,
        microbatches=2))
    state, runs, peak, held = mesh_train_run(cell, BST_TRAIN_STEPS, None,
                                             mesh)
    (ml, mg, ms, mc), = runs
    mesh_d = state_digests(state)
    del cell, state
    torch.cuda.empty_cache()
    table = cfg.n_items * cfg.embed_dim * 4
    emb = {k: v for k, v in mc[0].items() if k.startswith("emb_")}
    same = (ml == one_l) and (mg == one_g) and (mesh_d == one_d)
    rel2 = [max(abs(a / b - 1), abs(c / d - 1))
            for a, b, c, d in zip(ml, one_l, mg, one_g)]
    for i, (loss, gn, dt) in enumerate(zip(ml, mg, ms)):
        say(f"  train-sharded-bst step {i} on 2 x 2 ({how}): loss {loss!r} "
            f"grad_norm {gn!r} step {dt:.4f} s ({B / dt:.1f} samples/s; "
            f"one card at 2 microbatches {one_s[i]:.4f} s); collective "
            f"bytes {mc[i]}")
    say(f"  train-sharded-bst: emb_* bytes per step {emb} "
        f"({sum(emb.values())} B) against {table} B that gathering the "
        f"item table whole would move to each of 2 homes; bytes each "
        f"position stores {held}; peak {peak} B; losses' and grad norms' "
        f"largest relative difference per step from one card's at 2 "
        f"microbatches {rel2} (bound {BST_M1_RTOL}; bitwise, with the "
        f"{len(one_d)} leaf digests: {same})")
    check(all(map(math.isfinite, ml + mg)), f"train-sharded-bst: {ml} {mg}")
    check(max(rel2) <= BST_M1_RTOL,
          f"train-sharded-bst: at 2 microbatches the mesh gave losses {ml} "
          f"grad norms {mg}, one card {one_l} {one_g}")
    check(all("all_gather" not in c for c in mc),
          f"train-sharded-bst: all_gather moved "
          f"{[c.get('all_gather') for c in mc]} B")
    emb2 = [{k: v for k, v in c.items() if k.startswith(("emb_", "mlp_"))}
            for c in mc]
    check(all(e == lookup for e in emb2),
          f"train-sharded-bst: at 2 microbatches the lookups and mlp_w0 "
          f"moved {emb2}, the formulas {lookup}")
    out = dict(batch=B, losses=ml, grad_norm=mg, step_s=ms, one_card_s=one_s,
               bitwise=same, rel=rel2, mlp_bytes=mlp,
               parent_mlp_w0_gather=w0_bytes, emb_bytes=emb,
               table_bytes=table,
               collective_bytes=mc[0], position_bytes=held, peak_bytes=peak,
               one_microbatch=dict(losses=l1, grad_norm=g1, step_s=s1,
                                   one_card_s=one[1][2], rel=rel1,
                                   collective_bytes=c1[0], peak_bytes=peak1))
    # serving on the mesh against one card
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        ys = {}
        for where in ("card", "mesh"):
            mesh = (Mesh((2, 2), ("data", "model"), devices[:4])
                    if where == "mesh" else None)
            cell = bst_cell(arch, shape, "cuda", mesh=mesh)
            got = {}

            def call():
                with torch.no_grad():
                    got["y"] = cell.step_fn(*cell.args)

            call()
            first = got["y"].clone()
            moved = dict(mesh.bytes) if mesh is not None else {}
            secs = timed_calls(call, BST_REPS)
            ys[where] = (first, got.pop("y"), ms_stats(secs), moved)
            del cell
            torch.cuda.empty_cache()
        (a, a2, sa, _), (b, b2, sb, cb) = ys["card"], ys["mesh"]
        err = float((a - b).abs().max())
        top = float(a.abs().max())
        repeat = torch.equal(b, b2) and torch.equal(a, a2)
        say(f"  train-sharded-bst {shape} on 2 x 2: p50 {sb['p50']:.4f} ms "
            f"(one card {sa['p50']:.4f} ms); largest difference from one "
            f"card {err:.3e} of largest |value| {top:.4e} "
            f"({err / (BST_MESH_TOL * top):.3f} of the bound); repeats "
            f"bitwise: {repeat}; collective bytes of one call {cb}")
        check(err <= BST_MESH_TOL * top,
              f"train-sharded-bst {shape}: the mesh differs by {err:.3e}")
        check(repeat, f"train-sharded-bst {shape}: a call did not repeat")
        out[shape] = dict(p50_ms=sb["p50"], one_card_p50_ms=sa["p50"],
                          max_abs=err, repeat_bitwise=repeat)
    counts = read_all_counts()
    check_no_launches(counts, "train-sharded-bst")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase train-sharded-bst: {out['phase_s']:.1f} s wall; launches "
        f"{counts}")
    return out


# -- phase 18: LM serving on the device mesh ------------------------------------

def logits_diff(got, want) -> dict:
    import torch
    a, b = got.float(), want.float()
    return dict(max_abs=float((a - b).abs().max()),
                max_logit=float(b.abs().max()),
                rel=float((a - b).abs().max() / b.abs().max()),
                corr=float(torch.corrcoef(torch.stack([a.ravel(),
                                                       b.ravel()]))[0, 1]),
                same_argmax=int((a.argmax(-1) == b.argmax(-1)).sum()))


def lm_roofline(cfg, kind: str, batch: int, seq: int) -> dict:
    """``lm_model_flops`` / ``lm_memory_bytes`` of one prefill or decode
    step at the run's batch, length and depth over the H100's rates."""
    from repro_torch.launch import roofline as RF
    flops = RF.lm_model_flops(cfg, kind, batch, seq)
    nbytes = RF.lm_memory_bytes(cfg, kind, batch, seq)
    terms = RF.roofline_terms(flops, nbytes, 0.0)
    return dict(model_flops=flops, memory_bytes=nbytes,
                roofline_s=terms["roofline_s"], dominant=terms["dominant"])


class RouteSpy:
    """Wrap ``models.moe.routing`` (the one-card ``route`` and the mesh's
    per-home MoE block both call it) to keep each call's top-k expert ids
    ((tokens, k), on the card) while ``armed``, in call order."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self._routing = moe, moe.routing
        self.calls = []
        self.armed = False

    def __enter__(self):
        spy, routing = self, self._routing

        def spy_routing(*args, **kw):
            r = routing(*args, **kw)
            if spy.armed:
                spy.calls.append(r.expert_idx.reshape(-1, r.expert_idx
                                                      .shape[-1]).clone())
            return r

        self.moe.routing = spy_routing
        return self

    def __exit__(self, *exc):
        self.moe.routing = self._routing
        return False


def routing_flips(plain_calls, mesh_calls, n_layers: int, per_layer: int,
                  picks, n_steps: int) -> list:
    """Per MoE layer, the tokens of the decode steps whose top-k expert
    set differs between the one-card run (one routing call per layer and
    step) and the mesh run (``per_layer`` calls per layer and step, one
    per position that routes, in order; ``picks`` the calls of the batch
    shards' first positions, whose rows are concatenated in batch
    order)."""
    import torch
    check(len(plain_calls) == n_layers * n_steps
          and len(mesh_calls) == per_layer * n_layers * n_steps,
          f"routing calls: {len(plain_calls)} one card, {len(mesh_calls)} "
          f"on the mesh for {n_steps} steps of {n_layers} layers")
    flips = [0] * n_layers
    for s in range(n_steps):
        for i in range(n_layers):
            base = (s * n_layers + i) * per_layer
            want = plain_calls[s * n_layers + i].sort(-1).values
            got = torch.cat([mesh_calls[base + k] for k in picks]) \
                .sort(-1).values
            flips[i] += int((got != want).any(-1).sum())
    return flips


def unsharded_serve(model, params, prompt, n_tokens: int, spy=None):
    """Prefill ``prompt``, then greedy decode: per step the logits (the
    prefill's first), the tokens, and the wall times."""
    import torch
    import torch.nn.functional as F
    B, S = prompt.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, (ks, vs) = model.prefill(params, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        ks = F.pad(ks, (0, 0, 0, 0, 0, n_tokens))
        vs = F.pad(vs, (0, 0, 0, 0, 0, n_tokens))
        logits = [lg[:, -1:]]
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        toks = [tok]
        if spy is not None:
            spy.armed = True
        t0 = time.perf_counter()
        for i in range(n_tokens - 1):
            lg, _ = model.decode_step(params, tok, (ks, vs), S + i)
            logits.append(lg)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if spy is not None:
            spy.armed = False
    return dict(logits=logits, tokens=toks, prefill_s=prefill_s,
                decode_s=decode_s)


def sharded_serve(model, cfg, params, prompt, n_tokens: int, mesh,
                  bspec, want_tokens, capture=None, spy=None, placed=None,
                  prof=None):
    """Prefill on ``mesh`` (cache placed by ``lm_cache_specs``), then decode
    under ``tp2d`` (``distrib/serving.py``: the weights where they lie with
    the batch whole, the reference's split with it split over
    ``bspec``), teacher-forced with ``want_tokens`` (the unsharded run's):
    per step the logits, the tokens the run would have picked, wall
    times, bytes per collective (the prefill's, in all and of the first
    decode step, with the bytes each position received and by axis), the
    launches. The prefill runs under ``fsdp`` over ``params`` placed
    for it, or, given ``placed`` (``params`` placed by the ``tp2d``
    rules), under ``tp2d`` over those. ``capture`` (:class:`KernelCapture`) is
    armed over prefill and decode, ``spy`` (:class:`RouteSpy`) over
    decode; ``prof`` (:class:`StepProfiler`) records decode step 1."""
    import torch
    from repro_torch.distrib.serving import (make_sharded_decode,
                                             make_sharded_prefill,
                                             place_params)
    from repro_torch.distrib.sharding import lm_cache_specs, lm_param_specs
    B, S = prompt.shape
    out = {}
    policy = "fsdp" if placed is None else "tp2d"
    pre = (place_params(params, mesh, lm_param_specs(params, cfg, "fsdp"))
           if placed is None else placed)
    prefill = make_sharded_prefill(model, mesh, bspec,
                                   lm_cache_specs(False, B),
                                   capacity=S + n_tokens, policy=policy)
    torch.cuda.synchronize()
    mesh.reset_bytes()
    reset_all_counts()
    if capture is not None:
        capture.armed = True
    t0 = time.perf_counter()
    lg, cache = prefill(pre, prompt)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_bytes"] = dict(mesh.bytes)
    out["prefill_axes"] = moves_by_axis(mesh)
    out["prefill_lookup"] = lookup_by_axis(mesh)
    del pre
    torch.cuda.empty_cache()
    if placed is None:
        placed = place_params(params, mesh, lm_param_specs(params, cfg))
    decode = make_sharded_decode(model, mesh, bspec)
    logits, picked = [lg[:, -1:]], [torch.argmax(lg[:, -1:], dim=-1)]
    torch.cuda.synchronize()
    mesh.reset_bytes()
    if spy is not None:
        spy.armed = True
    t0 = time.perf_counter()
    for i in range(n_tokens - 1):
        step = (lambda: decode(placed, want_tokens[i], cache, S + i))
        lg, cache = step() if prof is None else prof.step(i, step)
        if i == 0:
            out["step_bytes"] = dict(mesh.bytes)
            out["step_axes"] = moves_by_axis(mesh)
            out["step_lookup"] = lookup_by_axis(mesh)
            out["step_received"] = [mesh.received.get(p, 0)
                                    for p in range(mesh.size)]
        logits.append(lg)
        picked.append(torch.argmax(lg, dim=-1))
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    for c in (capture, spy):
        if c is not None:
            c.armed = False
    out["decode_bytes"] = dict(mesh.bytes)
    out["launches"] = read_all_counts()
    out["logits"], out["picked"] = logits, picked
    out["cache_spec"] = repr(cache[0].spec)
    out["lookup_bytes"] = lookup_bytes(
        placed["embed"], mesh, bspec, B,
        torch.empty((), dtype=model.compute_dtype).element_size())
    del placed, cache
    torch.cuda.empty_cache()
    return out


# a tp2d decode step with the batch whole moves activations, the looked-up
# rows, the KV cache's new entries and the logits; a parameter never
TP_ACTIVATIONS = {"tp_act", "tp_partial", "emb_rows_model", "emb_rows_home",
                  "expert_send", "kv_write", "q_send", "attn_partial",
                  "logits_gather"}
# with the batch split: weights along "data", sums along "model"
TP_WEIGHT_MOVES, TP_SUM_MOVES = {"tp_zero_gather"}, {"tp_model_sum"}


def moves_by_axis(mesh) -> dict:
    """The mesh's bytes since its last reset by ``"name axis"``: each
    move's source and receiver along "data" (one "model" coordinate),
    "model" (one "data" coordinate) or "both" (the moves that name both
    ends)."""
    out = {}
    for (name, frm, to), n in mesh.moves.items():
        a, b = mesh.coords(frm), mesh.coords(to)
        ax = ("data" if a["model"] == b["model"] else
              "model" if a["data"] == b["data"] else "both")
        out[f"{name} {ax}"] = out.get(f"{name} {ax}", 0) + n
    return dict(sorted(out.items()))


def lookup_by_axis(mesh) -> dict:
    """The lookup's bytes (the ``emb_*`` collectives) since the mesh's last
    reset by ``"name axis"``: the mesh axes its source and receiver differ
    on, joined by "+" (the moves that name both ends)."""
    out = {}
    for (name, frm, to), n in mesh.moves.items():
        if name.startswith("emb_"):
            a, b = mesh.coords(frm), mesh.coords(to)
            ax = "+".join(x for x in mesh.axis_names if a[x] != b[x])
            out[f"{name} {ax}"] = out.get(f"{name} {ax}", 0) + n
    return dict(sorted(out.items()))


def lookup_bytes(embed, mesh, bspec, B: int, c: int) -> dict:
    """``emb_rows_model`` and ``emb_rows_home`` of one decode step's lookup
    of B tokens in the placed (V, d) table with the batch whole, the rows
    in a ``c``-byte dtype: every position looks the batch up in its block,
    and each "model" line of K vocab blocks reduce-scatters and
    all-gathers the partial rows (2(K − 1) positions' worth in all); each
    home takes its rows of each column block it does not hold from its
    "data" line (worked out here from the mesh's coordinates, not by the
    port)."""
    from repro_torch.distrib.collectives import batch_groups
    homes, _ = batch_groups(mesh, bspec[0])
    lay = embed.layout
    e = lay.block_shape[1]

    def line(p, axis):
        c0 = mesh.coords(p)
        return [q for q in range(mesh.size)
                if all(mesh.coords(q)[a] == c0[a] for a in mesh.axis_names
                       if a != axis)]
    lines = {tuple(line(p, "model")) for p in range(mesh.size)}
    model = sum(2 * (len({lay.block_of(q)[0] for q in ln}) - 1)
                for ln in lines) * B * e * c
    home = sum(len({lay.block_of(q)[1] for q in line(h, "data")}) - 1
               for h in homes) * (B // len(homes)) * e * c
    return {k: v for k, v in (("emb_rows_model", model),
                              ("emb_rows_home", home)) if v}


def sharded_lm_launches(cfg, mesh, n_tok: int, wide: bool,
                        policy: str) -> dict:
    """The kernel launches of one serve-sharded-lm run (the decode
    attention is split over the cache slices in plain torch). A prefill
    under ``fsdp`` runs flash once per layer and batch shard at its home,
    and the expert GEMM's three products on the tiles variant per layer
    and batch shard: on the experts gathered at the home, or, with the
    batch split and ``moe_shard="expert"``, per expert shard where they
    live. A prefill under ``tp2d`` with the batch split attends at every
    position over its heads and runs its "model" block of the experts
    (its E / M, or all of them on its d_ff / M columns): three tiles
    products per layer and position. A decode step runs three skinny
    products (C 8) per layer: per expert shard where they live with the
    batch whole, per position with it split."""
    D = mesh.axis_size("data") if wide else 1
    M = mesh.axis_size("model")
    L = cfg.n_layers
    pre = L * mesh.size if wide and policy == "tp2d" else L * D
    want = {"flash_attention_fwd_wgmma": pre}
    if cfg.moe is not None:
        kept = wide and policy == "fsdp" and cfg.moe.moe_shard == "expert"
        want["expert_gemm_wgmma"] = 3 * pre * (M if kept else 1)
        want["expert_gemm_skinny"] = 3 * (L * mesh.size if wide else L * M) \
            * (n_tok - 1)
    return want


def phase_serve_sharded_lm(profile: bool = False):
    """serve-lm's model on a 2 × 2 ("data", "model") mesh (the first four
    cards, or ``cuda:0`` four times), the KV cache placed by
    ``lm_cache_specs`` (``distrib/serving.py``). qwen3-moe-30b-a3b at its
    published widths, serve-lm's 8 of 48 layers and seeded bf16 weights:
    (i) serve-lm's 2 × 4,096 prompt and 16 tokens, the batch whole, the
    cache split along the sequence over all four positions, prefill under
    the reference prefill cell's ``fsdp`` rules, decode under ``tp2d``
    with every product on its weight blocks' holders and the experts where
    they live; (ii) 16 × 2,048 and 8 tokens: the batch split over "data",
    the cache's sequence over "model", prefill under ``fsdp`` (each batch
    shard's home gathering each layer from its group, the experts where
    they live), decode under ``tp2d`` as the reference's partitioner
    splits it (the column weights' "model" blocks gathered along "data",
    the rows moved to the row blocks and the head, the sums over "model").
    (iii) deepseek-7b at its published widths, all 30 layers: 16 × 1,024
    and 8 tokens, prefill and decode under ``tp2d`` split as in (ii)'s
    decode (its one-card run goes first and its caches are freed before
    the mesh is placed). (iv) qwen3-moe as (ii) with ``moe_shard="ffn"``,
    the prefill as (iii)'s. Each against the
    unsharded model on one card: prefill logits bitwise in (i), within
    serve-lm's bf16 consistency bounds in (ii)–(iv); decode teacher-forced
    with the unsharded run's tokens, within those bounds at every step;
    the greedy tokens that agree printed; two runs on the mesh bitwise
    equal. The prefill's and one decode step's bytes per collective, by
    axis and per receiving position are printed: in (i) no parameter
    moves (no ``all_gather``; the lookup's rows only); in
    (ii)–(iv) they equal :func:`serve_tp2d_bytes_want` by name (the
    ``fsdp`` prefill of (ii) :func:`serve_fsdp_bytes_want`), the weights
    move along "data" only and the sums along "model" only. The
    launches must be :func:`sharded_lm_launches`' exactly, and the inputs
    each kernel takes in the second mesh run (each at each shape) are held
    against the plain versions (:func:`hold_captured`; timed in
    (ii)–(iv)). For qwen3-moe the decode tokens whose top-8 experts differ
    from the one-card run's are counted per layer. With ``profile``, the
    first mesh run's decode step 1 is profiled."""
    import dataclasses
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.distrib.collectives import batch_groups
    from repro_torch.distrib.serving import place_params
    from repro_torch.distrib.sharding import P, lm_param_specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import TransformerLM
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(4)] if n_cards >= 4
               else ["cuda:0"] * 4)
    mesh = Mesh((2, 2), ("data", "model"), devices)
    total = {}
    res = {"mesh": str(mesh)}
    qwen = dataclasses.replace(FULL, n_layers=LM_LAYERS)
    ffn = dataclasses.replace(qwen, moe=dataclasses.replace(
        qwen.moe, moe_shard="ffn"))
    cases = (("i", "qwen3-moe-30b-a3b", qwen, LM_BATCH, LM_PROMPT,
              LM_TOKENS, "fsdp"),
             ("ii", "qwen3-moe-30b-a3b", qwen, SHARD_SERVE_BATCH,
              SHARD_SERVE_PROMPT, SHARD_SERVE_TOKENS, "fsdp"),
             ("iv", "qwen3-moe-30b-a3b", ffn, SHARD_SERVE_BATCH,
              SHARD_SERVE_PROMPT, SHARD_SERVE_TOKENS, "tp2d"),
             ("iii", "deepseek-7b", get_arch("deepseek-7b").model,
              TP_SERVE_BATCH, TP_SERVE_PROMPT, TP_SERVE_TOKENS, "tp2d"))
    params = params_cfg = None
    for tag, arch, cfg, B, S, n_tok, policy in cases:
        if params is None or params_cfg is not cfg:
            del params
            torch.cuda.empty_cache()
            params = TransformerLM(cfg).init(
                torch.Generator(device="cuda").manual_seed(0))
            params_cfg = cfg
        wide = B >= 16
        moe = cfg.moe is not None
        group = min(4096, max(64, B * S // 8))
        plain = TransformerLM(cfg, moe_group_size=group)
        model = TransformerLM(cfg, moe_group_size=group,
                              act_spec=P("data", None, None) if wide
                              else None)
        bspec = P("data", None) if wide else P(None, None)
        prompt = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator(device="cuda")
                               .manual_seed(1), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        with RouteSpy() as plain_routes:
            want = unsharded_serve(plain, params, prompt, n_tok,
                                   spy=plain_routes)
        torch.cuda.empty_cache()
        placed = None
        if policy == "tp2d":
            placed = place_params(params, mesh, lm_param_specs(params, cfg))
            del params
            params = None
            torch.cuda.empty_cache()
        prof = CollectiveProfiler(f"serve-sharded-lm ({tag}) decode",
                                  profile)
        a = sharded_serve(model, cfg, params, prompt, n_tok, mesh, bspec,
                          want["tokens"], placed=placed, prof=prof)
        # the second run also keeps the kernels' inputs and the routing
        with KernelCapture("serve") as cap, RouteSpy() as mesh_routes:
            b = sharded_serve(model, cfg, params, prompt, n_tok, mesh, bspec,
                              want["tokens"], capture=cap, spy=mesh_routes,
                              placed=placed)
        del placed
        peak = torch.cuda.max_memory_allocated()
        flips = None
        if moe:
            # with the batch split every position routes its group's rows
            # (the whole batch at a decode step whose group spans the
            # batch shards); the first position of each group's first
            # batch shard is read
            homes, _ = batch_groups(mesh, bspec[0])
            span = model.moe_span(B, 1, len(homes)) if wide else 1
            flips = routing_flips(plain_routes.calls, mesh_routes.calls,
                                  cfg.n_layers,
                                  mesh.size if wide else len(homes),
                                  homes[::span] if wide
                                  else range(len(homes)), n_tok - 1)
        del plain_routes, mesh_routes
        held = hold_captured(cap.inputs, f"serve-sharded-lm ({tag})",
                             timed=wide)
        del cap
        torch.cuda.empty_cache()
        repeat = all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                       b["logits"]))
        diffs = [logits_diff(g, w) for g, w in zip(a["logits"],
                                                    want["logits"])]
        agree = sum(int(torch.equal(p.to(t.dtype), t))
                    for p, t in zip(a["picked"], want["tokens"]))
        launches = {k: v for k, v in a["launches"].items() if v}
        for k, v in a["launches"].items():
            total[k] = total.get(k, 0) + v + b["launches"][k]
        want_launches = sharded_lm_launches(cfg, mesh, n_tok, wide, policy)
        want_bytes = None
        if wide:
            want_bytes = {"decode": serve_tp2d_bytes_want(
                cfg, mesh.shape, B, S, "decode", group, S + n_tok,
                want["tokens"][0].element_size())}
            want_bytes["prefill"] = (
                serve_tp2d_bytes_want(cfg, mesh.shape, B, S, "prefill",
                                      group, S + n_tok,
                                      prompt.element_size())
                if policy == "tp2d" else
                serve_fsdp_bytes_want(cfg, mesh.shape, B, S, group,
                                      S + n_tok, prompt.element_size()))
        pre = lm_roofline(cfg, "prefill", B, S)
        dec = lm_roofline(cfg, "decode", B, S + n_tok // 2)
        dec_step = a["decode_s"] / (n_tok - 1)
        step = a["step_bytes"]
        say(f"  serve-sharded-lm ({tag}) {arch} {cfg.n_layers} layers, d "
            f"{cfg.d_model}, {B} x {S}, {n_tok} "
            f"tokens on {mesh}, batch {bspec!r}, prefill {policy}, cache "
            f"{a['cache_spec']}: prefill {a['prefill_s']:.3f} s (again "
            f"{b['prefill_s']:.3f}; one card {want['prefill_s']:.3f} s), "
            f"decode {dec_step * 1e3:.2f} ms/step (again "
            f"{b['decode_s'] / (n_tok - 1) * 1e3:.2f}; one card "
            f"{want['decode_s'] / (n_tok - 1) * 1e3:.2f}); peak {peak} B")
        say(f"  serve-sharded-lm ({tag}) bytes: prefill "
            f"{a['prefill_bytes']}; decode ({n_tok - 1} steps) "
            f"{a['decode_bytes']}; one decode step {step} = "
            f"{sum(step.values())} B, received per position "
            f"{a['step_received']}; launches {launches}")
        say(f"  serve-sharded-lm ({tag}) the lookup's bytes by name and "
            f"axis: prefill {a['prefill_lookup']}; one decode step "
            f"{a['step_lookup']}")
        if wide and policy == "fsdp":
            parent = serve_fsdp_bytes_want(cfg, mesh.shape, B, S, group,
                                           S + n_tok, prompt.element_size(),
                                           act_spec=False)
            head = {k: v for k, v in a["prefill_bytes"].items()
                    if k.startswith("head_")}
            say(f"  serve-sharded-lm ({tag}) the prefill's head where its "
                f"blocks lie: {head}, logits_gather "
                f"{a['prefill_bytes'].get('logits_gather')} B; all_gather "
                f"{a['prefill_bytes'].get('all_gather')} B where the "
                f"parent, gathering the head at each home, moved "
                f"{parent.get('all_gather')} B")
        say(f"  serve-sharded-lm ({tag}) bytes by name and axis (the moves "
            f"that name both ends): prefill {a['prefill_axes']}; one decode "
            f"step {a['step_axes']}"
            + (f"; formula (serve_{policy}_bytes_want): prefill "
               f"{want_bytes['prefill']}, decode step (serve_tp2d_bytes_"
               f"want) {want_bytes['decode']}" if wide else ""))
        say(f"  serve-sharded-lm ({tag}) against one card: prefill logits "
            f"bitwise {torch.equal(a['logits'][0], want['logits'][0])}, "
            f"max |diff| per step {[round(d['max_abs'], 6) for d in diffs]}"
            f" (largest relative {max(d['rel'] for d in diffs):.3e}, "
            f"least correlation {min(d['corr'] for d in diffs):.6f}; bounds "
            f"{LM_CONSIST_ATOL}, {LM_CONSIST_CORR}); greedy tokens agreeing "
            f"{agree} of {n_tok} steps; two mesh runs bitwise {repeat}")
        if moe:
            say(f"  serve-sharded-lm ({tag}) routing: decode tokens whose "
                f"top-{cfg.moe.top_k} experts differ from one card's, per "
                f"MoE layer {flips} of {B * (n_tok - 1)} each")
        say(f"  serve-sharded-lm ({tag}) kernels held at the run's shapes: "
            f"{len(held)}; roofline (H100 data sheet): prefill "
            f"{pre['model_flops']:.4e} flop, {pre['memory_bytes']:.4e} B, "
            f"{pre['roofline_s'] * 1e3:.3f} ms ({pre['dominant']}), "
            f"measured share {pre['roofline_s'] / a['prefill_s']:.4f}; "
            f"decode step {dec['model_flops']:.4e} flop, "
            f"{dec['memory_bytes']:.4e} B, {dec['roofline_s'] * 1e3:.4f} ms"
            f" ({dec['dominant']}), measured share "
            f"{dec['roofline_s'] / dec_step:.4f}")
        if tag == "i":
            check(torch.equal(a["logits"][0], want["logits"][0]),
                  "serve-sharded-lm (i): prefill logits differ from one "
                  "card's")
        check(all(d["max_abs"] <= LM_CONSIST_ATOL
                  and d["corr"] >= LM_CONSIST_CORR for d in diffs),
              f"serve-sharded-lm ({tag}): logits {diffs} beyond "
              f"{LM_CONSIST_ATOL} / {LM_CONSIST_CORR}")
        check(repeat, f"serve-sharded-lm ({tag}): two runs on the mesh "
                      f"differ")
        check(all(bool(torch.isfinite(x.float()).all()) for x in a["logits"]),
              f"serve-sharded-lm ({tag}): non-finite logits")
        if wide:
            check(a["prefill_bytes"] == want_bytes["prefill"]
                  and step == want_bytes["decode"],
                  f"serve-sharded-lm ({tag}): bytes {a['prefill_bytes']}, "
                  f"{step}, expected {want_bytes}")
            for axes in (a["prefill_axes"], a["step_axes"]):
                check(all(k.endswith(" data") for k in axes
                          if k.split()[0] in TP_WEIGHT_MOVES)
                      and all(k.endswith(" model") for k in axes
                              if k.split()[0] in TP_SUM_MOVES),
                      f"serve-sharded-lm ({tag}): weights off \"data\" or "
                      f"sums off \"model\": {axes}")
        else:
            check(set(step) <= TP_ACTIVATIONS
                  and step.get("tp_act", 0) > 0,
                  f"serve-sharded-lm ({tag}): a decode step moved {step}, "
                  f"not activations only")
            got = {k: v for k, v in step.items() if k.startswith("emb_")}
            check(got == a["lookup_bytes"],
                  f"serve-sharded-lm ({tag}): the lookup moved {got}, not "
                  f"the batch's rows {a['lookup_bytes']}")
        for run in (a, b):
            got = {k: v for k, v in run["launches"].items() if v}
            check(got == want_launches,
                  f"serve-sharded-lm ({tag}): launches {got}, expected "
                  f"{want_launches}")
        for k in want_launches:
            check(any(h["kernel"] == k for h in held),
                  f"serve-sharded-lm ({tag}): no input of {k} captured")
        res[tag] = dict(arch=arch, layers=cfg.n_layers,
                        batch=B, prompt=S, tokens=n_tok,
                        prefill_policy=policy,
                        prefill_s=a["prefill_s"],
                        prefill_s_again=b["prefill_s"],
                        one_card_prefill_s=want["prefill_s"],
                        decode_ms_per_step=dec_step * 1e3,
                        decode_ms_per_step_again=b["decode_s"]
                        / (n_tok - 1) * 1e3,
                        one_card_decode_ms_per_step=want["decode_s"]
                        / (n_tok - 1) * 1e3,
                        prefill_bytes=a["prefill_bytes"],
                        prefill_bytes_by_axis=a["prefill_axes"],
                        decode_step_bytes_by_axis=a["step_axes"],
                        decode_bytes=a["decode_bytes"],
                        decode_step_bytes=step,
                        decode_step_received=a["step_received"],
                        launches=launches,
                        max_abs=max(d["max_abs"] for d in diffs),
                        max_rel=max(d["rel"] for d in diffs),
                        min_corr=min(d["corr"] for d in diffs),
                        tokens_agree=agree, repeat_bitwise=repeat,
                        routing_flips_per_layer=flips, kernels_held=held,
                        peak_bytes=peak, roofline_prefill=pre,
                        roofline_decode_step=dec,
                        decode_profile=prof.record or None)
        del want, a, b
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    res["v"] = serve_sharded_fault6(mesh)
    res["vi"] = serve_sharded_fault7(mesh, total)
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"phase serve-sharded-lm: {res['phase_s']:.1f} s wall")
    return total, res


def serve_sharded_fault6(mesh) -> dict:
    """serve-sharded-lm (v) (the module docstring): fault 6's input on the
    mesh against one card."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.qwen3_moe_30b_a3b import SMOKE
    from repro_torch.distrib.serving import (make_sharded_decode,
                                             make_sharded_prefill,
                                             place_params)
    from repro_torch.distrib.sharding import P, lm_param_specs
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(SMOKE, moe=dataclasses.replace(
        SMOKE.moe, n_experts=16))
    B = S = group = 16
    plain = TransformerLM(cfg, moe_group_size=group)
    params = plain.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                           device="cuda", dtype=torch.int32).expand(B, S)
    token = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                          device="cuda", dtype=torch.int32).expand(B, 1)
    model = TransformerLM(cfg, moe_group_size=group,
                          act_spec=P("data", None, None))
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "tp2d"))
    prefill = make_sharded_prefill(model, mesh, P("data", None),
                                   P(None, "data", "model", None, None),
                                   capacity=S + 4, policy="tp2d")
    decode = make_sharded_decode(model, mesh, P("data", None))
    with torch.no_grad():
        lg1, (ks, vs) = plain.prefill(params, tokens)
        ks, vs = (F.pad(c, (0, 0, 0, 0, 0, 4)) for c in (ks, vs))
        dlg1, _ = plain.decode_step(params, token, (ks, vs), S)
    lg, cache = prefill(placed, tokens)
    mesh.reset_bytes()
    dlg, _ = decode(placed, token, cache, S)
    step = dict(mesh.bytes)
    say(f"  serve-sharded-lm (v) the lookup's bytes by name and axis: "
        f"decode step {lookup_by_axis(mesh)}")
    want = serve_tp2d_bytes_want(cfg, mesh.shape, B, S, "decode", group,
                                 S + 4, token.element_size())
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in ((lg, lg1), (dlg, dlg1))]
    second = float((dlg[B // 2:] - dlg1[B // 2:]).abs().max())
    say(f"  serve-sharded-lm (v) fault 6, qwen3-moe SMOKE 16 experts f32, "
        f"{B} x {S}, every row row 0's, moe_group_size {group}: prefill and "
        f"decode logits within {errs[0]:.3e} / {errs[1]:.3e} of one card's "
        f"largest (bound 1e-5; the second batch shard's rows {second:.3e});"
        f" decode step bytes {step}")
    check(max(errs) <= 1e-5, f"serve-sharded-lm (v): logits {errs} off "
                             f"one card's")
    check(step == want and step.get("moe_group_dispatch", 0) > 0,
          f"serve-sharded-lm (v): bytes {step}, expected {want}")
    return dict(rel_err=errs, second_shard_max_abs=second, step_bytes=step)


def serve_sharded_fault7(mesh, total: dict) -> dict:
    """serve-sharded-lm (vi) (the module docstring): fault 7's case, an
    ``fsdp`` prefill whose MoE group spans both batch shards, on the mesh
    against one card; its launches added to ``total``."""
    import dataclasses
    import torch
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.distrib.serving import make_sharded_prefill, place_params
    from repro_torch.distrib.sharding import P, lm_cache_specs, lm_param_specs
    from repro_torch.models.transformer import TransformerLM
    cfg = dataclasses.replace(FULL, n_layers=LM_LAYERS)
    B, S, group = FAULT7_BATCH, FAULT7_PROMPT, FAULT7_GROUP
    plain = TransformerLM(cfg, moe_group_size=group)
    params = plain.init(torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), device="cuda")
    model = TransformerLM(cfg, moe_group_size=group,
                          act_spec=P("data", None, None))
    span = model.moe_span(B, S, mesh.axis_size("data"))
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = plain.prefill(params, prompt)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "fsdp"))
    del params
    torch.cuda.empty_cache()
    prefill = make_sharded_prefill(model, mesh, P("data", None),
                                   lm_cache_specs(False, B), capacity=S)
    mesh.reset_bytes()
    reset_all_counts()
    with KernelCapture("serve") as cap:
        cap.armed = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(placed, prompt)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        cap.armed = False
    launches = {k: v for k, v in read_all_counts().items() if v}
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    got_bytes = dict(mesh.bytes)
    say(f"  serve-sharded-lm (vi) the lookup's bytes by name and axis "
        f"(the run's tokens at its home, looked up where the table's rows "
        f"lie): prefill {lookup_by_axis(mesh)}")
    del cache, placed
    torch.cuda.empty_cache()
    bytes_want = serve_fsdp_bytes_want(cfg, mesh.shape, B, S, group, S,
                                       prompt.element_size())
    parent = serve_fsdp_bytes_want(cfg, mesh.shape, B, S, group, S,
                                   prompt.element_size(), act_spec=False)
    say(f"  serve-sharded-lm (vi) the head where its blocks lie: "
        f"{ {k: v for k, v in got_bytes.items() if k.startswith('head_')} }"
        f"; all_gather {got_bytes.get('all_gather')} B and prefill_span "
        f"{got_bytes.get('prefill_span')} B where the parent moved "
        f"{parent.get('all_gather')} B and {parent.get('prefill_span')} B")
    # one run of both batch shards at the first home: flash once a layer,
    # the experts' three products at each of the 2 expert shards
    M = mesh.axis_size("model")
    launch_want = {"flash_attention_fwd_wgmma": cfg.n_layers,
                   "expert_gemm_wgmma": 3 * cfg.n_layers * M}
    held = hold_captured(cap.inputs, "serve-sharded-lm (vi)", timed=True)
    diff = logits_diff(lg[:, -1:], want[:, -1:])
    bitwise = torch.equal(lg, want)
    say(f"  serve-sharded-lm (vi) fault 7, qwen3-moe-30b-a3b "
        f"{cfg.n_layers} layers, {B} x {S}, moe_group_size {group} (a "
        f"group spans {span} batch shards of {B // 2} x {S}), prefill fsdp "
        f"on {mesh}: {mesh_s:.3f} s (one card {one_s:.3f} s); logits "
        f"against one card's bitwise {bitwise}, max |diff| "
        f"{diff['max_abs']:.6f}, correlation {diff['corr']:.6f} (bounds "
        f"{LM_CONSIST_ATOL}, {LM_CONSIST_CORR}); bytes {got_bytes}, formula "
        f"(serve_fsdp_bytes_want) {bytes_want}; launches {launches}, "
        f"expected {launch_want}; kernels held {len(held)}")
    check(span == 2, f"serve-sharded-lm (vi): a group spans {span} shards")
    check(diff["max_abs"] <= LM_CONSIST_ATOL
          and diff["corr"] >= LM_CONSIST_CORR
          and bool(torch.isfinite(lg.float()).all()),
          f"serve-sharded-lm (vi): logits {diff} off one card's")
    check(got_bytes == bytes_want and got_bytes.get("prefill_span", 0) > 0,
          f"serve-sharded-lm (vi): bytes {got_bytes}, expected {bytes_want}")
    check(launches == launch_want,
          f"serve-sharded-lm (vi): launches {launches}, expected "
          f"{launch_want}")
    for k in ("flash_attention_fwd_wgmma", "expert_gemm_wgmma"):
        check(any(h["kernel"] == k for h in held),
              f"serve-sharded-lm (vi): no input of {k} captured")
    return dict(span=span, prefill_s=mesh_s, one_card_prefill_s=one_s,
                bitwise=bitwise, max_abs=diff["max_abs"], corr=diff["corr"],
                bytes=got_bytes, launches=launches, kernels_held=held)


# -- phase 19: the paper's IGPM cells at Table III sizes --------------------------

def phase_igpm_cells():
    """The IGPM cell (``launch/cells.py:igpm_cell``) at each Table III
    shape's published size: the label-RWR refresh (5 sweeps, L 4) on one
    card through an ELL mirror and ``ell_spmm``, the arc-sharded refresh
    on the 2 × 2 mesh (two arc blocks over "data", one mirror each), and
    the plain COO refresh on the CPU. Card ≡ CPU and mesh ≡ one card
    within ``IGPM_RWR_TOL`` of the table's largest entry, two card runs
    bitwise equal; ELL build s, refresh times, launches, the mesh's bytes,
    the refresh's bound and gather floor from the mirror's slots, and the
    reference's analytic roofline printed."""
    import torch
    from repro_torch.config.registry import get_arch
    from repro_torch.launch import roofline as RF
    from repro_torch.kernels.measure import gather_floor
    from repro_torch.launch.cells import IgpmRefresh, build_cell
    from repro_torch.launch.mesh import Mesh
    t_phase = time.perf_counter()
    arch = get_arch("igpm-pem")
    devices, _ = smoke_mesh()
    mesh = Mesh((2, 2), ("data", "model"), devices[:4] if len(devices) >= 4
                else ["cuda:0"] * 4)
    total, res = {}, {}
    for shape in arch.shapes:
        t0 = time.perf_counter()
        cell = build_cell(arch, shape.name, "cuda")
        g, r0 = cell.args
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        step = cell.step_fn
        t0 = time.perf_counter()
        ell = step.mirrors(g)
        torch.cuda.synchronize()
        ell_s = time.perf_counter() - t0
        # the table's rule, per sweep: the mirror, the iterate and the sum
        # once each (spmm_bound), and the live entries' gather floor
        sweep_ms, _, sweep_bytes, _ = spmm_bound(ell.mask, r0, ell.n, True)
        sweep_floor = gather_floor(ell.mask, r0.shape[1])
        slots, nnz = ell.mask.numel(), int(ell.mask.sum())
        del ell
        reset_all_counts()
        times, outs = [], []
        for _ in range(IGPM_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(step(g, r0))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = read_all_counts()
        card = outs[0]
        repeat = all(torch.equal(card, o) for o in outs[1:])
        t0 = time.perf_counter()
        cpu = IgpmRefresh(arch.model)(type(g)(*(x.cpu() for x in g)),
                                      r0.cpu())
        cpu_s = time.perf_counter() - t0
        scale = float(cpu.abs().max())
        err_cpu = float((card.cpu() - cpu).abs().max())
        del outs
        # the arc-sharded refresh on the mesh
        t0 = time.perf_counter()
        mcell = build_cell(arch, shape.name, "cuda", mesh=mesh)
        mg, mr0 = mcell.args
        mstep = mcell.step_fn
        mstep.mirrors(mg)
        torch.cuda.synchronize()
        mesh_build_s = time.perf_counter() - t0
        mesh.reset_bytes()
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_mesh = mstep(mg, mr0)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        mesh_launches = read_all_counts()
        mesh_bytes = dict(mesh.bytes)
        err_mesh = float((on_mesh - card).abs().max())
        meta = cell.meta
        flops, nbytes = RF.igpm_model_flops(meta), RF.igpm_memory_bytes(meta)
        roof = RF.roofline_terms(flops, nbytes, 0.0)
        warm = min(times[1:]) if len(times) > 1 else times[0]
        sweeps = meta["rwr_iters"]
        bound_ms, floor_ms = sweeps * sweep_ms, sweeps * sweep_floor
        say(f"  igpm-cells {shape.name}: n {meta['n_nodes']}, arcs "
            f"{meta['n_edges']} (pad512 of 2 x {shape.dims['n_edges']}), L "
            f"{meta['n_labels']}, {meta['rwr_iters']} sweeps; draw "
            f"{draw_s:.2f} s, ELL build {ell_s:.2f} s (host), refresh on "
            f"one card {[round(t * 1e3, 3) for t in times]} ms, CPU COO "
            f"{cpu_s:.3f} s; on the 2x2 mesh {mesh_s * 1e3:.3f} ms (build "
            f"and mirrors {mesh_build_s:.2f} s), bytes {mesh_bytes}")
        say(f"  igpm-cells {shape.name}: card vs CPU max |diff| {err_cpu:.3e},"
            f" mesh vs card {err_mesh:.3e} (max |r| {scale:.4e}, tolerance "
            f"{IGPM_RWR_TOL} of it); two card runs bitwise {repeat}; "
            f"launches one card {launches['ell_spmm']} ell_spmm, mesh "
            f"{mesh_launches['ell_spmm']}")
        say(f"  igpm-cells {shape.name} bound (H100 data sheet): {sweeps} "
            f"sweeps x (mirror of {slots} slots, {nnz} live, the iterate "
            f"and the sum once: {sweep_bytes} B) = {bound_ms:.4f} ms "
            f"(bytes), gather floor {floor_ms:.4f} ms; measured share "
            f"{bound_ms / (warm * 1e3):.4f} of the warm refresh")
        say(f"  igpm-cells {shape.name} the reference's analytic roofline "
            f"(igpm_model_flops / igpm_memory_bytes, H100 data sheet): "
            f"{flops:.4e} flop, {nbytes:.4e} B, {roof['roofline_s'] * 1e3:.4f}"
            f" ms ({roof['dominant']}); measured share "
            f"{roof['roofline_s'] / warm:.4f} of the warm refresh")
        check(torch.isfinite(card).all() and card.shape == (meta["n_nodes"],
                                                            4),
              f"igpm-cells {shape.name}: refresh shape or values")
        check(err_cpu <= IGPM_RWR_TOL * scale,
              f"igpm-cells {shape.name}: card vs CPU {err_cpu}")
        check(err_mesh <= IGPM_RWR_TOL * scale,
              f"igpm-cells {shape.name}: mesh vs card {err_mesh}")
        check(repeat, f"igpm-cells {shape.name}: card runs differ")
        want_l = meta["rwr_iters"] * IGPM_REPS
        check(launches["ell_spmm"] == want_l
              and mesh_launches["ell_spmm"] == 2 * meta["rwr_iters"],
              f"igpm-cells {shape.name}: ell_spmm launches "
              f"{launches['ell_spmm']} / {mesh_launches['ell_spmm']}")
        for k in ("ell_spmm",):
            total[k] = total.get(k, 0) + launches[k] + mesh_launches[k]
        res[shape.name] = dict(n=meta["n_nodes"], arcs=meta["n_edges"],
                               draw_s=draw_s, ell_build_s=ell_s,
                               refresh_ms=[t * 1e3 for t in times],
                               cpu_s=cpu_s, mesh_ms=mesh_s * 1e3,
                               mesh_build_s=mesh_build_s,
                               mesh_bytes=mesh_bytes, err_cpu=err_cpu,
                               err_mesh=err_mesh, max_r=scale,
                               slots=slots, nnz=nnz, bound_ms=bound_ms,
                               bound_share=bound_ms / (warm * 1e3),
                               gather_floor_ms=floor_ms,
                               analytic_roofline_ms=roof["roofline_s"] * 1e3,
                               analytic_roofline_share=roof["roofline_s"]
                               / warm)
        del cell, g, r0, step, mcell, mg, mr0, mstep, card, cpu, on_mesh
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"phase igpm-cells: {res['phase_s']:.1f} s wall")
    return total, res


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
    say("phase examples:")
    launches_ex, examples = phase_examples()
    say("phase igpm-cells:")
    launches_igpm, igpm_cells = phase_igpm_cells()
    say("phase serve-lm:")
    launches_lm, lm = phase_serve_lm(args.profile)
    say("phase serve-lm-configs:")
    launches_configs, lm_configs = phase_serve_lm_configs()
    say("phase serve-sharded-lm:")
    launches_ssl, serve_sharded_lm = phase_serve_sharded_lm(args.profile)
    say("phase train-lm:")
    launches_train, train = phase_train_lm(args.profile)
    say("phase train-sharded:")
    launches_sharded, train_sharded = phase_train_sharded(train, args.profile)
    say("phase train-smollm:")
    launches_smol, train_smol = phase_train_smollm()
    say("phase train-sharded-tp2d:")
    launches_tp2d, train_tp2d = phase_train_sharded_tp2d(train_smol,
                                                         args.profile)
    bst_agree = phase_bst_agreement()
    say("phase serve-bst:")
    serve_bst = phase_serve_bst(args.profile)
    say("phase train-bst:")
    train_bst = phase_train_bst(args.profile)
    gnn_agree = phase_gnn_agreement()
    say("phase train-gnn:")
    train_gnn = phase_train_gnn(args.profile)
    say("phase train-sharded-gnn:")
    train_sharded_gnn = phase_train_sharded_gnn(train_gnn, args.profile)
    say("phase train-sharded-bst:")
    train_sharded_bst = phase_train_sharded_bst(args.profile)
    serve = dict(inc_steps=inc_steps, batch_steps=batch_steps,
                 louvain_s=louvain_s, adaptive_steps=adapt_steps,
                 adaptive_louvain_s=adapt_louvain_s,
                 adaptive_agreement=adapt_agree, round_trips=round_trips,
                 traced=traced, runtime=runtime, control=control,
                 captured=cap, lm=lm, sharded=sharded, train=train,
                 lm_configs=lm_configs, train_smollm=train_smol,
                 train_sharded=train_sharded,
                 train_sharded_tp2d=train_tp2d,
                 train_agreement=train_agree, bst_agreement=bst_agree,
                 serve_bst=serve_bst, train_bst=train_bst,
                 gnn_agreement=gnn_agree, train_gnn=train_gnn,
                 train_sharded_gnn=train_sharded_gnn,
                 train_sharded_bst=train_sharded_bst,
                 serve_sharded_lm=serve_sharded_lm, igpm_cells=igpm_cells,
                 examples=examples,
                 lse={lb: rows[("lse", lb)] for lb in
                      ("prefill", "hd40", "f32 hd16")},
                 gemm_transposes={lb: rows[("gemm transposes", lb)]
                                  for lb in ("gate", "down")})

    # BST and the GNNs add no row: no Pallas kernel lies on their paths
    # (the reference computes them with gathers, segment sums and XLA
    # matmuls), and phases 16-20 check that they launch none of these
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
            "launches_igpm_cells": launches_igpm.get(name, 0),
            "launches_examples": launches_ex.get(name, 0),
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
    gemm_bwd_tpu = (f"backward of {gemm_tpu}, XLA autodiff of "
                    f"src/repro/models/moe.py:103-105 in the reference")
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
             gemm_tpu, ("prefill gate", "prefill up", "prefill down"),
             launches_lm, "serve-lm"),
            # the backward's products, variants of the same source
            ("expert_gemm_dx", gemm_src + "expert_gemm_wgmma.cu",
             gemm_bwd_tpu, ("train gate", "train down"), launches_train,
             "train-lm"),
            ("expert_gemm_dw", gemm_src + "expert_gemm_wgmma.cu",
             gemm_bwd_tpu, ("train gate", "train down"), launches_train,
             "train-lm"),
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
            "launches_train_sharded": launches_sharded.get(name, 0),
            "launches_train_sharded_tp2d": launches_tp2d.get(name, 0),
            "launches_serve_sharded_lm": launches_ssl.get(name, 0),
            "launches_examples": launches_ex.get(name, 0),
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
