"""Dataclass config system (PyTorch port; field names and defaults match the
JAX package's ``repro.config.base`` one for one).

Every selectable architecture (``--arch <id>``) is an :class:`ArchConfig`
holding a family-specific model config plus its assigned input-shape set.
Configs are plain frozen dataclasses so they hash, compare, and print well,
and so a reduced "smoke" variant is just ``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell assigned to an architecture.

    ``kind`` selects which step function is lowered in the dry-run:
      - ``train``    → train_step (fwd + bwd + optimizer)
      - ``prefill``  → prefill forward (no bwd)
      - ``decode``   → serve_step (1 new token against a KV cache)
      - ``serve``    → inference forward (GNN / recsys scoring)
    ``dims`` carries the published numbers verbatim.
    """

    name: str
    kind: str
    dims: Dict[str, int] = field(default_factory=dict)

    def dim(self, key: str, default: Optional[int] = None) -> int:
        if key in self.dims:
            return self.dims[key]
        if default is None:
            raise KeyError(f"shape {self.name} has no dim {key!r}")
        return default


# ---------------------------------------------------------------------------
# Family configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    router_jitter: float = 0.0
    # 'expert' → shard the expert axis over "model" (EP);
    # 'ffn'    → shard each expert's d_ff over "model" (TP). Hillclimb knob.
    moe_shard: str = "expert"


@dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"
    # remat: 'none' | 'full' | 'dots' — activation checkpoint policy (hillclimb knob)
    remat: str = "full"
    # use the Pallas flash-attention kernel path (TPU); jnp path otherwise
    use_flash: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + per-layer + head)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        per_layer = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d  # qkvo
        per_layer += 2 * d  # norms
        if self.moe is None:
            per_layer += 3 * d * self.d_ff  # gate/up/down (SwiGLU)
        else:
            m = self.moe
            per_layer += d * m.n_experts  # router
            per_layer += m.n_experts * 3 * d * m.d_ff_expert
            per_layer += m.n_shared_experts * 3 * d * self.d_ff
        n = self.n_layers * per_layer
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        dense = self.param_count() - self.n_layers * m.n_experts * 3 * d * m.d_ff_expert
        active = self.n_layers * (m.top_k + m.n_shared_experts) * 3 * d * m.d_ff_expert
        return dense + active


@dataclass(frozen=True)
class GNNConfig:
    kind: str  # schnet | dimenet | graphcast | meshgraphnet
    n_layers: int
    d_hidden: int
    # schnet
    n_rbf: int = 0
    cutoff: float = 0.0
    # dimenet
    n_bilinear: int = 0
    n_spherical: int = 0
    n_radial: int = 0
    # graphcast
    mesh_refinement: int = 0
    n_vars: int = 0
    aggregator: str = "sum"
    # meshgraphnet
    mlp_layers: int = 2
    d_out: int = 1
    dtype: str = "float32"
    # cap on triplets per edge for angular models on generic graphs
    triplets_per_edge: int = 8


@dataclass(frozen=True)
class BSTConfig:
    """Behavior Sequence Transformer (Alibaba, arXiv:1905.06874)."""

    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    n_items: int = 4_194_304  # production-scale sparse item table (2^22)
    n_cates: int = 16_384
    n_user_feats: int = 8  # other-feature fields (user profile / context)
    user_feat_vocab: int = 65_536
    dtype: str = "float32"
    leaky_slope: float = 0.01


def resolve_backend(backend: str, device="cuda") -> str:
    """Resolve the ``'auto'`` sweep backend for the device the engine runs on.

    ``'ell'`` on a CUDA device (the hand-written ELL kernels of
    ``repro_torch.kernels.spmv_ell`` run there); ``'coo'`` on the CPU, where
    the ELL wrappers fall back to their plain gather/einsum versions and the
    COO gather/segment path is the cheaper of the two.
    """
    if backend != "auto":
        return backend
    import torch  # local import keeps this module import-light

    return "ell" if torch.device(device).type == "cuda" else "coo"


@dataclass(frozen=True)
class IGPMConfig:
    """The paper's own system configuration (§III–IV)."""

    # graph capacities (static shapes for jit)
    n_max: int = 4096
    e_max: int = 65536
    ell_width: int = 64  # padded neighbor-list width K
    # sparse-sweep backend for the RWR/G-Ray hot path:
    #   'ell'  — hand-written CUDA ELL SpMM/reach kernels over the
    #            incrementally maintained ELL mirror (the production path)
    #   'coo'  — irregular gather/segment ops over the live COO arcs
    #   'auto' — 'ell' on CUDA, 'coo' on the CPU (see :func:`resolve_backend`)
    backend: str = "auto"
    n_labels: int = 4
    # RWR
    restart_prob: float = 0.15  # c in the paper's RWR
    rwr_iters: int = 30
    rwr_iters_incremental: int = 5  # warm-started sweeps
    # residual-adaptive RWR: tol > 0 replaces the fixed-count sweep scan
    # with a lax.while_loop that stops once the ∞-norm residual
    # ‖r − (c·e + (1−c)·Pᵀr)‖∞ drops to tol (rwr_iters stays the hard cap),
    # so warm-started incremental steps converge in a few sweeps instead of
    # paying the full fixed count. 0 keeps the exact fixed-iteration path.
    rwr_tol: float = 0.0
    # G-Ray
    max_query_nodes: int = 8
    bridge_hops: int = 4
    top_k_patterns: int = 20
    # PEM
    init_community_size: int = 64
    min_community_size: int = 2
    max_community_size: int = 4096
    # DQN (paper: 2 hidden layers x 4 units, 2-d obs, 2 actions, eps=0.5)
    dqn_hidden: Tuple[int, ...] = (4, 4)
    dqn_obs_dim: int = 2
    dqn_n_actions: int = 2
    epsilon: float = 0.5
    gamma: float = 0.9
    dqn_lr: float = 1e-2
    replay_capacity: int = 512
    replay_batch: int = 16
    target_update_every: int = 10


@dataclass(frozen=True)
class DQNSpec:
    """Generic DQN learner spec (``repro.core.dqn.DQNAgent``).

    The PEM agent builds its spec from :class:`IGPMConfig`'s ``dqn_*``
    fields (vanilla 1-step DQN — the paper's shape); the serving
    controller (``repro.control``, DESIGN.md §9) constructs one directly
    with the two upgrades enabled:

    - ``double`` — double-DQN target (online-net argmax, target-net eval),
    - ``n_step`` — n-step return aggregation before the replay ring,
    - ``epsilon_final``/``epsilon_decay_steps`` — linear ε decay from
      ``epsilon`` to ``epsilon_final`` over the first ``decay_steps``
      training observations (0 steps — the default — keeps ε flat, the
      paper's shape).
    """

    obs_dim: int = 2
    n_actions: int = 2
    hidden: Tuple[int, ...] = (4, 4)
    epsilon: float = 0.5
    gamma: float = 0.9
    lr: float = 1e-2
    replay_capacity: int = 512
    replay_batch: int = 16
    target_update_every: int = 10
    double: bool = False
    n_step: int = 1
    epsilon_final: float = 0.0
    epsilon_decay_steps: int = 0


@dataclass(frozen=True)
class ControlConfig:
    """Closed-loop serving controller (``repro.control``, DESIGN.md §9).

    ``mode``:
      - ``off``    — no controller object is built; the runtime reads its
        static knobs exactly as before (pinned bitwise-identical to the
        controller-less runtime by ``tests/test_control.py``).
      - ``train``  — ε-greedy double-DQN learning against the goodput /
        SLO-violation reward, deciding every ``decide_every`` micro-batches
        on the ingress side.
      - ``frozen`` — greedy inference from the checkpointed policy; no
        learning, no exploration RNG — decision sequences replay.

    The action space is knob-ladder moves (see ``control/env.py``): the
    micro-batch window and shed threshold (queue depth) ladders are derived
    from the serving config unless given here; ``tol_ladder`` is the
    bounded discrete set of ``rwr_tol`` values the controller may select
    (``rwr_tol`` is a static jit argument — a bounded ladder bounds
    recompiles). If the engine's baseline ``rwr_tol`` is 0 (exact
    fixed-iteration sweeps) the tol knob is disabled rather than silently
    switching the engine onto the adaptive path.
    """

    mode: str = "off"                # | 'train' | 'frozen'
    decide_every: int = 4            # micro-batches per controller decision
    slo_e2e_s: float = 0.25          # ack-latency SLO for the goodput reward
    viol_weight: float = 2.0         # SLO-violation penalty weight in reward
    window_ladder: Tuple[int, ...] = ()   # () → derived from serving config
    depth_ladder: Tuple[int, ...] = ()    # () → derived from serving config
    tol_ladder: Tuple[float, ...] = (1e-5, 1e-4, 1e-3, 1e-2)
    seed: int = 0
    # append per-query freshness signals (worst staleness + fast burn,
    # DESIGN.md §11) to the observation: 12 dims → 14. Off by default —
    # the 12-dim layout is pinned unchanged in tests/test_control.py.
    freshness_obs: bool = False
    dqn: DQNSpec = field(default_factory=lambda: DQNSpec(
        obs_dim=12, n_actions=7, hidden=(32, 32), epsilon=0.15, gamma=0.8,
        lr=2e-3, replay_capacity=4096, replay_batch=32,
        target_update_every=50, double=True, n_step=3))


@dataclass(frozen=True)
class ObsConfig:
    """Observability knobs — structured tracing, flight recorder, and
    exporters (DESIGN.md §8).

    With ``enabled=False`` (the default) every span call hits the no-op
    tracer singleton and no extra device fences run: the engine path is
    bitwise-identical and compiled trace counts are unchanged (pinned in
    ``tests/test_obs.py``). With ``enabled=True`` the engine, server, and
    runtime emit Chrome ``trace_event``-shaped spans carrying step/batch
    ids into a bounded in-memory ring.

    ``trace_path`` is a *prefix*: exports write ``<prefix>.jsonl`` (one
    event per line) and ``<prefix>.json`` (a ``{"traceEvents": [...]}``
    document Perfetto / chrome://tracing opens directly). The flight
    recorder keeps the last ``flight_n`` fully-traced steps and dumps
    them to ``<flight_path>.NNN.jsonl`` on demand, on executor crash, or
    when an e2e latency sample exceeds ``slo_e2e_ms``. ``profiler_dir``
    brackets steps ``[profile_start, profile_stop)`` in a
    ``jax.profiler`` trace session for device-level drill-down.

    ``freshness=True`` attaches a per-standing-query
    :class:`~repro.obs.freshness.FreshnessLedger` (DESIGN.md §11) to the
    serving runtime: staleness/SLO-burn per query, ``freshness_*``
    telemetry, and the ``/freshness`` ops route. ``watchdog=True`` runs
    the :class:`~repro.obs.health.HealthMonitor` thread (heartbeats,
    stall/saturation/partition-pressure/burn detectors, readiness).
    ``metrics_port >= 0`` serves the live ops surface (``/metrics``
    ``/health`` ``/freshness`` ``/flight``) on 127.0.0.1 — 0 binds an
    ephemeral port, −1 (default) no server. All three are host-side
    only: engine stores stay bitwise-identical with them enabled
    (pinned in ``tests/test_freshness.py``).
    """

    enabled: bool = False
    trace_path: str = ""       # export prefix; "" = in-memory ring only
    event_cap: int = 65536     # bounded span ring (oldest spans drop)
    flight_n: int = 16         # flight-recorder ring of traced steps
    flight_path: str = ""      # dump prefix; "" = in-memory only
    slo_e2e_ms: float = 0.0    # >0: dump flight when an e2e sample exceeds
    prometheus_path: str = ""  # Prometheus text-format snapshot target
    profiler_dir: str = ""     # profiler trace dir ("" = off)
    profile_start: int = 0     # first step inside the profiler session
    profile_stop: int = 0      # first step outside it
    # -- per-query freshness (DESIGN.md §11) --
    freshness: bool = False        # per-standing-query staleness ledger
    freshness_slo_s: float = 0.5   # staleness SLO the burn windows track
    freshness_fast_s: float = 5.0  # fast burn window (acute breaches)
    freshness_slow_s: float = 60.0  # slow burn window (smolder)
    # -- health watchdog --
    watchdog: bool = False         # monitor thread over runtime heartbeats
    watchdog_period_s: float = 0.25   # check cadence
    stall_after_s: float = 2.0     # heartbeat age ⇒ thread stalled
    queue_high_frac: float = 0.9   # ingress-queue fill considered saturated
    queue_dwell_periods: int = 3   # consecutive saturated checks ⇒ degraded
    partition_near_frac: float = 0.9  # live-slice occupancy ⇒ degraded
    burn_degraded: float = 0.5     # fast-window freshness burn ⇒ degraded
    # -- live ops surface --
    metrics_port: int = -1         # −1 off; 0 ephemeral; >0 fixed port


@dataclass(frozen=True)
class EngineConfig:
    """Knobs of the functional-core match engine (DESIGN.md §4).

    One :class:`repro.engine.Engine` owns THE step pipeline every matcher
    facade drives (apply + ELL refresh → PEM mask → induced extraction →
    label RWR → per-bucket bank G-Ray → merge). Standing queries live in
    *buckets* keyed on ``(q_max, qe_max, B_pad)`` — padded pow-2 shapes —
    so ``register``/``retire`` swap rows inside a bucket without retracing.

    ``mode``:
      - ``incremental`` — the paper's IGPM loop (PEM recompute set, storm
        fallback past ``full_graph_frac``); ``adaptive`` selects the DQN-
        driven community threshold (IGPM-PEM) vs the fixed one (Inc).
      - ``batch`` — re-run G-Ray from scratch on the full graph each step
        (the paper's Batch oracle; stores rebuilt, no PEM).

    ``seed_cache_staleness`` bounds the storm-fallback seed cache: when a
    storm step finds the label-RWR table at most this many applied update
    events stale, the (n, L) warm-start sweeps are skipped and the cached
    per-bucket seed top-k is reused as long as the recompute mask is close
    enough too — within ``seed_cache_hamming`` flipped vertices of the mask
    the cached seeds were computed for (0 = the exact-match memo). 0
    staleness disables the cache (every storm step refreshes, the
    pre-engine behavior). ``shard="auto"`` runs each bucket's match through
    ``shard_map`` over the query axis when >1 device is visible (vmap on
    one device); ``"off"`` pins the single-device path.

    ``graph_shard="auto"`` adds the second mesh axis: vertices partition
    over a ``"g"`` axis, the full-graph RWR/BFS sweeps run shard-local
    (COO: receiver-masked partial segment-sum + psum; ELL: per-shard row
    blocks + all_gather) and each bucket's storm/batch match runs on a 2-D
    ``(q, g)`` mesh. Bit-identical to the replicated path by construction
    (DESIGN.md §5); ``"off"`` (default) keeps the graph replicated. When
    both axes are ``"auto"`` the device pool splits between them
    (graph axis ≤ √devices); with ``shard="off"`` the graph axis may take
    every device.

    ``edge_partition="on"`` (with a live graph axis) co-partitions the
    edge STORAGE with the receiver slices (DESIGN.md §10): the COO
    backend maintains an :class:`~repro.core.graph.EdgePartition` whose
    per-slice blocks feed the mesh instead of the replicated edge arrays
    (per-device edge memory ~1/g, no receiver masking in the sweeps), and
    the ELL backend shrinks the mirror's row blocks to the partitioned
    slice capacity. Still bit-identical to the replicated path. Off by
    default because the per-slice capacity is static
    (``partition_slice_capacity`` — ``partition_headroom``x over a
    balanced split): a stream whose receivers concentrate hard enough on
    one slice raises :class:`~repro.core.graph.PartitionOverflowError`
    instead of degrading silently. Skewed workloads (flash crowds pile
    receivers onto one slice) trade memory for safety by raising
    ``partition_headroom`` — at ``headroom >= g`` a slice can absorb
    every live arc and overflow is impossible.
    """

    mode: str = "incremental"        # | 'batch'
    adaptive: bool = True
    full_graph_frac: float = 0.5     # update-storm full-pass threshold
    seed_cache_staleness: int = 0    # events; 0 = always refresh
    seed_cache_hamming: int = 0      # mask Hamming bound for seed reuse
    # bucket padding: pow-2 roundup of (query vertices, schedule length)
    # with these floors, capped by (q_cap, qe_cap)
    q_floor: int = 4
    qe_floor: int = 4
    q_cap: int = 8
    qe_cap: int = 16
    shard: str = "auto"              # query axis: | 'off'
    graph_shard: str = "off"         # graph axis: | 'auto'
    edge_partition: str = "off"      # edge storage on the graph axis: | 'on'
    partition_headroom: float = 1.25  # slice capacity over a balanced split
    v_max: int = 4096                # updated-vertex buffer width
    # exact-duplicate dedup at register: a query whose tensors equal a
    # live one becomes an ALIAS of that row (zero device work; results
    # fan out to both stores). Off pins one bank row per qid.
    dedup: bool = True
    # structured tracing / flight recorder (DESIGN.md §8)
    obs: ObsConfig = field(default_factory=ObsConfig)


@dataclass(frozen=True)
class ServingConfig:
    """Continuous multi-query serving knobs (DESIGN.md §3).

    The serving loop drains at most ``microbatch_window`` queued update
    events per step, coalesces them into one :class:`UpdateBatch`, and runs
    the shared pipeline + query-bank match once. The queue is bounded at
    ``queue_depth`` events; past that, back-pressure applies
    ``drop_policy``:
      - ``drop_oldest`` — evict the oldest pending event (freshness wins)
      - ``drop_newest`` — reject the offered event (history wins)
    ``coalesce`` annihilates add/remove pairs of the same arc that meet in
    the pending window, so storms of flapping edges never reach the device.
    """

    queue_depth: int = 4096
    microbatch_window: int = 256
    drop_policy: str = "drop_oldest"  # | 'drop_newest'
    coalesce: bool = True
    adaptive: bool = True             # PEM community size driven by the DQN
    full_graph_frac: float = 0.5      # update-storm full-pass threshold
    telemetry_window: int = 512       # step-latency samples kept for p50/p99
    # query-size caps: a registered query may not exceed this many vertices
    # / schedule edges (buckets pad to pow-2 shapes below these caps)
    q_max: int = 8
    qe_max: int = 16
    # storm-fallback seed cache bound (events; 0 = off — see EngineConfig)
    seed_cache_staleness: int = 0
    seed_cache_hamming: int = 0       # mask Hamming bound for seed reuse
    shard: str = "auto"               # query-axis bucket execution | 'off'
    graph_shard: str = "off"          # graph-axis sweep sharding | 'auto'
    edge_partition: str = "off"       # edge storage on the graph axis | 'on'
    partition_headroom: float = 1.25  # slice capacity over a balanced split
    # per-channel telemetry ring overrides, ((channel, window), ...) —
    # tuples keep the config hashable; e2e/queue_wait already default to
    # a p999-credible 4096 (telemetry.DEFAULT_CHANNEL_WINDOWS)
    telemetry_channel_windows: Tuple[Tuple[str, int], ...] = ()
    # structured tracing / flight recorder (DESIGN.md §8)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def engine(self) -> EngineConfig:
        """The engine configuration this serving configuration implies."""
        return EngineConfig(
            mode="incremental", adaptive=self.adaptive,
            full_graph_frac=self.full_graph_frac,
            seed_cache_staleness=self.seed_cache_staleness,
            seed_cache_hamming=self.seed_cache_hamming,
            q_cap=self.q_max, qe_cap=self.qe_max, shard=self.shard,
            graph_shard=self.graph_shard,
            edge_partition=self.edge_partition,
            partition_headroom=self.partition_headroom, obs=self.obs)


@dataclass(frozen=True)
class RuntimeConfig:
    """Async serving-runtime knobs (DESIGN.md §6).

    The runtime splits one :class:`~repro.serving.server.MatchServer` into
    two threads: an *ingress* thread that paces the workload by an injected
    clock, offers events into the bounded/coalescing ``UpdateQueue``, and
    assembles micro-batches; and a *device-executor* thread that runs
    ``MatchServer.step_packed`` on each batch and fans the per-query match
    deltas out to subscribers. A bounded handoff of ``handoff_depth``
    staged batches connects them; the executor *pops* a batch before
    running it, so depth 1 is the classic double buffer — one batch in
    flight on the device while the ingress assembles micro-batch *k+1*
    into the slot. Deeper handoffs absorb burstier assembly at a direct
    tail-latency cost: a staged batch is committed work that back-pressure
    eviction can no longer refresh, so every extra slot adds up to one
    device step of end-to-end latency under saturation.

    ``ingress`` picks what happens when the executor falls behind and the
    handoff is full:
      - ``lockstep`` — the ingress thread blocks pushing its packed batch
        (arrivals of later ticks wait; executor timing never sheds
        anything — though a single tick larger than ``queue_depth`` still
        overflows the queue bound, deterministically). Batch composition
        is then a pure function of the event sequence, so the async store
        is bit-identical to the sync replay — the determinism contract
        ``tests/test_runtime.py`` pins.
      - ``shed`` — the ingress thread keeps accepting arrivals; pending
        events pile into the ``UpdateQueue`` where coalescing and the
        ``queue_depth`` bound apply (drop/evict counters surface in
        telemetry). Real-time load shedding: under overload the *accepted*
        event set becomes timing-dependent, by design.

    Micro-batches are cut at workload tick boundaries (a tick with more
    events than ``ServingConfig.microbatch_window`` splits into
    deterministic window-sized chunks) — never merged across the point an
    executor happens to be busy, which is what keeps composition
    scheduling-independent.

    ``drain_timeout_s`` bounds the graceful ``stop(drain=True)`` flush;
    ``checkpoint_dir`` (when set) makes the drain checkpoint the whole
    engine via ``Engine.save`` (``checkpoint_every`` > 0 adds a periodic
    cadence in steps).

    ``n_executors > 1`` fans the per-bucket bank matches of each step
    across that many executor threads (DESIGN.md §10): the staged handoff
    and all host-side decisions (seed memo, PEM, merge) stay on the
    single executor thread, only the independent per-bucket device
    dispatches run on the pool, and a fan-in barrier joins them before
    the merge/subscriber delivery — so results (and the lockstep
    determinism contract) are exactly the single-executor ones.
    """

    handoff_depth: int = 1           # staged batches; 1 = double buffer
    n_executors: int = 1             # per-bucket match fan-out threads
    ingress: str = "lockstep"        # | 'shed'
    drain_timeout_s: float = 60.0
    checkpoint_dir: str = ""
    checkpoint_every: int = 0        # steps; 0 = only on drain
    subscriber_depth: int = 4096     # per-subscriber delta buffer bound
    # runtime-level tracing override: None inherits the server engine's
    # Obs hub (usually what you want — one hub sees ingress, executor,
    # and engine spans together); set to rebuild the hub at start()
    obs: Optional[ObsConfig] = None
    # closed-loop RL controller (DESIGN.md §9); mode='off' is a strict
    # no-op — no controller object exists and the static knobs apply
    control: ControlConfig = field(default_factory=ControlConfig)


# ---------------------------------------------------------------------------
# Arch + run configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    # error-feedback top-k gradient compression ratio (1.0 = off)
    grad_compression: float = 1.0
    seed: int = 0


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # 'lm' | 'gnn' | 'recsys' | 'igpm'
    model: Any  # TransformerConfig | GNNConfig | BSTConfig | IGPMConfig
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""  # citation tag from the assignment

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"arch {self.arch_id} has no shape {name!r}")

    def replace_model(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, model=dataclasses.replace(self.model, **kw))


# Canonical LM shape set (assigned to every LM-family arch).
LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

# Canonical GNN shape set.
GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "train",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout1": 15, "fanout2": 10, "d_feat": 602}),
    ShapeSpec("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeSpec("molecule", "train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16}),
)

# Canonical recsys (BST) shape set.
BST_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "serve", {"batch": 1, "n_candidates": 1000000}),
)
