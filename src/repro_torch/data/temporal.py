"""Synthetic temporal graph streams — statistical twins of paper Table III.

The paper evaluates on four timestamped edge streams (friends2008,
transactions, sx-askubuntu, sx-mathoverflow) that are network downloads we do
not have offline. The benchmark harness instead generates streams whose
vertex/edge/step ratios match the published statistics (optionally scaled
down for the CPU container) across the paper's five qualitative graph types
(§III-D-1): scale-free, random, sparse-isolated, sparse-dense, dense.

Labels are assigned i.i.d. from ``n_labels`` classes — the paper's data sets
are attributed social graphs; uniform labels make pattern counts comparable
across generators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from repro_torch.core.graph import DynamicGraph, UpdateBatch, new_graph


@dataclass(frozen=True)
class TemporalGraphSpec:
    name: str
    kind: str  # scale_free | random | sparse_isolated | sparse_dense | dense
    n_vertices: int
    n_edges: int          # total undirected edges over the whole stream
    n_steps: int          # number of update timesteps
    n_labels: int = 4
    seed: int = 0
    # temporal locality: measured-step updates are grouped by graph region
    # (real social/transaction streams are bursty — activity clusters in a
    # few communities per window, which is precisely the regime PEM targets)
    locality: bool = True
    locality_regions: int = 64
    # churn: removals emitted per measured step, as a fraction of that
    # step's additions (0 = the paper's addition-only streams; 1 = every
    # step deletes as many live edges as it adds). Removals are sampled
    # from edges actually live at that point, so every batch is valid.
    churn: float = 0.0
    # hotspot: every ``hotspot_period``-th measured step is a burst whose
    # additions all land in one small vertex region — the deletion/addition
    # storm scenario serving back-pressure is sized against
    hotspot: bool = False
    hotspot_period: int = 4
    hotspot_frac: float = 1.0 / 64.0

    @property
    def edges_per_step(self) -> int:
        return max(1, self.n_edges // self.n_steps)


class TemporalStream(NamedTuple):
    spec: TemporalGraphSpec
    graph: DynamicGraph                 # state after the warmup prefix
    updates: List[UpdateBatch]          # one batch per measured step
    labels: np.ndarray
    warmup_edges: int


# Paper Table III, scaled twins (scale=1.0 reproduces the published counts).
DATASET_TWINS: Dict[str, TemporalGraphSpec] = {
    "friends2008": TemporalGraphSpec("friends2008", "scale_free",
                                     224_879, 3_871_909, 6_893),
    "transactions": TemporalGraphSpec("transactions", "sparse_dense",
                                      112_130, 538_597, 1_779),
    "sx-askubuntu": TemporalGraphSpec("sx-askubuntu", "scale_free",
                                      159_316, 964_437, 2_060),
    "sx-mathoverflow": TemporalGraphSpec("sx-mathoverflow", "dense",
                                         24_818, 506_550, 2_350),
}


def scaled_twin(name: str, scale: float, n_steps: int | None = None,
                seed: int = 0) -> TemporalGraphSpec:
    base = DATASET_TWINS[name]
    return TemporalGraphSpec(
        name=f"{name}@{scale:g}", kind=base.kind,
        n_vertices=max(64, int(base.n_vertices * scale)),
        n_edges=max(256, int(base.n_edges * scale)),
        n_steps=n_steps or base.n_steps, n_labels=base.n_labels, seed=seed)


# ---------------------------------------------------------------------------
# Edge-stream generators (paper §III-D-1 graph types)
# ---------------------------------------------------------------------------

def _gen_edges(spec: TemporalGraphSpec,
               rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    n, m = spec.n_vertices, spec.n_edges
    if spec.kind == "scale_free":
        # preferential-attachment stream: endpoint ∝ degree+1
        src = np.zeros(m, np.int64)
        dst = np.zeros(m, np.int64)
        deg = np.ones(n, np.float64)
        # vectorized in chunks: sample against the degree snapshot per chunk
        chunk = max(256, m // 64)
        done = 0
        while done < m:
            k = min(chunk, m - done)
            p = deg / deg.sum()
            s = rng.choice(n, size=k, p=p)
            d = rng.choice(n, size=k, p=p)
            src[done:done + k] = s
            dst[done:done + k] = d
            np.add.at(deg, s, 1.0)
            np.add.at(deg, d, 1.0)
            done += k
    elif spec.kind == "random":
        src = rng.integers(0, n, m)
        dst = rng.integers(0, n, m)
    elif spec.kind == "sparse_isolated":
        # many tiny components: endpoints paired within random 4-vertex cells
        cell = rng.integers(0, n // 4, m) * 4
        src = cell + rng.integers(0, 4, m)
        dst = cell + rng.integers(0, 4, m)
    elif spec.kind == "sparse_dense":
        # sparse globally, dense planted communities (ideal for clustering)
        n_comm = max(8, n // 64)
        comm = rng.integers(0, n_comm, m)
        within = rng.random(m) < 0.9
        lo = (comm * (n // n_comm)).astype(np.int64)
        width = max(2, n // n_comm)
        src = lo + rng.integers(0, width, m)
        dst = np.where(within, lo + rng.integers(0, width, m),
                       rng.integers(0, n, m))
    elif spec.kind == "dense":
        # high density: confine to a √-sized core
        core = max(16, int(np.sqrt(n * 8)))
        src = rng.integers(0, core, m)
        dst = rng.integers(0, core, m)
    else:
        raise ValueError(f"unknown graph kind {spec.kind!r}")
    keep = src != dst
    return src[keep], dst[keep]


def generate_stream(spec: TemporalGraphSpec, n_max: int | None = None,
                    e_max: int | None = None, warmup_frac: float = 0.5,
                    n_measured_steps: int = 10,
                    u_max: int = 512, device="cuda") -> TemporalStream:
    """Build (warmed-up graph, per-step update batches).

    Mirrors the paper's measurement protocol (§IV-C): the stream is replayed
    for a warmup prefix (the paper uses 100 steps — too sparse before that),
    then ``n_measured_steps`` batches are emitted — pure additions by
    default; mixed add/remove batches when ``spec.churn > 0`` (removals
    are sampled from live edges), with periodic hotspot bursts when
    ``spec.hotspot`` is set. The same spec and seed give the same stream
    as the JAX package's generator; graph and batches land on ``device``.
    """
    rng = np.random.default_rng(spec.seed)
    src, dst = _gen_edges(spec, rng)
    labels = rng.integers(0, spec.n_labels, spec.n_vertices).astype(np.int32)

    m = len(src)
    eps = spec.edges_per_step
    # undirected → 2 arcs per edge; the add and remove lanes of an
    # UpdateBatch are padded to u_max independently, so each is bounded
    # on its own (removals only constrain per_step when churn > 1)
    per_step = min(eps, u_max // 2)
    if spec.churn > 0:
        per_step = min(per_step, int(u_max / (2.0 * spec.churn)))
    per_step = max(per_step, 1)
    rem_per_step = min(int(round(spec.churn * per_step)), u_max // 2)
    need = n_measured_steps * per_step
    warm = min(int(m * warmup_frac), m - need)
    warm = max(warm, 0)

    if spec.locality and need > 0:
        # group the measured tail by graph region so each step's updates are
        # bursty/local (see TemporalGraphSpec.locality). Key on the MAX
        # endpoint: in preferential-attachment streams the min endpoint is
        # usually a hub shared by everything, which would destroy locality.
        region = np.maximum(src[warm:warm + need],
                            dst[warm:warm + need]) // max(
            1, spec.n_vertices // spec.locality_regions)
        order = np.argsort(region, kind="stable")
        src[warm:warm + need] = src[warm:warm + need][order]
        dst[warm:warm + need] = dst[warm:warm + need][order]

    n_max = n_max or spec.n_vertices
    e_max = e_max or int(2 * (warm + need) + 4 * u_max)
    ws, wd = src[:warm], dst[:warm]
    g = new_graph(n_max, e_max, labels=labels,
                  senders=np.concatenate([ws, wd]),
                  receivers=np.concatenate([wd, ws]), device=device)

    # live-edge pool for churn sampling: warmup prefix + measured additions
    # as they are emitted; removals only ever hit edges live at that point
    pool_src = np.concatenate([ws, np.zeros(need, src.dtype)])
    pool_dst = np.concatenate([wd, np.zeros(need, dst.dtype)])
    alive = np.zeros(warm + need, bool)
    alive[:warm] = True
    pool_fill = warm

    hot_n = max(8, int(spec.n_vertices * spec.hotspot_frac))
    updates = []
    for t in range(n_measured_steps):
        lo = warm + t * per_step
        hi = lo + per_step
        a_s, a_d = src[lo:hi].copy(), dst[lo:hi].copy()
        if spec.hotspot and t % spec.hotspot_period == 0:
            # burst: all of this step's additions land in the hot region
            a_s, a_d = a_s % hot_n, a_d % hot_n
            keep = a_s != a_d
            a_s, a_d = a_s[keep], a_d[keep]
        r_s = r_d = None
        if rem_per_step > 0:
            live_idx = np.flatnonzero(alive[:pool_fill])
            take = min(rem_per_step, len(live_idx))
            if take > 0:
                pick = rng.choice(live_idx, size=take, replace=False)
                alive[pick] = False
                r_s, r_d = pool_src[pick], pool_dst[pick]
        if spec.churn > 0:
            k = len(a_s)
            pool_src[pool_fill:pool_fill + k] = a_s
            pool_dst[pool_fill:pool_fill + k] = a_d
            alive[pool_fill:pool_fill + k] = True
            pool_fill += k
        updates.append(UpdateBatch.mixed(add_src=a_s, add_dst=a_d,
                                         rem_src=r_s, rem_dst=r_d,
                                         u_max=u_max, device=device))
    return TemporalStream(spec, g, updates, labels, warm)
