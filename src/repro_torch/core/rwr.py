"""Random Walk with Restart — the goodness signal of G-Ray (paper §III-A).

``r = c·e + (1−c)·Pᵀr`` iterated to (near) fixed point, with the
row-stochastic transition ``P = D⁻¹A``. Two interchangeable sweep backends:

  * ``coo`` — gather + ``index_add_`` over the live COO arcs,
  * ``ell`` — the ELL SpMM kernel (``repro_torch.kernels.spmv_ell``) over
    the incoming-adjacency ELL mirror. Pass the mirror as ``ell=`` (see
    :class:`~repro_torch.core.graph.EllCache`); the transition weights are
    applied by pre-scaling the iterate with 1/deg, so the mirror only needs
    structural refreshes.

Both backends split the sweep over the graph axis of a device mesh when
called with ``axis=`` (a :class:`~repro_torch.core.graph.GraphAxis`):
vertices partition into equal receiver slices; the COO path masks messages
to each shard's slice and folds the partial sums in shard order (non-owners
add exact zeros), the ELL path launches the kernel on each shard's row
block (:class:`~repro_torch.sparse.ell.EllBlocks`) and concatenates the
slices, and ``part=`` (:class:`~repro_torch.core.graph.PartitionedEdges`)
sweeps each shard's receiver-sliced arcs into its slice. Either way every
vertex's sum is formed in the replicated order and ``_combine`` runs once,
on the gathered table, so sharded sweeps are bitwise the replicated ones.
A graph placed on a mesh with its arcs in contiguous blocks (the IGPM
cell's ``P(batch axes)``) sweeps block by block instead, its partial sums
added at position 0 (:func:`_sweep_arcs`; within rounding of one device).

Many restart vectors run as one ``(n, S)`` dense block, and the
*incremental* variant warm-starts from the previous fixed point and needs
only a few sweeps. With ``rwr_adaptive`` the sweep count is measured: the
loop stops as soon as every column's ∞-norm residual drops to ``tol`` (a
hard cap bounds the trip count); a converged column freezes while the
stragglers keep sweeping, and the retired column-sweeps are counted
(``n_col_skipped``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.graph import (DynamicGraph, GraphAxis,
                                    PartitionedEdges, transition_weights)
from repro_torch.distrib.sharding import ShardedTensor
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.sparse.ell import EllBlocks, EllGraph


def _combine(e: torch.Tensor, agg: torch.Tensor, c: float) -> torch.Tensor:
    """``c·e + (1−c)·agg`` as two products and then an add — three separate
    eager ops, so the multiply-add is never contracted into an FMA and the
    rounding matches on every device."""
    ce = c * e
    scaled = (1.0 - c) * agg
    return ce + scaled


def _owned_mask(receivers: torch.Tensor, n_max: int, d: int,
                axis: GraphAxis) -> torch.Tensor:
    """True for arcs whose receiver lands in shard ``d``'s vertex slice."""
    return torch.div(receivers, axis.n_loc(n_max),
                     rounding_mode="floor") == d


def _sweep(g: DynamicGraph, w: torch.Tensor, r: torch.Tensor,
           e: torch.Tensor, c: float) -> torch.Tensor:
    """One power-iteration sweep over all restart columns: (n, S) → (n, S)."""
    msg = r[g.senders.to(torch.int64)] * w[:, None]          # (E, S)
    agg = torch.zeros_like(r).index_add_(0, g.receivers.to(torch.int64), msg)
    return _combine(e, agg, c)


def _sweep_axis(shards, axis: GraphAxis, r: torch.Tensor, e: torch.Tensor,
                c: float) -> torch.Tensor:
    """COO sweep split over the graph axis: shard ``d`` sums only the
    messages to its own receiver slice (the others are zeroed) into a
    full-length partial, and the partials fold in shard order. Every
    vertex's sum comes entirely from its owner shard — the others add exact
    zeros — so the result is bitwise the replicated one. ``shards`` holds
    each shard's (senders, receivers, weights, owned) on its device."""
    parts = []
    for (snd, rcv, w, own), r_d in zip(shards, axis.broadcast(r)):
        msg = torch.where(own[:, None], r_d[snd] * w[:, None], 0.0)
        parts.append(torch.zeros_like(r_d).index_add_(0, rcv, msg))
    return _combine(e, axis.reduce(parts, r.device, "sum"), c)


def _sweep_ell(ell, inv_deg: torch.Tensor, r: torch.Tensor,
               e: torch.Tensor, c: float,
               axis: Optional[GraphAxis] = None) -> torch.Tensor:
    """ELL-backend sweep: agg[v] = Σ_{u→v} r[u]/deg(u) via the kernel.

    The per-arc weight 1/deg(sender) depends only on the *column* vertex, so
    it factors out of the gather: A_in @ (r ⊙ inv_deg) — the mirror carries
    unit weights and never needs a weight refresh.

    Under ``axis`` the mirror is the shard-local row blocks
    (:class:`EllBlocks`): each shard's kernel writes its vertex slice from
    the whole scaled iterate, and the slices concatenate back — no
    cross-shard arithmetic at all.
    """
    x = r * inv_deg[:, None]
    if axis is None:
        agg = ell_ops.ell_spmm(ell.cols, ell.vals, ell.mask, ell.row_ids, x,
                               ell.n, index=ell.row_index())
    else:
        parts = [ell_ops.ell_spmm(b.cols, b.vals, b.mask, b.row_ids, x_d,
                                  b.n, index=b.row_index())
                 for b, x_d in zip(ell.blocks, axis.broadcast(x))]
        agg = axis.gather(parts, r.device)
    return _combine(e, agg, c)


def _part_weights(part: PartitionedEdges, g: DynamicGraph,
                  axis: GraphAxis) -> list:
    """Per shard, the slice's transition weights 1/deg(sender) (0 on dead
    slots) on the shard's device."""
    out = []
    for s, m, deg in zip(part.senders, part.mask, axis.broadcast(g.degree)):
        w = 1.0 / torch.clamp(deg, min=1.0)[s.to(torch.int64)]
        out.append(torch.where(m, w, torch.zeros_like(w)))
    return out


def _sweep_part(part: PartitionedEdges, ws: list, axis: GraphAxis,
                r: torch.Tensor, e: torch.Tensor, c: float) -> torch.Tensor:
    """Partitioned-storage COO sweep: each shard sums its receiver-sliced
    arcs straight into its local segments (receivers are stored
    slice-local, so no masking), and the slices concatenate back.
    Per-vertex slot order matches the replicated arrays and dead slots add
    exact +0.0, so the result is bitwise the replicated sweep's."""
    parts = []
    for s, rl, w, r_d in zip(part.senders, part.receivers_loc, ws,
                             axis.broadcast(r)):
        msg = r_d[s.to(torch.int64)] * w[:, None]           # (E_slice, S)
        agg = torch.zeros((part.n_loc, r.shape[1]), dtype=r.dtype,
                          device=r_d.device)
        parts.append(agg.index_add_(0, rl.to(torch.int64), msg))
    return _combine(e, axis.gather(parts, r.device), c)


def _coo_shards(g: DynamicGraph, w: torch.Tensor, axis: GraphAxis) -> list:
    """Each shard's copy of the replicated arcs, weights and owner mask."""
    snd = g.senders.to(torch.int64)
    rcv = g.receivers.to(torch.int64)
    return [(snd.to(dv), rcv.to(dv), w.to(dv),
             _owned_mask(rcv, g.n_max, d, axis).to(dv))
            for d, dv in enumerate(axis.devices)]


def _sweep_arcs(g: DynamicGraph, e: torch.Tensor, c: float,
                ell: Optional[Sequence[EllGraph]]):
    """The sweep of a graph whose arcs are sharded over a device mesh: the
    reference's distributed IGPM (its cell's arcs ``P(batch axes)``, the
    iterate replicated, each sweep's segment sum a ``psum`` across the arc
    shards).

    ``g``'s fields are ``ShardedTensor`` s on one mesh: senders, receivers
    and edge mask split into contiguous arc blocks, the vertex arrays
    replicated. The iterate and ``e`` lie at block 0's home, position 0.
    Per sweep the iterate goes to every other block's home (its first
    holder), each home sums its own block's messages into an (n, L)
    partial — ``index_add_`` over the block's arcs, or with ``ell`` (one
    :class:`EllGraph` per block, on its home's device: the card's route,
    which takes no float atomics) the ELL kernel over the block's mirror
    on the prescaled iterate — and the partials come back and add at
    position 0 in ascending block order before ``_combine``: per sweep
    2·(D − 1)·n·L·4 bytes, counted in ``mesh.bytes["arc_psum"]``. The sums
    run in another order than one device's, so the result differs from the
    unsharded sweep's by rounding (bitwise with one block)."""
    mesh = g.senders.mesh
    lay = g.senders.layout
    homes = [lay.holders(b)[0] for b in lay.blocks()]
    if ell is not None and len(ell) != len(homes):
        raise ValueError(f"{len(ell)} ELL mirrors for {len(homes)} arc "
                         f"blocks")
    blocks = []
    for d, h in enumerate(homes):
        with mesh.at(h):
            deg = g.degree.shards[h]
            if ell is None:
                snd = g.senders.shards[h].to(torch.int64)
                rcv = g.receivers.shards[h].to(torch.int64)
                w = 1.0 / torch.clamp(deg, min=1.0)[snd]
                w = torch.where(g.edge_mask.shards[h], w, torch.zeros_like(w))
                blocks.append(lambda r, s=snd, t=rcv, w=w: torch.zeros_like(
                    r).index_add_(0, t, r[s] * w[:, None]))
            else:
                inv = 1.0 / torch.clamp(deg, min=1.0)
                blocks.append(lambda r, m=ell[d], inv=inv: ell_ops.ell_spmm(
                    m.cols, m.vals, m.mask, m.row_ids, r * inv[:, None],
                    m.n, index=m.row_index()))
    nbytes = e.numel() * e.element_size()
    h0 = homes[0]

    def sweep(r: torch.Tensor) -> torch.Tensor:
        parts = []
        for h, block in zip(homes, blocks):
            r_h = r
            if h != h0:
                mesh.count("arc_psum", nbytes, to=h)
                with mesh.at(h), mesh.moving():
                    r_h = r.to(mesh.device(h), copy=True)
            with mesh.at(h):
                parts.append(block(r_h))
        with mesh.at(h0):
            total = parts[0]
            for p in parts[1:]:
                mesh.count("arc_psum", nbytes, to=h0)
                with mesh.moving():
                    p = p.to(mesh.device(h0))
                total = total + p
            return _combine(e, total, c)

    return sweep


def _sweep_fn(g: DynamicGraph, e: torch.Tensor, c: float,
              ell, axis: Optional[GraphAxis] = None,
              part: Optional[PartitionedEdges] = None):
    """The per-iteration sweep closure for either backend, replicated,
    split over ``axis``, or over the arc blocks of a graph placed on a
    mesh (:func:`_sweep_arcs`; ``ell`` then one mirror per block)."""
    if isinstance(g.senders, ShardedTensor):
        return _sweep_arcs(g, e, c, ell)
    if part is not None:
        assert axis is not None, "partitioned sweeps need a graph axis"
        ws = _part_weights(part, g, axis)
        return lambda r: _sweep_part(part, ws, axis, r, e, c)
    if ell is None:
        w = transition_weights(g)
        if axis is None:
            return lambda r: _sweep(g, w, r, e, c)
        shards = _coo_shards(g, w, axis)
        return lambda r: _sweep_axis(shards, axis, r, e, c)
    if axis is not None:
        assert isinstance(ell, EllBlocks) and ell.n_shards == axis.size, \
            "a graph axis sweeps the shard-local row blocks"
        ell = ell.to(axis.devices)
    inv_deg = 1.0 / torch.clamp(g.degree, min=1.0)
    return lambda r: _sweep_ell(ell, inv_deg, r, e, c, axis)


def rwr(g: DynamicGraph, e: torch.Tensor, iters: int = 30, c: float = 0.15,
        r0: Optional[torch.Tensor] = None,
        ell: Optional[EllGraph] = None,
        axis: Optional[GraphAxis] = None,
        part: Optional[PartitionedEdges] = None) -> torch.Tensor:
    """Batched RWR. ``e``: (n_max, S) restart distributions (columns sum ≤ 1).

    ``r0`` warm-starts the iteration (incremental mode); defaults to ``e``.
    ``ell`` selects the ELL sweep backend (must mirror ``g``'s live arcs);
    ``None`` keeps the COO path. ``axis`` splits each sweep over a graph
    axis (``ell`` then being the shard-local :class:`EllBlocks`); ``part``
    is the receiver-sliced edge store of partitioned storage (needs
    ``axis``), which replaces the graph's edge tensors entirely. The
    iterate and the result stay on ``e``'s device.
    """
    r = e if r0 is None else r0
    sweep = _sweep_fn(g, e, c, ell, axis, part)
    for _ in range(iters):
        r = sweep(r)
    return r


def rwr_adaptive(g: DynamicGraph, e: torch.Tensor, max_iters: int = 30,
                 tol: float = 1e-4, c: float = 0.15,
                 r0: Optional[torch.Tensor] = None,
                 ell: Optional[EllGraph] = None,
                 axis: Optional[GraphAxis] = None,
                 part: Optional[PartitionedEdges] = None
                 ) -> Tuple[torch.Tensor, int, int]:
    """Residual-adaptive RWR → ``(r, n_sweeps, n_col_skipped)``.

    Sweeps until every column's ∞-norm residual drops to ``tol`` or
    ``max_iters``, whichever first. Convergence is tracked PER COLUMN: a
    column whose residual is already ≤ ``tol`` keeps its current value
    (bitwise stable from then on) while the stragglers sweep, and
    ``n_col_skipped`` totals the column-sweeps the mask retired. One count
    of the live columns comes to the host per sweep: it both ends the loop
    and feeds the skip count; under ``axis`` it is still one read per
    sweep, of the gathered iterate, not one per shard.
    """
    r = e if r0 is None else r0
    sweep = _sweep_fn(g, e, c, ell, axis, part)
    n_cols = r.shape[1]
    active = torch.ones(n_cols, dtype=torch.bool, device=r.device)
    i = 0
    skipped = 0
    while i < max_iters:
        n_active = int(active.sum())
        if n_active == 0:
            break
        r_new = sweep(r)
        res = (r_new - r).abs().amax(dim=0)                  # (S,)
        take = active & (res > tol)
        skipped += n_cols - n_active
        r = torch.where(take[None, :], r_new, r)
        active = take
        i += 1
    return r, i, skipped


def restart_onehot(ids: torch.Tensor, n_max: int) -> torch.Tensor:
    """(S,) vertex ids → (n_max, S) one-hot restart matrix (ids outside
    ``[0, n_max)`` give an all-zero column)."""
    ids = ids.to(torch.int64)
    e = torch.zeros((n_max, ids.shape[0]), dtype=torch.float32,
                    device=ids.device)
    ok = (ids >= 0) & (ids < n_max)
    col = torch.arange(ids.shape[0], device=ids.device)
    e[ids[ok], col[ok]] = 1.0
    return e


def label_restarts(g: DynamicGraph, n_labels: int) -> torch.Tensor:
    """(n_max, L) restart matrix: column ℓ uniform over live label-ℓ. For
    a graph placed on a mesh, from position 0's copies of the replicated
    vertex arrays, there."""
    if isinstance(g.labels, ShardedTensor):
        with g.labels.mesh.at(0):
            return _label_restarts(g.labels.shards[0], g.node_mask.shards[0],
                                   n_labels)
    return _label_restarts(g.labels, g.node_mask, n_labels)


def _label_restarts(labels: torch.Tensor, node_mask: torch.Tensor,
                    n_labels: int) -> torch.Tensor:
    onehot = (labels[:, None].to(torch.int64)
              == torch.arange(n_labels, device=labels.device)[None, :]
              ).to(torch.float32)
    onehot = onehot * node_mask[:, None]
    counts = torch.clamp(onehot.sum(dim=0, keepdim=True), min=1.0)
    return onehot / counts


def label_rwr(g: DynamicGraph, n_labels: int, iters: int = 30,
              c: float = 0.15, r0: Optional[torch.Tensor] = None,
              ell: Optional[EllGraph] = None,
              axis: Optional[GraphAxis] = None,
              part: Optional[PartitionedEdges] = None) -> torch.Tensor:
    """Label-conditioned RWR table r_lab: (n_max, L).

    Column ℓ is the RWR fixed point whose restart distribution is uniform
    over live vertices with label ℓ; r_lab[v, ℓ] is the proximity between v
    and the label-ℓ population — the seed-finder goodness input. For a
    graph placed on a mesh with its arcs in blocks (the IGPM cell's),
    ``r0`` is the warm start at position 0 and ``ell`` one mirror per
    block; the table comes back at position 0.
    """
    e = label_restarts(g, n_labels)
    return rwr(g, e, iters=iters, c=c, r0=r0, ell=ell, axis=axis, part=part)


def label_rwr_adaptive(g: DynamicGraph, n_labels: int, max_iters: int = 30,
                       tol: float = 1e-4, c: float = 0.15,
                       r0: Optional[torch.Tensor] = None,
                       ell: Optional[EllGraph] = None,
                       axis: Optional[GraphAxis] = None,
                       part: Optional[PartitionedEdges] = None
                       ) -> Tuple[torch.Tensor, int, int]:
    """Residual-adaptive :func:`label_rwr` →
    ``(r_lab, n_sweeps, n_col_skipped)``."""
    e = label_restarts(g, n_labels)
    return rwr_adaptive(g, e, max_iters=max_iters, tol=tol, c=c, r0=r0,
                        ell=ell, axis=axis, part=part)


def rwr_residual(g: DynamicGraph, r: torch.Tensor, e: torch.Tensor,
                 c: float = 0.15,
                 ell: Optional[EllGraph] = None,
                 axis: Optional[GraphAxis] = None,
                 part: Optional[PartitionedEdges] = None) -> torch.Tensor:
    """‖r − (c·e + (1−c)·Pᵀr)‖∞ per column — convergence diagnostics."""
    nxt = _sweep_fn(g, e, c, ell, axis, part)(r)
    return (nxt - r).abs().amax(dim=0)
