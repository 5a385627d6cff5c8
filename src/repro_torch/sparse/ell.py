"""ELL-padded adjacency — the sparse layout of the RWR / bounded-BFS sweeps.

Each vertex's neighbor list is padded to a fixed width ``K`` so every sparse
matrix-matrix product is a gather + masked reduce over a regular ``(R, K)``
tile. Rows whose degree exceeds ``K`` spill into further rows owned by the
same vertex through ``row_ids`` (ELL + row-splitting), so no neighbor is
ever dropped.

The construction functions accept an explicit row capacity ``r_cap`` so
that every graph sharing one ``(n, e_cap, K)`` bucket has one static shape;
capacity rows past the allocated ones are all-masked and carry ``row_id``
0.

The CUDA kernels (``repro_torch.kernels.spmv_ell``) walk one destination
vertex's rows in ascending row order. :meth:`EllGraph.row_index` builds that
walk order — a CSR over the live rows sorted stably by ``row_ids`` — once
per graph object and caches it, so the 25 sweeps of one RWR table pay for
one sort.

Under the graph mesh axis the mirror is split into per-shard row blocks
(:class:`EllBlocks`, :func:`build_ell_sharded`): block ``d`` holds the rows
of vertex slice ``[d·n_loc, (d+1)·n_loc)`` with slice-local ``row_ids`` and
global column ids, on shard ``d``'s device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(eq=False)
class EllGraph:
    """Padded neighbor-list graph (static shapes).

    cols:    int32[R, K]   neighbor ids (arbitrary value where ~mask)
    vals:    f32[R, K]     edge weights (0 where ~mask)
    row_ids: int32[R]      owning vertex of each padded row (row-splitting)
    mask:    bool[R, K]    entry validity
    n:       int           number of vertices
    """

    cols: torch.Tensor
    vals: torch.Tensor
    row_ids: torch.Tensor
    mask: torch.Tensor
    n: int
    _index: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False)

    def row_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(perm int32[R_live], row_ptr int32[n+1])``: the rows holding at
        least one live entry, sorted stably by owning vertex, so vertex
        ``v``'s rows are ``perm[row_ptr[v]:row_ptr[v+1]]`` in ascending row
        order. Cached on this object (the arrays never change under it)."""
        if self._index is None:
            self._index = build_row_index(self.mask, self.row_ids, self.n)
        return self._index


def build_row_index(mask: torch.Tensor, row_ids: torch.Tensor,
                    n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vertex walk order over the live rows of an ELL tile (see
    :meth:`EllGraph.row_index`). Fully masked rows — the unallocated
    capacity rows, which all claim vertex 0 — are left out: they add
    nothing to a sum or to a max that starts at 0."""
    live = mask.any(dim=1)
    owner = row_ids.to(torch.int64)
    key = torch.where(live, owner, torch.full_like(owner, n))
    perm = torch.sort(key, stable=True).indices
    n_live = int(live.sum())
    counts = torch.bincount(owner[live], minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=mask.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return (perm[:n_live].to(torch.int32).contiguous(),
            row_ptr.to(torch.int32).contiguous())


def ell_row_capacity(n: int, e_cap: int, k: int) -> int:
    """Worst-case padded-row count for ``e_cap`` live arcs over ``n`` vertices.

    Every vertex owns at least one row and each row beyond the first of a
    vertex accounts for ``k`` arcs, so Σ max(1, ceil(deg/k)) ≤ n + ceil(E/k).
    """
    return n + -(-e_cap // k)


def ell_block_capacity(n: int, e_cap: int, k: int, n_shards: int = 1) -> int:
    """Static row capacity of ONE vertex-slice block of a sharded ELL:
    ``n/n_shards + ceil(E/k)`` rows (the :func:`ell_row_capacity` bound
    applied to the slice)."""
    return n // n_shards + -(-e_cap // k)


@dataclasses.dataclass(eq=False)
class EllBlocks:
    """Shard-local row-block ELL of the graph mesh axis: one
    :class:`EllGraph` per vertex slice, each on its shard's device, with
    ``n`` the slice width ``n_loc``, ``row_ids`` local to the slice and
    column ids global. Each block's row index is built on the block, from
    its own slice. Block ``d`` is exactly the rows ``[d·r_cap_block,
    (d+1)·r_cap_block)`` of the JAX package's sharded ``EllGraph``."""

    blocks: Tuple[EllGraph, ...]
    _moved: Dict[Tuple[torch.device, ...], "EllBlocks"] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_shards(self) -> int:
        return len(self.blocks)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(b.cols.device for b in self.blocks)

    def to(self, devices: Sequence[torch.device]) -> "EllBlocks":
        """The same blocks on ``devices`` (block ``d`` on ``devices[d]``);
        a copy is made once per device set and kept, so every sweep of one
        mirror version reuses it and its row indexes."""
        devices = tuple(torch.device(dv) for dv in devices)
        if devices == self.devices:
            return self
        if devices not in self._moved:
            self._moved[devices] = EllBlocks(tuple(
                EllGraph(b.cols.to(dv), b.vals.to(dv), b.row_ids.to(dv),
                         b.mask.to(dv), b.n)
                for b, dv in zip(self.blocks, devices)))
        return self._moved[devices]


def build_ell(senders: np.ndarray, receivers: np.ndarray, n: int,
              weights: Optional[np.ndarray] = None, k: int = 64,
              r_cap: Optional[int] = None, device="cuda") -> EllGraph:
    """Host-side ELL construction from a COO edge list (numpy).

    Produces rows in vertex order; vertices with degree > k get
    ``ceil(deg/k)`` rows. Isolated vertices still get one (all-masked) row so
    ``row_ids`` always covers ``0..n-1`` at least once. When ``r_cap`` is
    given the row axis is padded (all-masked, row_ids=0) to that fixed
    capacity.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if weights is None:
        weights = np.ones(senders.shape[0], np.float32)
    order = np.argsort(senders, kind="stable")
    s, r, w = senders[order], receivers[order], weights[order]
    deg = np.bincount(s, minlength=n)
    rows_per_v = np.maximum(1, -(-deg // k))  # ceil, min 1
    row_start = np.concatenate([[0], np.cumsum(rows_per_v)])
    n_rows = int(row_start[-1])
    n_alloc = n_rows if r_cap is None else int(r_cap)
    if n_rows > n_alloc:
        raise ValueError(f"ELL needs {n_rows} rows > capacity {n_alloc}")

    cols = np.zeros((n_alloc, k), np.int32)
    vals = np.zeros((n_alloc, k), np.float32)
    mask = np.zeros((n_alloc, k), bool)
    row_ids = np.zeros(n_alloc, np.int32)
    row_ids[:n_rows] = np.repeat(np.arange(n, dtype=np.int32), rows_per_v)
    # position of each edge within its vertex block
    edge_pos = np.arange(len(s)) - np.concatenate([[0], np.cumsum(deg)])[s]
    rr = row_start[s] + edge_pos // k
    cc = edge_pos % k
    cols[rr, cc] = r
    vals[rr, cc] = w
    mask[rr, cc] = True
    dev = torch.device(device)
    return EllGraph(torch.as_tensor(cols, device=dev),
                    torch.as_tensor(vals, device=dev),
                    torch.as_tensor(row_ids, device=dev),
                    torch.as_tensor(mask, device=dev), n)


def build_ell_sharded(senders: np.ndarray, receivers: np.ndarray, n: int,
                      n_shards: int, weights: Optional[np.ndarray] = None,
                      k: int = 64, r_cap_block: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> EllBlocks:
    """Shard-local row-block ELL over ``n_shards`` equal vertex slices.

    The row-owner axis (``senders`` here, as in :func:`build_ell`)
    partitions into contiguous slices of ``n // n_shards`` vertices; slice
    ``d`` becomes a block of ``r_cap_block`` rows on ``devices[d]`` with
    ``row_ids`` local to the slice and column ids global. Within a slice
    the layout is :func:`build_ell` verbatim, so a vertex's entries land in
    the same relative (row, slot) positions as in the unsharded layout and
    every per-vertex reduction order is preserved.
    """
    if n % n_shards:
        raise ValueError(f"n {n} not divisible by n_shards {n_shards}")
    n_loc = n // n_shards
    if r_cap_block is None:
        r_cap_block = ell_block_capacity(n, len(np.asarray(senders)) or 1,
                                         k, n_shards)
    devices = list(devices) if devices is not None else ["cuda"] * n_shards
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if weights is None:
        weights = np.ones(senders.shape[0], np.float32)
    blocks = []
    for d in range(n_shards):
        sel = (senders >= d * n_loc) & (senders < (d + 1) * n_loc)
        blocks.append(build_ell(senders[sel] - d * n_loc, receivers[sel],
                                n_loc, weights=weights[sel], k=k,
                                r_cap=r_cap_block, device=devices[d]))
    return EllBlocks(tuple(blocks))
