"""Device-sharded bucket execution — the (query × graph) device mesh.

Two independent mesh axes, as in the JAX package's ``engine/sharding.py``:

``q`` — rows of a bucket bank are independent programs in the
content-independent (``memo=False``) schedule, so the bank match splits
over the query axis with ZERO collectives: each query shard takes its
slice of the bank tensors, the per-row seeds and the row→node plan, runs
the same expansion on its own device (the graph, ``r_lab`` and an ELL
mirror replicated there), and the results concatenate back in row order.

``g`` — vertices of the data graph partition into contiguous receiver
slices (:class:`~repro_torch.core.graph.GraphAxis`): the COO sweep zeroes
the messages to other slices and folds the partial sums in shard order,
the ELL mirror is kept as per-shard row blocks
(``EllCache(n_shards=…)``) whose kernels each write their vertex slice,
and the slices concatenate back. Non-owner shards contribute exact zeros
and concatenation does no arithmetic, so BOTH axes are pure
distributions: sharded results are bitwise the replicated path's on both
backends.

One process drives every shard (the JAX package is single-controller
too): the engine, the host PEM, the routers and the buckets stay in it,
each shard's tensors live on its device and its work is launched there,
and every collective is an explicit copy in a fixed order. A device list
may repeat one device: the CPU tests run ``["cpu"] * 4``, and on one card
``["cuda:0"] * 4`` checks the mesh without speeding it up.

Shard counts follow the JAX package's arithmetic over the mesh's device
count: powers of two, capped by the sharded dimension, so every shard
carries the same slice. When both axes are ``"auto"`` the devices split
between them (graph axis ≤ √devices); an ``"off"`` query axis frees every
device for the graph axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import (DynamicGraph, GraphAxis,
                                    PartitionedEdges, canonical_device)
from repro_torch.core.gray import GRayResult, _bfs_reach_hops
from repro_torch.core.query import QueryBank
from repro_torch.core.rwr import (label_rwr, label_rwr_adaptive, rwr,
                                  rwr_adaptive)
from repro_torch.sparse.ell import EllBlocks


def default_devices(device) -> List[torch.device]:
    """The mesh's devices when the caller names none: every visible card of
    a CUDA engine, the one CPU of a CPU engine (the port's counterpart of
    ``jax.devices()``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def mesh_devices(device, devices: Optional[Sequence] = None
                 ) -> List[torch.device]:
    """The engine's mesh devices: ``devices`` (may repeat one device) or
    :func:`default_devices`. Every one must be of the engine's type."""
    devs = ([canonical_device(dv) for dv in devices] if devices is not None
            else default_devices(device))
    if not devs:
        raise ValueError("the device mesh needs at least one device")
    kind = torch.device(device).type
    for dv in devs:
        if dv.type != kind:
            raise ValueError(f"mesh device {dv} is not of the engine's "
                             f"type {kind!r}")
    return devs


def _pow2_cap(cap: int) -> int:
    n = 1
    while n * 2 <= cap:
        n *= 2
    return n


def query_shard_count(b_pad: int, shard: str = "auto",
                      max_devices: int = 1) -> int:
    """Shards for a ``b_pad``-row bucket: the largest pow-2 ≤ min(devices,
    rows). 1 keeps the replicated path. ``max_devices`` is the device
    budget of the query axis (the rest belong to the graph axis)."""
    if shard == "off":
        return 1
    if shard != "auto":
        raise ValueError(f"unknown shard policy {shard!r}")
    return _pow2_cap(min(max_devices, b_pad))


def graph_shard_count(n_max: int, shard: str = "off",
                      max_devices: int = 1) -> int:
    """Shards of the graph axis: the largest pow-2 ≤ devices that divides
    ``n_max`` (equal vertex slices). ``"off"`` keeps the graph
    replicated."""
    if shard == "off":
        return 1
    if shard != "auto":
        raise ValueError(f"unknown graph shard policy {shard!r}")
    n = 1
    while n * 2 <= min(max_devices, n_max) and n_max % (n * 2) == 0:
        n *= 2
    return n


def device_split(shard: str, graph_shard: str, n_max: int,
                 n_devices: int) -> Tuple[int, int]:
    """How ``n_devices`` split between the two mesh axes.

    Returns ``(query_budget, g_shards)``: the graph axis takes every device
    when the query axis is off, at most √devices when both are auto (a
    balanced 2-D mesh), and the query axis gets the rest.
    """
    if graph_shard == "off":
        return n_devices, 1
    cap = n_devices if shard == "off" else _pow2_cap(int(np.sqrt(n_devices)))
    g = graph_shard_count(n_max, graph_shard, max_devices=max(cap, 1))
    return max(n_devices // g, 1), g


def _bank_rows(bank: QueryBank, rows: slice, dev: torch.device) -> QueryBank:
    return QueryBank(
        **{f: getattr(bank, f)[rows].to(dev)
           for f in ("labels", "mask", "order_src", "order_dst",
                     "order_tree", "order_mask", "anchor")},
        names=tuple(bank.names[rows]))


class ShardedBankMatch:
    """One bucket matcher's expansion over the ``(q, g)`` mesh.

    ``n_shards`` splits the bank's row axis over ``q``; ``g_shards > 1``
    adds the graph axis. A call with ``graph_sharded=True`` (the engine's
    storm/batch full-graph path) takes the shard-local ELL row blocks (or
    the partitioned COO slices) and runs each query shard's sweeps over its
    mesh row; ``graph_sharded=False`` (the induced-subgraph path, whose
    compact extraction is already the speedup) keeps the graph replicated
    and the sweeps collective-free. Query shard ``i`` runs on the devices
    ``mesh[i]``, its expansion on ``mesh[i][0]``.
    """

    def __init__(self, matcher, n_shards: int, g_shards: int,
                 devices: Sequence[torch.device]):
        assert not matcher.memo, "sharded buckets require memo=False"
        if len(devices) < n_shards * g_shards:
            raise ValueError(f"a {n_shards} x {g_shards} mesh needs "
                             f"{n_shards * g_shards} devices, got "
                             f"{len(devices)}")
        self.matcher = matcher
        self.n_shards = n_shards
        self.g_shards = g_shards
        devs = list(devices)[:n_shards * g_shards]
        self.axes = [GraphAxis(devs[i * g_shards:(i + 1) * g_shards])
                     for i in range(n_shards)]
        self.mesh = [list(axis.devices) for axis in self.axes]

    def __call__(self, g: DynamicGraph, r_lab: torch.Tensor,
                 seed_ids: torch.Tensor, seed_mask: torch.Tensor, ell,
                 bank: QueryBank, graph_sharded: bool = False,
                 row_node: Optional[torch.Tensor] = None,
                 part: Optional[PartitionedEdges] = None) -> GRayResult:
        graph_sharded = graph_sharded and self.g_shards > 1
        if not graph_sharded:
            part = None  # partitioned slices only exist on the graph axis
        elif ell is not None:
            assert isinstance(ell, EllBlocks), \
                "a graph-sharded match takes the shard-local row blocks"
        home = r_lab.device
        b_loc = bank.n_queries // self.n_shards
        outs = []
        for i, (row, axis) in enumerate(zip(self.mesh, self.axes)):
            lead = row[0]
            rows = slice(i * b_loc, (i + 1) * b_loc)
            if ell is None or graph_sharded:
                ell_i = ell
            else:
                ell_i = ell if ell.cols.device == lead else type(ell)(
                    ell.cols.to(lead), ell.vals.to(lead),
                    ell.row_ids.to(lead), ell.mask.to(lead), ell.n)
            outs.append(self.matcher._match_impl(
                g.to(lead), r_lab.to(lead), seed_ids[rows].to(lead),
                seed_mask[rows].to(lead), ell_i,
                _bank_rows(bank, rows, lead),
                None if row_node is None else row_node[rows].to(lead),
                part=None if part is None else part.to(row),
                graph_axis=axis if graph_sharded else None))
        return GRayResult(*(torch.cat([getattr(o, f).to(home) for o in outs])
                            for f in GRayResult._fields))


class ShardedSweep:
    """The full-graph sweeps over the graph axis.

    The engine drives :meth:`label_table` (the per-step label-RWR hot
    path); :meth:`run_rwr` / :meth:`reach` expose the raw sweeps so the
    bitwise-equivalence tests exercise exactly the production calls. ELL
    mirrors must be the shard-local row blocks (``EllCache(n_shards=…)``);
    COO graphs stay replicated and the partial sums fold in shard order.
    Results come back on the input graph's device.
    """

    def __init__(self, devices: Sequence):
        self.axis = GraphAxis(devices)
        self.g_shards = self.axis.size

    def label_table(self, g: DynamicGraph, n_labels: int, iters: int,
                    c: float, r0: Optional[torch.Tensor], ell,
                    tol: float = 0.0,
                    part: Optional[PartitionedEdges] = None
                    ) -> Tuple[torch.Tensor, int, int]:
        """Sharded :func:`label_rwr` → ``(r_lab, n_sweeps, n_col_skipped)``
        (the sweep count is ``iters`` on the fixed path, measured when
        ``tol > 0``; the skip count is 0 on the fixed path)."""
        if tol > 0:
            return label_rwr_adaptive(g, n_labels, max_iters=iters, tol=tol,
                                      c=c, r0=r0, ell=ell, axis=self.axis,
                                      part=part)
        return (label_rwr(g, n_labels, iters=iters, c=c, r0=r0, ell=ell,
                          axis=self.axis, part=part), iters, 0)

    def run_rwr(self, g: DynamicGraph, e: torch.Tensor, iters: int,
                c: float = 0.15, r0: Optional[torch.Tensor] = None,
                ell=None, tol: float = 0.0,
                part: Optional[PartitionedEdges] = None
                ) -> Tuple[torch.Tensor, int, int]:
        """Sharded :func:`rwr` / :func:`rwr_adaptive` →
        ``(r, n_sweeps, n_col_skipped)``."""
        if tol > 0:
            return rwr_adaptive(g, e, max_iters=iters, tol=tol, c=c, r0=r0,
                                ell=ell, axis=self.axis, part=part)
        return (rwr(g, e, iters=iters, c=c, r0=r0, ell=ell, axis=self.axis,
                    part=part), iters, 0)

    def reach(self, g: DynamicGraph, sources: torch.Tensor, max_hops: int,
              ell=None,
              part: Optional[PartitionedEdges] = None) -> torch.Tensor:
        """Sharded :func:`~repro_torch.core.gray._bfs_reach_hops`."""
        return _bfs_reach_hops(g, sources, max_hops, ell=ell,
                               axis=self.axis, part=part)
