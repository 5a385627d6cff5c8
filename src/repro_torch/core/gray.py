"""G-Ray: best-effort approximate subgraph isomorphism (Tong et al. KDD'07),
batched over a bank of standing queries — the base matcher the paper
extends (§III-A).

The three core functions map onto dense tensor ops:

  seed-finder        → masked top-k over the label-conditioned RWR goodness
  neighbor-expander  → argmax of single-source RWR among label-compatible,
                       unused candidates (k seeds expand in one (n, k) batch)
  bridge             → bounded-hop BFS reachability sweep (hop count of the
                       best connecting path; direct edge ⇒ hop 1 ⇒ exact)

Queries are data: :class:`BankGRayMatcher` takes a stacked
:class:`~repro_torch.core.query.QueryBank` and runs the expansion over a
written-out query axis, while the expensive sparse sweeps (single-source
RWR and the BFS bridge) run as ONE ``(n, P·k)`` dense block shared
across the bank. Two schedules, with equal matches (goodness equal up to
the summation order of sweep blocks of other widths):

- ``memo=True`` (the default): the expansion schedule is host-static, and
  each query computes one table per DISTINCT schedule source — a star-5
  query runs ONE RWR for its four expansions — with every first use at one
  step batched into one shared sweep.
- ``memo=False``: content-independent, the mode the engine drives — table
  slots per sub-pattern DAG node (the bucket's ``row_node`` plan), filled
  lazily, one sweep block per expansion step that meets a node not
  computed yet.

:class:`GRayMatcher` is the single-query view (a bank of one) and
:func:`gray_match` the one-shot batch match.

Both sparse sweeps run on either the COO gather/scatter path or the ELL
kernels — ``backend="ell"`` routes them through
``repro_torch.kernels.spmv_ell`` given an ELL mirror of the graph. Given a
``graph_axis`` (:class:`~repro_torch.core.graph.GraphAxis`) both split over
the graph axis of the engine's device mesh, bitwise as replicated
(:mod:`repro_torch.core.rwr`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import resolve_backend
from repro_torch.core.graph import (DynamicGraph, GraphAxis,
                                    PartitionedEdges, ell_from_graph)
from repro_torch.core.query import Query, QueryBank, stack_queries
from repro_torch.core.rwr import (_owned_mask, label_rwr,
                                  label_rwr_adaptive, restart_onehot, rwr,
                                  rwr_adaptive)
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.sparse.ell import EllGraph

_EPS = 1e-12


class GRayResult(NamedTuple):
    """Single-query: leading axis k (seeds). Bank: leading axes (B, k)."""

    matched: torch.Tensor   # int32[B, k, q_max] — data vertex per query vertex
    goodness: torch.Tensor  # f32[B, k] — Σ log proximity over schedule edges
    hops: torch.Tensor      # int32[B, k, qe_max] — best-path hops per edge
    exact: torch.Tensor     # bool[B, k] — every query edge is a data edge
    valid: torch.Tensor     # bool[B, k] — seed live and all expansions found


def _masked_label_sum(logp: torch.Tensor, rows: Optional[torch.Tensor],
                      q_labels: torch.Tensor,
                      q_mask: torch.Tensor) -> torch.Tensor:
    """Per query b: Σ_q logp[v, label_b(q)]·mask_b(q) over the query
    positions, summed left to right. ``logp`` (n, L); ``q_labels``/
    ``q_mask`` (B, q_max). ``rows`` None scores every vertex → (B, n);
    ``rows`` (B, k) vertex ids scores those → (B, k)."""
    out = None
    for j in range(q_labels.shape[1]):
        lab = q_labels[:, j].to(torch.int64)                  # (B,)
        if rows is None:
            term = logp[:, lab].T                             # (B, n)
        else:
            term = logp[rows, lab[:, None]]                   # (B, k)
        term = term * q_mask[:, j, None]
        out = term if out is None else out + term
    return out


def find_seeds(g: DynamicGraph, query: Query, r_lab: torch.Tensor, k: int,
               seed_filter: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seed-finder for one query: its top-k anchor candidates by
    label-goodness → (ids int32[k], valid bool[k]); the bank's
    :func:`_find_seeds_arrays` with a bank of one."""
    ids, valid = _find_seeds_arrays(g, r_lab, k, seed_filter,
                                    query.labels[None], query.mask[None],
                                    query.anchor.reshape(1))
    return ids[0], valid[0]


def _find_seeds_arrays(g: DynamicGraph, r_lab: torch.Tensor, k: int,
                       seed_filter: Optional[torch.Tensor],
                       q_labels: torch.Tensor, q_mask: torch.Tensor,
                       anchor: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seed-finder for a bank: per query, top-k anchor candidates by
    label-goodness ``Σ_q log r_lab[v, label(q)]`` over live query vertices,
    restricted to vertices with the anchor's label (and the PEM recompute
    mask, when given — the paper's partial-execution hook).

    ``q_labels``/``q_mask`` are (B, q_max), ``anchor`` (B,) → ids int32
    (B, k) and a validity mask (B, k). Ties rank the lower vertex id first
    (a stable descending sort), so when fewer than k candidates are live
    the −inf tail comes out in ascending id order.
    """
    logp = torch.log(r_lab + _EPS)                            # (n, L)
    score = _masked_label_sum(logp, None, q_labels, q_mask)   # (B, n)
    anchor_lab = q_labels.gather(1, anchor.to(torch.int64)[:, None])  # (B,1)
    ok = ((g.labels[None, :] == anchor_lab) & g.node_mask[None, :]
          & (g.degree > 0)[None, :])
    if seed_filter is not None:
        ok = ok & seed_filter[None, :]
    score = torch.where(ok, score, torch.full_like(score, float("-inf")))
    vals, ids = torch.sort(score, dim=1, descending=True, stable=True)
    return ids[:, :k].to(torch.int32), torch.isfinite(vals[:, :k])


def _scatter_max(msg: torch.Tensor, idx: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Per segment, the max of ``msg`` over the rows ``idx`` sends there;
    -inf for a segment that gets no row."""
    agg = torch.full((n, msg.shape[1]), float("-inf"), dtype=msg.dtype,
                     device=msg.device)
    return agg.scatter_reduce_(0, idx[:, None].expand_as(msg), msg,
                               reduce="amax", include_self=True)


def _bfs_reach_hops(g: DynamicGraph, sources: torch.Tensor, max_hops: int,
                    ell=None, axis: Optional[GraphAxis] = None,
                    part: Optional[PartitionedEdges] = None) -> torch.Tensor:
    """hops[k_idx, v] = min #edges from sources[k_idx] to v (≤ max_hops),
    else max_hops+1. Batched bounded BFS — the bridge function's path-length
    oracle. The frontier sweep is either an edge-gather/scatter-max (COO) or
    the reach kernel on the ELL layout; both propagate exact 0/1
    indicators, so the backends are bit-identical.

    ``axis`` splits the frontier sweep over the graph axis: COO zeroes the
    messages to other shards' slices and folds the shards' maxima in shard
    order, ELL runs the kernel on each shard's row block and concatenates
    the slices. Max is exact and the non-owners' zeros are absorbed by the
    ``maximum`` against the current frontier, so the split sweep is
    bit-identical too. ``part`` (partitioned storage, needs ``axis``)
    sweeps each shard's receiver-sliced arcs into its local segments
    instead of the replicated arrays; a vertex with no slot gets the
    identity -inf in either layout, which the ``maximum`` absorbs."""
    n = g.n_max
    home = sources.device
    reached = restart_onehot(sources, n)                      # (n, k)
    hops = torch.where(reached.T > 0, 0, max_hops + 1).to(torch.int32)

    if part is not None:
        assert axis is not None, "partitioned sweeps need a graph axis"
        slices = [(s.to(torch.int64), rl.to(torch.int64),
                   m.to(torch.float32)[:, None])
                  for s, rl, m in zip(part.senders, part.receivers_loc,
                                      part.mask)]

        def sweep(reached):
            return axis.gather(
                [_scatter_max(r_d[s] * live, rl, part.n_loc)
                 for (s, rl, live), r_d in zip(slices,
                                               axis.broadcast(reached))],
                home)
    elif ell is None:
        snd = g.senders.to(torch.int64)
        rcv = g.receivers.to(torch.int64)
        live = g.edge_mask.to(torch.float32)[:, None]
        if axis is None:
            def sweep(reached):
                return _scatter_max(reached[snd] * live, rcv, n)
        else:
            shards = [(snd.to(dv), rcv.to(dv), live.to(dv),
                       _owned_mask(rcv, n, d, axis).to(dv))
                      for d, dv in enumerate(axis.devices)]

            def sweep(reached):
                return axis.reduce(
                    [_scatter_max(torch.where(own[:, None], r_d[s] * lv,
                                              0.0), r, n)
                     for (s, r, lv, own), r_d in zip(
                         shards, axis.broadcast(reached))], home, "max")
    elif axis is None:
        index = ell.row_index()

        def sweep(reached):
            return ell_ops.ell_reach(ell.cols, ell.mask, ell.row_ids,
                                     reached, ell.n, index=index)
    else:
        blocks = ell.to(axis.devices).blocks

        def sweep(reached):
            return axis.gather(
                [ell_ops.ell_reach(b.cols, b.mask, b.row_ids, r_d, b.n,
                                   index=b.row_index())
                 for b, r_d in zip(blocks, axis.broadcast(reached))], home)

    for h in range(1, max_hops + 1):
        nxt = torch.maximum(sweep(reached), reached)
        newly = (nxt > 0) & (reached <= 0)
        hops = torch.where(newly.T, h, hops).to(torch.int32)
        reached = nxt
    return hops  # (k, n)


class BankGRayMatcher:
    """G-Ray over a stacked bank of standing queries.

    Every per-step single-source sweep (RWR + bounded BFS) runs as one
    dense block shared by the bank.

    ``memo=True`` fixes the schedule from ``bank`` at construction: the
    expansion unrolls to the longest schedule in the bank, and each
    (query, distinct source vertex) pair owns one table slot, computed at
    the step that first reads it. Sound because ``matched`` is write-once
    and BFS order matches a source before its first use; padded tail steps
    of shorter queries read slot 0 and mask the result out.

    ``memo=False`` is content-independent: the expansion walks all
    ``qe_max`` steps of the bank's padded shape; table slots exist per
    sub-pattern DAG node (``node_cap`` of them plus a trash slot), "node
    computed" is data, and a step runs its sweep block only when some row
    reads a node not computed yet. Callers pass the bucket's ``row_node``
    plan; without one the identity plan (node ≡ (row, query vertex))
    applies. Matches equal the memoized mode's.

    ``backend="ell"`` runs both sparse sweeps through the ELL kernels;
    callers pass the graph's ELL mirror via ``ell=`` (one is built on the
    fly when omitted).
    """

    def __init__(self, bank: QueryBank, n_labels: int, k: int,
                 rwr_iters: int = 25, restart: float = 0.15,
                 bridge_hops: int = 4, backend: str = "coo",
                 ell_width: int = 64, memo: bool = True,
                 rwr_tol: float = 0.0, node_cap: Optional[int] = None,
                 device="cuda"):
        backend = resolve_backend(backend, device)
        if backend not in ("coo", "ell"):
            raise ValueError(f"unknown backend {backend!r}")
        self.bank = bank
        self.n_labels = n_labels
        self.k = k
        self.rwr_iters = rwr_iters
        self.restart = restart
        self.bridge_hops = bridge_hops
        self.backend = backend
        self.ell_width = ell_width
        self.rwr_tol = rwr_tol
        self.memo = memo
        self.node_cap = node_cap
        if memo:
            self._plan_memo(bank)
        else:
            self.n_steps = bank.qe_max

    def _plan_memo(self, bank: QueryBank) -> None:
        """The host-static schedule: per step, the (row, slot, source
        vertex) pairs first used there, and the slot each row reads."""
        src_np = bank.order_src.cpu().numpy()
        mask_np = bank.order_mask.cpu().numpy()
        B = bank.n_queries
        self.n_steps = int(mask_np.sum(axis=1).max()) if mask_np.size else 0
        pair_of: Tuple[Dict[int, int], ...] = tuple({} for _ in range(B))
        new_pairs = []
        self._read_slot = np.zeros((self.n_steps, B), np.int64)
        for ei in range(self.n_steps):
            fresh = []
            for b in range(B):
                if not mask_np[b, ei]:
                    continue
                sv = int(src_np[b, ei])
                if sv not in pair_of[b]:
                    pair_of[b][sv] = len(pair_of[b])
                    fresh.append((b, pair_of[b][sv], sv))
                self._read_slot[ei, b] = pair_of[b][sv]
            new_pairs.append(tuple(fresh))
        self._new_pairs = tuple(new_pairs)
        self.t_max = max([1] + [len(p) for p in pair_of])

    # -- public API ---------------------------------------------------------

    def _ell_for(self, g: DynamicGraph,
                 ell: Optional[EllGraph]) -> Optional[EllGraph]:
        if self.backend != "ell":
            return None
        if ell is None:
            ell = ell_from_graph(g, self.ell_width)
        return ell

    def label_table(self, g: DynamicGraph,
                    r0: Optional[torch.Tensor] = None,
                    iters: Optional[int] = None,
                    ell: Optional[EllGraph] = None) -> torch.Tensor:
        """Label-conditioned RWR table — query-independent, computed once
        per graph state and shared by every query in the bank. Honors
        ``rwr_tol`` like the expansion sweeps (an explicit ``iters``
        overrides the cap either way)."""
        iters = iters if iters is not None else self.rwr_iters
        ell = self._ell_for(g, ell)
        if self.rwr_tol > 0:
            r, _, _ = label_rwr_adaptive(g, self.n_labels, max_iters=iters,
                                         tol=self.rwr_tol, c=self.restart,
                                         r0=r0, ell=ell)
            return r
        return label_rwr(g, self.n_labels, iters=iters, c=self.restart,
                         r0=r0, ell=ell)

    def seeds(self, g: DynamicGraph, r_lab: torch.Tensor,
              seed_filter: Optional[torch.Tensor] = None,
              bank: Optional[QueryBank] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query top-k anchor candidates (ids (B, k), mask (B, k))."""
        b = bank or self.bank
        dev = r_lab.device
        return _find_seeds_arrays(g, r_lab, self.k, seed_filter,
                                  b.labels.to(dev), b.mask.to(dev),
                                  b.anchor.to(dev))

    def match(self, g: DynamicGraph, r_lab: torch.Tensor,
              seed_filter: Optional[torch.Tensor] = None,
              ell: Optional[EllGraph] = None,
              bank: Optional[QueryBank] = None) -> GRayResult:
        ell = self._ell_for(g, ell)
        seed_ids, seed_mask = self.seeds(g, r_lab, seed_filter, bank=bank)
        return self.match_from_seeds(g, r_lab, seed_ids, seed_mask, ell=ell,
                                     bank=bank)

    def match_from_seeds(self, g: DynamicGraph, r_lab: torch.Tensor,
                         seed_ids: torch.Tensor, seed_mask: torch.Tensor,
                         ell: Optional[EllGraph] = None,
                         bank: Optional[QueryBank] = None,
                         row_node: Optional[torch.Tensor] = None
                         ) -> GRayResult:
        b = bank or self.bank
        return self._match_impl(g, r_lab, seed_ids, seed_mask,
                                self._ell_for(g, ell), b, row_node)

    # -- implementation ------------------------------------------------------

    def _rwr(self, g: DynamicGraph, e: torch.Tensor, ell,
             graph_axis: Optional[GraphAxis] = None,
             part: Optional[PartitionedEdges] = None) -> torch.Tensor:
        """One shared expansion sweep block — fixed-count or residual-
        adaptive per ``rwr_tol`` (the hard cap is ``rwr_iters`` either
        way)."""
        if self.rwr_tol > 0:
            r, _, _ = rwr_adaptive(g, e, max_iters=self.rwr_iters,
                                   tol=self.rwr_tol, c=self.restart, ell=ell,
                                   axis=graph_axis, part=part)
            return r
        return rwr(g, e, iters=self.rwr_iters, c=self.restart, ell=ell,
                   axis=graph_axis, part=part)

    def _match_impl(self, g: DynamicGraph, r_lab: torch.Tensor,
                    seed_ids: torch.Tensor, seed_mask: torch.Tensor,
                    ell, bank: QueryBank, row_node: Optional[torch.Tensor],
                    part: Optional[PartitionedEdges] = None,
                    graph_axis: Optional[GraphAxis] = None) -> GRayResult:
        """The bank expansion on ``r_lab``'s device. ``graph_axis`` splits
        its sweeps over the graph axis, ``ell`` then being the shard-local
        row blocks and ``part`` (partitioned storage) replacing the graph's
        edge tensors, which are not read."""
        dev = r_lab.device
        B, k = seed_ids.shape
        n = g.n_max
        q_labels = bank.labels.to(dev)
        q_mask = bank.mask.to(dev)
        anchor = bank.anchor.to(dev).to(torch.int64)
        order_src = bank.order_src.to(dev).to(torch.int64)
        order_dst = bank.order_dst.to(dev).to(torch.int64)
        order_tree = bank.order_tree.to(dev)
        order_mask = bank.order_mask.to(dev)
        q_max = q_labels.shape[1]
        qe_max = order_src.shape[1]
        logp = torch.log(r_lab + _EPS)
        rows_b = torch.arange(B, device=dev)
        cols_k = torch.arange(k, device=dev)
        sq = seed_ids.to(torch.int64)                             # (B, k)

        matched = torch.full((B, k, q_max), -1, dtype=torch.int32,
                             device=dev)
        matched[rows_b[:, None], cols_k[None, :], anchor[:, None]] = (
            seed_ids.to(torch.int32))
        used = torch.zeros((B, k, n), dtype=torch.bool, device=dev)
        used[rows_b[:, None], cols_k[None, :], sq] = True
        # seed goodness (same quantity the seed-finder ranked by)
        goodness = _masked_label_sum(logp, sq, q_labels, q_mask)  # (B, k)
        hops = torch.zeros((B, k, qe_max), dtype=torch.int32, device=dev)
        valid = seed_mask.clone()

        if self.memo:
            # per-(query, source) tables; the first uses of one step batch
            # into ONE shared (n, P·k) RWR + reach sweep
            tables_r = torch.zeros((B, self.t_max, n, k),
                                   dtype=torch.float32, device=dev)
            tables_h = torch.zeros((B, self.t_max, k, n), dtype=torch.int32,
                                   device=dev)
        else:
            if row_node is None:
                n_slots = B * q_max
                row_node = rows_b[:, None] * q_max + order_src
            else:
                assert self.node_cap is not None, \
                    "row_node plans need a node_cap-sized matcher"
                n_slots = int(self.node_cap)
                row_node = row_node.to(dev).to(torch.int64)
            n_sweep = min(B, n_slots)
            tables_r = torch.zeros((n_slots + 1, n, k), dtype=torch.float32,
                                   device=dev)
            tables_h = torch.zeros((n_slots + 1, k, n), dtype=torch.int32,
                                   device=dev)
            node_seen = torch.zeros(n_slots + 1, dtype=torch.int32,
                                    device=dev)
        ninf = torch.tensor(float("-inf"), device=dev)

        def sweep_block(srcs: torch.Tensor):
            """RWR and BFS tables of the (P, k) sources: (P, n, k), (P, k, n)."""
            p = srcs.shape[0]
            flat = srcs.reshape(p * k)
            e = restart_onehot(flat, n)                            # (n, P·k)
            r_new = self._rwr(g, e, ell, graph_axis, part).reshape(
                n, p, k).permute(1, 0, 2)
            h_new = _bfs_reach_hops(g, flat, self.bridge_hops, ell=ell,
                                    axis=graph_axis,
                                    part=part).reshape(p, k, n)
            return r_new, h_new

        for ei in range(self.n_steps):
            on = order_mask[:, ei]                                 # (B,)
            if self.memo:
                pairs = self._new_pairs[ei]
                if pairs:
                    b_idx, t_idx, s_idx = (
                        torch.tensor(col, dtype=torch.int64, device=dev)
                        for col in zip(*pairs))
                    r_new, h_new = sweep_block(matched[b_idx, :, s_idx])
                    tables_r[b_idx, t_idx] = r_new
                    tables_h[b_idx, t_idx] = h_new
                slot = torch.as_tensor(self._read_slot[ei], device=dev)
                r_t = tables_r[rows_b, slot]                       # (B, n, k)
                reach_t = tables_h[rows_b, slot]                   # (B, k, n)
            else:
                # content-independent memo over DAG nodes: "node computed"
                # is data; the step's shared sweep block runs only when
                # some row reads a node not computed yet. One
                # representative row (the lowest) per fresh node computes
                # its tables for the bank.
                nd = torch.where(on, row_node[:, ei],
                                 torch.full_like(row_node[:, ei], n_slots))
                fresh = on & (node_seen[nd] == 0)
                rep = torch.full((n_slots + 1,), B, dtype=torch.int64,
                                 device=dev)
                rep.scatter_reduce_(
                    0, torch.where(fresh, nd, torch.full_like(nd, n_slots)),
                    rows_b, reduce="amin", include_self=True)
                if bool(fresh.any()):
                    sel = torch.nonzero(rep[:n_slots] < B).flatten()
                    idx = torch.full((n_sweep,), n_slots, dtype=torch.int64,
                                     device=dev)
                    idx[:sel.shape[0]] = sel[:n_sweep]
                    rows = torch.clamp(rep[idx], 0, B - 1)        # (n_sweep,)
                    srcv = order_src[rows, ei]                    # (n_sweep,)
                    r_new, h_new = sweep_block(
                        matched[rows[:, None], cols_k[None, :],
                                srcv[:, None]])                   # (n_sweep, k)
                    # packing fill (idx == n_slots) lands in the trash
                    # slot, which only masked reads ever see
                    tables_r[idx] = r_new
                    tables_h[idx] = h_new
                node_seen.scatter_reduce_(0, nd, on.to(torch.int32),
                                          reduce="amax", include_self=True)
                r_t = tables_r[nd]                              # (B, n, k)
                reach_t = tables_h[nd]                          # (B, k, n)

            # neighbor-expander: best label-compatible unused candidate
            qb = order_dst[:, ei]                                  # (B,)
            tr = order_tree[:, ei]
            lab_qb = q_labels[rows_b, qb]                          # (B,)
            cand_ok = ((g.labels[None, None, :] == lab_qb[:, None, None])
                       & g.node_mask[None, None, :] & ~used)       # (B, k, n)
            score = torch.where(cand_ok, r_t.transpose(1, 2), ninf)
            best = torch.argmax(score, dim=2)                      # (B, k)
            found = torch.isfinite(score.amax(dim=2))
            del score, cand_ok
            m_tree = torch.where(found, best, -1)
            m_non = matched[rows_b, :, qb].to(torch.int64)         # (B, k)
            write = (tr & on)[:, None]                             # (B, 1)
            matched[rows_b, :, qb] = torch.where(
                write, m_tree, m_non).to(torch.int32)
            hit = used[rows_b[:, None], cols_k[None, :], best]
            used[rows_b[:, None], cols_k[None, :], best] = hit | (found & write)
            prox_tree = r_t[rows_b[:, None], best, cols_k[None, :]]
            prox_non = r_t[rows_b[:, None], torch.clamp(m_non, 0, n - 1),
                           cols_k[None, :]]
            zero = torch.zeros_like(prox_tree)
            delta = torch.where(
                tr[:, None],
                torch.where(found, torch.log(prox_tree + _EPS), zero),
                torch.log(prox_non + _EPS))
            goodness = goodness + torch.where(on[:, None], delta, zero)
            valid = valid & torch.where(write, found, True)
            # bridge: hop count of best path (1 ⇒ exact edge)
            m_b = torch.where(tr[:, None], m_tree, m_non)
            h = reach_t[rows_b[:, None], cols_k[None, :],
                        torch.clamp(m_b, 0, n - 1)]
            hops[:, :, ei] = torch.where(on[:, None], h, hops[:, :, ei])
            del r_t, reach_t

        em = order_mask[:, None, :]                             # (B, 1, qe)
        exact = torch.where(em, hops == 1, True).all(dim=2)
        reachable = torch.where(em, hops <= self.bridge_hops, True).all(dim=2)
        valid = valid & reachable
        return GRayResult(matched, goodness, hops, exact & valid, valid)


class GRayMatcher:
    """G-Ray for one query shape — a bank of size one (``memo=True``).

    All the matching machinery lives in :class:`BankGRayMatcher`, so
    single-query and bank-mode results are equal by construction.
    """

    def __init__(self, query: Query, n_labels: int, k: int,
                 rwr_iters: int = 25, restart: float = 0.15,
                 bridge_hops: int = 4, backend: str = "coo",
                 ell_width: int = 64, rwr_tol: float = 0.0, device="cuda"):
        self.query = query
        self.n_labels = n_labels
        self.k = k
        self.rwr_iters = rwr_iters
        self.restart = restart
        self.bridge_hops = bridge_hops
        self.backend = resolve_backend(backend, device)
        self.ell_width = ell_width
        # host-static expansion schedule (introspection + tests)
        cols = (query.order_src, query.order_dst, query.order_tree,
                query.order_mask)
        self.schedule: Tuple[Tuple[int, int, bool], ...] = tuple(
            (int(a), int(b), bool(t))
            for a, b, t, m in zip(*(c.cpu().numpy() for c in cols)) if m)
        self._bank = BankGRayMatcher(
            stack_queries([query], q_max=query.q_max,
                          qe_max=int(query.order_src.shape[0])),
            n_labels, k, rwr_iters=rwr_iters, restart=restart,
            bridge_hops=bridge_hops, backend=self.backend,
            ell_width=ell_width, rwr_tol=rwr_tol, device=device)

    def label_table(self, g: DynamicGraph,
                    r0: Optional[torch.Tensor] = None,
                    iters: Optional[int] = None,
                    ell: Optional[EllGraph] = None) -> torch.Tensor:
        return self._bank.label_table(g, r0=r0, iters=iters, ell=ell)

    def match(self, g: DynamicGraph, r_lab: torch.Tensor,
              seed_filter: Optional[torch.Tensor] = None,
              ell: Optional[EllGraph] = None) -> GRayResult:
        return GRayResult(*(x[0] for x in self._bank.match(
            g, r_lab, seed_filter=seed_filter, ell=ell)))

    def match_from_seeds(self, g: DynamicGraph, r_lab: torch.Tensor,
                         seed_ids: torch.Tensor, seed_mask: torch.Tensor,
                         ell: Optional[EllGraph] = None) -> GRayResult:
        return GRayResult(*(x[0] for x in self._bank.match_from_seeds(
            g, r_lab, seed_ids[None], seed_mask[None], ell=ell)))


def gray_match(g: DynamicGraph, query: Query, n_labels: int, k: int = 20,
               rwr_iters: int = 25, restart: float = 0.15,
               bridge_hops: int = 4,
               seed_filter: Optional[torch.Tensor] = None,
               r_lab: Optional[torch.Tensor] = None,
               backend: str = "coo",
               ell: Optional[EllGraph] = None) -> GRayResult:
    """One-shot batch G-Ray on the graph's device (builds a matcher; prefer
    :class:`GRayMatcher` in loops)."""
    m = GRayMatcher(query, n_labels, k, rwr_iters, restart, bridge_hops,
                    backend=backend, device=g.device)
    if m.backend == "ell" and ell is None:
        ell = ell_from_graph(g, m.ell_width)
    if r_lab is None:
        r_lab = m.label_table(g, ell=ell)
    return m.match(g, r_lab, seed_filter=seed_filter, ell=ell)
