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
RWR and the BFS bridge) run as ONE ``(n, n_sweep·k)`` dense block shared
across the bank. The port carries the content-independent ``memo=False``
schedule with a sub-pattern ``row_node`` plan, which is the mode the engine
drives: table slots per DAG node, filled lazily, one sweep block per
expansion step that meets a node not computed yet.

Both sparse sweeps run on either the COO gather/scatter path or the ELL
kernels — ``backend="ell"`` routes them through
``repro_torch.kernels.spmv_ell`` given an ELL mirror of the graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config.base import resolve_backend
from repro_torch.core.graph import DynamicGraph, ell_from_graph
from repro_torch.core.query import QueryBank
from repro_torch.core.rwr import restart_onehot, rwr, rwr_adaptive
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.sparse.ell import EllGraph

_EPS = 1e-12


class GRayResult(NamedTuple):
    """Bank results, leading axes (B, k)."""

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


def _bfs_reach_hops(g: DynamicGraph, sources: torch.Tensor, max_hops: int,
                    ell: Optional[EllGraph] = None) -> torch.Tensor:
    """hops[k_idx, v] = min #edges from sources[k_idx] to v (≤ max_hops),
    else max_hops+1. Batched bounded BFS — the bridge function's path-length
    oracle. The frontier sweep is either an edge-gather/scatter-max (COO) or
    the reach kernel on the ELL layout; both propagate exact 0/1
    indicators, so the backends are bit-identical."""
    n = g.n_max
    reached = restart_onehot(sources, n)                      # (n, k)
    hops = torch.where(reached.T > 0, 0, max_hops + 1).to(torch.int32)

    if ell is None:
        snd = g.senders.to(torch.int64)
        rcv = g.receivers.to(torch.int64)
        live = g.edge_mask.to(torch.float32)[:, None]

        def sweep(reached):
            msg = reached[snd] * live                         # (E, k)
            agg = torch.full_like(reached, float("-inf"))
            return agg.scatter_reduce_(
                0, rcv[:, None].expand_as(msg), msg, reduce="amax",
                include_self=True)
    else:
        index = ell.row_index()

        def sweep(reached):
            return ell_ops.ell_reach(ell.cols, ell.mask, ell.row_ids,
                                     reached, ell.n, index=index)

    for h in range(1, max_hops + 1):
        nxt = torch.maximum(sweep(reached), reached)
        newly = (nxt > 0) & (reached <= 0)
        hops = torch.where(newly.T, h, hops).to(torch.int32)
        reached = nxt
    return hops  # (k, n)


class BankGRayMatcher:
    """G-Ray over a stacked bank of standing queries (``memo=False``).

    Every per-step single-source sweep (RWR + bounded BFS) runs as one
    ``(n, n_sweep·k)`` dense block shared by the bank. The schedule is
    content-independent: the expansion walks all ``qe_max`` steps of the
    bank's padded shape; table slots exist per sub-pattern DAG node
    (``node_cap`` of them plus a trash slot), "node computed" is data, and a
    step runs its sweep block only when some row reads a node not computed
    yet. Callers pass the bucket's ``row_node`` plan; without one the
    identity plan (node ≡ (row, query vertex)) applies.

    ``backend="ell"`` runs both sparse sweeps through the ELL kernels;
    callers pass the graph's ELL mirror via ``ell=`` (one is built on the
    fly when omitted). The memoized host-static schedule (``memo=True``)
    is not ported.
    """

    def __init__(self, bank: QueryBank, n_labels: int, k: int,
                 rwr_iters: int = 25, restart: float = 0.15,
                 bridge_hops: int = 4, backend: str = "coo",
                 ell_width: int = 64, memo: bool = False,
                 rwr_tol: float = 0.0, node_cap: Optional[int] = None,
                 device="cuda"):
        if memo:
            raise NotImplementedError(
                "memo=True (the host-static memoized schedule) is not ported "
                "yet — see ROADMAP.md queue 1, 'Queries and the G-Ray bank'")
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
        self.n_steps = bank.qe_max
        self.node_cap = node_cap

    # -- public API ---------------------------------------------------------

    def _ell_for(self, g: DynamicGraph,
                 ell: Optional[EllGraph]) -> Optional[EllGraph]:
        if self.backend != "ell":
            return None
        if ell is None:
            ell = ell_from_graph(g, self.ell_width)
        return ell

    def seeds(self, g: DynamicGraph, r_lab: torch.Tensor,
              seed_filter: Optional[torch.Tensor] = None,
              bank: Optional[QueryBank] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query top-k anchor candidates (ids (B, k), mask (B, k))."""
        b = bank or self.bank
        return _find_seeds_arrays(g, r_lab, self.k, seed_filter, b.labels,
                                  b.mask, b.anchor)

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

    def _rwr(self, g: DynamicGraph, e: torch.Tensor,
             ell: Optional[EllGraph]) -> torch.Tensor:
        """One shared expansion sweep block — fixed-count or residual-
        adaptive per ``rwr_tol`` (the hard cap is ``rwr_iters`` either
        way)."""
        if self.rwr_tol > 0:
            r, _, _ = rwr_adaptive(g, e, max_iters=self.rwr_iters,
                                   tol=self.rwr_tol, c=self.restart, ell=ell)
            return r
        return rwr(g, e, iters=self.rwr_iters, c=self.restart, ell=ell)

    def _match_impl(self, g: DynamicGraph, r_lab: torch.Tensor,
                    seed_ids: torch.Tensor, seed_mask: torch.Tensor,
                    ell: Optional[EllGraph], bank: QueryBank,
                    row_node: Optional[torch.Tensor]) -> GRayResult:
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
        node_seen = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
        ninf = torch.tensor(float("-inf"), device=dev)

        for ei in range(self.n_steps):
            # content-independent memo over DAG nodes: "node computed" is
            # data; the step's shared sweep block runs only when some row
            # reads a node not computed yet. One representative row (the
            # lowest) per fresh node computes its tables for the bank.
            on = order_mask[:, ei]                                 # (B,)
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
                rows = torch.clamp(rep[idx], 0, B - 1)             # (n_sweep,)
                srcv = order_src[rows, ei]                         # (n_sweep,)
                srcs = matched[rows[:, None], cols_k[None, :],
                               srcv[:, None]]                      # (n_sweep, k)
                flat = srcs.reshape(n_sweep * k)
                e = restart_onehot(flat, n)                   # (n, n_sweep·k)
                r_new = self._rwr(g, e, ell)
                r_new = r_new.reshape(n, n_sweep, k).permute(1, 0, 2)
                h_new = _bfs_reach_hops(g, flat, self.bridge_hops,
                                        ell=ell).reshape(n_sweep, k, n)
                # packing fill (idx == n_slots) lands in the trash slot,
                # which only masked reads ever see
                tables_r[idx] = r_new
                tables_h[idx] = h_new
            node_seen.scatter_reduce_(0, nd, on.to(torch.int32),
                                      reduce="amax", include_self=True)
            r_t = tables_r[nd]                                  # (B, n, k)
            reach_t = tables_h[nd]                              # (B, k, n)

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
