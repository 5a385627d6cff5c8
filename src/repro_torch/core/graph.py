"""Dynamic attributed graph with static shapes (single device).

The paper's input is a stream of timestamped updates over an attributed
graph: edge additions, edge removals, vertex label changes (§III-B). We keep
preallocated COO buffers (capacity ``e_max``) + masks so every update and
every RWR sweep works on fixed-shape tensors; the edge cursor and the
degree vector are maintained incrementally.

Graphs are stored *directed*; undirected inputs insert both arcs. All
tensors live on one device, chosen when the graph is built; constructors take
numpy. Updates return new :class:`DynamicGraph` tuples and never write into
the tensors of their input, so an earlier graph stays valid.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.sparse.ell import (EllGraph, build_ell, ell_block_capacity,
                                    ell_row_capacity)


def to_numpy(a) -> np.ndarray:
    """Host copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_device(device) -> torch.device:
    """The device an entry point was asked to run on. A CUDA device with no
    card raises here: the port never falls back to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            "— pass device='cpu' to run the plain versions")
    return dev


class DynamicGraph(NamedTuple):
    senders: torch.Tensor    # int32[e_max]
    receivers: torch.Tensor  # int32[e_max]
    edge_mask: torch.Tensor  # bool[e_max]
    labels: torch.Tensor     # int32[n_max]
    node_mask: torch.Tensor  # bool[n_max]
    degree: torch.Tensor     # f32[n_max]  (out-degree over live edges)
    n_edges: torch.Tensor    # int32 scalar — edge cursor (monotone)

    @property
    def n_max(self) -> int:
        return self.labels.shape[0]

    @property
    def e_max(self) -> int:
        return self.senders.shape[0]

    @property
    def device(self) -> torch.device:
        return self.labels.device


class UpdateBatch(NamedTuple):
    """One timestep of graph updates, padded to static widths.

    add_*:   endpoints of added arcs (u_max wide, masked)
    rem_*:   endpoints of removed arcs
    lab_ids/lab_vals: vertex label changes
    """

    add_src: torch.Tensor
    add_dst: torch.Tensor
    add_mask: torch.Tensor
    rem_src: torch.Tensor
    rem_dst: torch.Tensor
    rem_mask: torch.Tensor
    lab_ids: torch.Tensor
    lab_vals: torch.Tensor
    lab_mask: torch.Tensor

    @staticmethod
    def empty(u_max: int, device="cuda") -> "UpdateBatch":
        z = torch.zeros((u_max,), dtype=torch.int32, device=device)
        f = torch.zeros((u_max,), dtype=torch.bool, device=device)
        return UpdateBatch(z, z, f, z, z, f, z, z, f)

    @staticmethod
    def additions(src: np.ndarray, dst: np.ndarray, u_max: int,
                  undirected: bool = True, device="cuda") -> "UpdateBatch":
        """Host helper: pack an edge-addition batch (optionally both arcs)."""
        return UpdateBatch.mixed(add_src=src, add_dst=dst, u_max=u_max,
                                 undirected=undirected, device=device)

    @staticmethod
    def removals(src: np.ndarray, dst: np.ndarray, u_max: int,
                 undirected: bool = True, device="cuda") -> "UpdateBatch":
        """Host helper: pack an edge-removal batch (optionally both arcs)."""
        return UpdateBatch.mixed(rem_src=src, rem_dst=dst, u_max=u_max,
                                 undirected=undirected, device=device)

    @staticmethod
    def mixed(add_src: Optional[np.ndarray] = None,
              add_dst: Optional[np.ndarray] = None,
              rem_src: Optional[np.ndarray] = None,
              rem_dst: Optional[np.ndarray] = None,
              lab_ids: Optional[np.ndarray] = None,
              lab_vals: Optional[np.ndarray] = None,
              u_max: int = 512, undirected: bool = True,
              device="cuda") -> "UpdateBatch":
        """Host helper: one timestep mixing additions, removals, and label
        changes. ``undirected`` inserts/removes both arcs of every edge.
        Each lane (add/remove/label) is padded to ``u_max`` independently,
        mirroring the field layout :func:`apply_update` consumes.
        """
        dev = torch.device(device)

        def _arcs(s, d):
            if s is None:
                return np.zeros(0, np.int32), np.zeros(0, np.int32)
            s = np.asarray(s, np.int32)
            d = np.asarray(d, np.int32)
            if undirected:
                s, d = np.concatenate([s, d]), np.concatenate([d, s])
            return s, d

        def _pack(a: np.ndarray) -> torch.Tensor:
            if len(a) > u_max:
                raise ValueError(
                    f"update batch {len(a)} exceeds u_max {u_max}")
            return torch.as_tensor(np.pad(a, (0, u_max - len(a))),
                                   device=dev)

        def _lanes(n: int) -> torch.Tensor:
            return torch.as_tensor(np.arange(u_max) < n, device=dev)

        a_s, a_d = _arcs(add_src, add_dst)
        r_s, r_d = _arcs(rem_src, rem_dst)
        l_i = (np.zeros(0, np.int32) if lab_ids is None
               else np.asarray(lab_ids, np.int32))
        l_v = (np.zeros(0, np.int32) if lab_vals is None
               else np.asarray(lab_vals, np.int32))
        return UpdateBatch(
            add_src=_pack(a_s), add_dst=_pack(a_d), add_mask=_lanes(len(a_s)),
            rem_src=_pack(r_s), rem_dst=_pack(r_d), rem_mask=_lanes(len(r_s)),
            lab_ids=_pack(l_i), lab_vals=_pack(l_v), lab_mask=_lanes(len(l_i)),
        )


def new_graph(n_max: int, e_max: int, labels: Optional[np.ndarray] = None,
              senders: Optional[np.ndarray] = None,
              receivers: Optional[np.ndarray] = None,
              n_nodes: Optional[int] = None, device="cuda") -> DynamicGraph:
    """Allocate a graph with capacity (n_max, e_max), optionally pre-filled."""
    lab = np.zeros(n_max, np.int32)
    nm = np.zeros(n_max, bool)
    if labels is not None:
        lab[: len(labels)] = labels
        nm[: len(labels)] = True
    elif n_nodes is not None:
        nm[:n_nodes] = True
    s = np.zeros(e_max, np.int32)
    r = np.zeros(e_max, np.int32)
    em = np.zeros(e_max, bool)
    ne = 0
    if senders is not None:
        assert receivers is not None
        ne = len(senders)
        if ne > e_max:
            raise ValueError(f"{ne} initial edges exceed e_max {e_max}")
        s[:ne] = senders
        r[:ne] = receivers
        em[:ne] = True
    deg = np.zeros(n_max, np.float32)
    if ne:
        np.add.at(deg, s[:ne], 1.0)
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return DynamicGraph(t(s), t(r), t(em), t(lab), t(nm), t(deg),
                        torch.tensor(ne, dtype=torch.int32, device=dev))


def add_edges(g: DynamicGraph, src: torch.Tensor, dst: torch.Tensor,
              mask: torch.Tensor) -> DynamicGraph:
    """Append the masked arc batch at the cursor; arcs past ``e_max`` are
    dropped while the cursor still advances by popcount(mask)."""
    k = mask.to(torch.int32)
    # pack live entries contiguously so the cursor advances by popcount(mask)
    pos = torch.cumsum(k, 0, dtype=torch.int32) - k
    slots = (g.n_edges + pos).to(torch.int64)
    keep = mask & (slots < g.e_max)
    sl = slots[keep]
    senders = g.senders.clone()
    receivers = g.receivers.clone()
    edge_mask = g.edge_mask.clone()
    senders[sl] = src[keep]
    receivers[sl] = dst[keep]
    edge_mask[sl] = True
    s_live = src[mask].to(torch.int64)
    d_live = dst[mask].to(torch.int64)
    s_in = s_live[s_live < g.n_max]
    d_in = d_live[d_live < g.n_max]
    deg = g.degree.index_add(0, s_in, torch.ones_like(s_in, dtype=g.degree.dtype))
    node_mask = g.node_mask.clone()
    node_mask[s_in] = True
    node_mask[d_in] = True
    return g._replace(senders=senders, receivers=receivers,
                      edge_mask=edge_mask, degree=deg, node_mask=node_mask,
                      n_edges=g.n_edges + k.sum(dtype=torch.int32))


def remove_edges(g: DynamicGraph, src: torch.Tensor, dst: torch.Tensor,
                 mask: torch.Tensor) -> DynamicGraph:
    """Remove arcs by endpoint match — each masked request kills one live
    copy, earliest slots first; duplicate requests consume duplicate
    copies; requests with no live match are no-ops.

    Sort + searchsorted over int64 arc keys ``sender·n_max + receiver``
    (exact at every ``n_max``): count the requests per key, rank each live
    arc among the live arcs with its key (stable → slot order), and kill
    the arcs whose rank is below the request count. That removes, per key,
    the first ``count`` live copies — exactly what a sequential
    first-match loop over the requests produces.
    """
    if not bool(mask.any()):
        return g
    n = g.n_max
    key_e = g.senders.to(torch.int64) * n + g.receivers.to(torch.int64)
    key_u = src.to(torch.int64) * n + dst.to(torch.int64)
    sent = torch.iinfo(torch.int64).max
    ku = torch.sort(torch.where(mask, key_u, sent)).values
    cnt = (torch.searchsorted(ku, key_e, right=True)
           - torch.searchsorted(ku, key_e, right=False))
    ke = torch.where(g.edge_mask, key_e, sent)
    order = torch.sort(ke, stable=True).indices
    ke_sorted = ke[order]
    rank_sorted = (torch.arange(g.e_max, device=ke.device)
                   - torch.searchsorted(ke_sorted, ke_sorted, right=False))
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    kill = g.edge_mask & (rank < cnt)
    killed = g.senders[kill].to(torch.int64)
    deg = g.degree.index_add(
        0, killed, torch.full_like(killed, -1.0, dtype=g.degree.dtype))
    return g._replace(edge_mask=g.edge_mask & ~kill, degree=deg)


def set_labels(g: DynamicGraph, ids: torch.Tensor, vals: torch.Tensor,
               mask: torch.Tensor) -> DynamicGraph:
    keep = mask & (ids.to(torch.int64) < g.n_max)
    labels = g.labels.clone()
    labels[ids[keep].to(torch.int64)] = vals[keep]
    return g._replace(labels=labels)


def apply_update(g: DynamicGraph, upd: UpdateBatch) -> DynamicGraph:
    g = add_edges(g, upd.add_src, upd.add_dst, upd.add_mask)
    g = remove_edges(g, upd.rem_src, upd.rem_dst, upd.rem_mask)
    g = set_labels(g, upd.lab_ids, upd.lab_vals, upd.lab_mask)
    return g


def updated_vertices(g: DynamicGraph, upd: UpdateBatch,
                     v_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """V_l of the paper: endpoints of updated arcs + relabelled vertices.

    Returns (ids int32[v_max], mask bool[v_max]) — duplicates permitted
    (consumers operate on the implied boolean vertex mask).
    """
    ids = torch.cat([upd.add_src, upd.add_dst, upd.rem_src, upd.rem_dst,
                     upd.lab_ids])
    mk = torch.cat([upd.add_mask, upd.add_mask, upd.rem_mask, upd.rem_mask,
                    upd.lab_mask])
    if ids.shape[0] > v_max:
        raise ValueError(f"v_max {v_max} < update width {ids.shape[0]}")
    pad = v_max - ids.shape[0]
    return (torch.nn.functional.pad(ids, (0, pad)),
            torch.nn.functional.pad(mk, (0, pad)))


def transition_weights(g: DynamicGraph) -> torch.Tensor:
    """Per-arc random-walk weight 1/deg(sender), 0 for dead arcs."""
    safe = torch.clamp(g.degree, min=1.0)
    w = 1.0 / safe[g.senders.to(torch.int64)]
    return torch.where(g.edge_mask, w, torch.zeros_like(w))


# ---------------------------------------------------------------------------
# ELL mirror of the live edge set (the matching hot path's layout)
# ---------------------------------------------------------------------------

def ell_from_graph(g: DynamicGraph, k: int,
                   r_cap: Optional[int] = None) -> EllGraph:
    """Fresh *incoming*-adjacency ELL of the live arcs (host-side build).

    Row owner = receiver, columns = senders, unit weights: exactly the
    gather direction of the RWR sweep (``agg[v] = Σ_{u→v} …``) and the
    bounded-BFS frontier sweep. ``r_cap`` defaults to the graph's static
    worst case.
    """
    em = to_numpy(g.edge_mask)
    s = to_numpy(g.senders)[em]
    r = to_numpy(g.receivers)[em]
    if r_cap is None:
        r_cap = ell_row_capacity(g.n_max, g.e_max, k)
    return build_ell(r, s, g.n_max, k=k, r_cap=r_cap, device=g.device)


class EllCache:
    """Incrementally-maintained ELL mirror of a :class:`DynamicGraph`.

    Converts the live COO edge set to the ELL layout once, then refreshes it
    per :class:`UpdateBatch` in O(|update|) host work + an O(|update|)
    device scatter — instead of an O(E) rebuild per step. Each vertex's
    entries stay compact (removal swaps the last live entry into the hole),
    and vertices whose in-degree outgrows their padded rows allocate spill
    rows from a shared cursor — so ``row_ids`` are NOT sorted; when the
    cursor hits the static row capacity the cache compacts itself with a
    full rebuild.

    The device tensors always have the static shape
    ``(ell_row_capacity(n_max, e_max, k), k)``. Single device only
    (``n_shards=1``): the graph-sharded row-block layout is not ported.
    """

    def __init__(self, n_max: int, e_max: int, k: int, device="cuda"):
        self.n_max = n_max
        self.e_max = e_max
        self.k = k
        self.device = torch.device(device)
        self.n_loc = n_max
        self.r_cap_block = ell_block_capacity(n_max, e_max, k, 1)
        self.r_cap = self.r_cap_block
        self._vals = torch.ones((self.r_cap, k), dtype=torch.float32,
                                device=self.device)
        self._last: Optional[DynamicGraph] = None
        self.n_rebuilds = 0

    # -- full (re)build ------------------------------------------------------

    def rebuild(self, g: DynamicGraph) -> None:
        """Compact host+device state from the live edge set of ``g``."""
        em = to_numpy(g.edge_mask)
        s = to_numpy(g.senders)[em]
        r = to_numpy(g.receivers)[em]
        n, k = self.n_max, self.k
        deg_in = np.bincount(r, minlength=n)
        rows_per_v = np.maximum(1, -(-deg_in // k))
        cs = np.concatenate([[0], np.cumsum(rows_per_v)])
        start_v = cs[:-1].astype(np.int64)
        self._next_row: List[int] = [int(cs[-1])]
        self._rows: List[List[int]] = [
            list(range(start_v[v], start_v[v] + rows_per_v[v]))
            for v in range(n)]
        self._fill = deg_in.astype(np.int64)
        self._cursor = int(to_numpy(g.n_edges))

        cols = np.zeros((self.r_cap, k), np.int32)
        mask = np.zeros((self.r_cap, k), bool)
        row_ids = np.zeros(self.r_cap, np.int32)
        row_ids[:int(cs[-1])] = np.repeat(np.arange(n, dtype=np.int32),
                                          rows_per_v)
        order = np.argsort(r, kind="stable")
        rs, ss = r[order], s[order]
        pos = np.arange(len(rs)) - np.concatenate([[0], np.cumsum(deg_in)])[rs]
        cols[start_v[rs] + pos // k, pos % k] = ss
        mask[start_v[rs] + pos // k, pos % k] = True
        self._cols_h, self._mask_h, self._row_ids_h = cols, mask, row_ids
        self._cols_d = torch.as_tensor(cols, device=self.device)
        self._mask_d = torch.as_tensor(mask, device=self.device)
        self._row_ids_d = torch.as_tensor(row_ids, device=self.device)
        self._last = g
        self.n_rebuilds += 1

    # -- incremental refresh -------------------------------------------------

    def _add(self, u: int, v: int, touched: set, new_rows: set) -> bool:
        """Append arc u→v; False if a spill row is unavailable (overflow)."""
        p = int(self._fill[v])
        ri = p // self.k
        if ri == len(self._rows[v]):
            if self._next_row[0] >= self.r_cap_block:
                return False
            row = self._next_row[0]
            self._next_row[0] += 1
            self._rows[v].append(row)
            self._row_ids_h[row] = v
            new_rows.add(row)
        row = self._rows[v][ri]
        slot = p % self.k
        self._cols_h[row, slot] = u
        self._mask_h[row, slot] = True
        self._fill[v] = p + 1
        touched.add((row, slot))
        return True

    def _remove(self, u: int, v: int, touched: set) -> None:
        """Remove one live copy of arc u→v (no-op when absent) by swapping
        the block's last live entry into the hole."""
        hit = None
        for ri in range((int(self._fill[v]) + self.k - 1) // self.k):
            row = self._rows[v][ri]
            live = self._mask_h[row] & (self._cols_h[row] == u)
            nz = np.nonzero(live)[0]
            if len(nz):
                hit = (row, int(nz[0]))
                break
        if hit is None:
            return
        last_p = int(self._fill[v]) - 1
        last = (self._rows[v][last_p // self.k], last_p % self.k)
        if hit != last:
            self._cols_h[hit] = self._cols_h[last]
            touched.add(hit)
        self._mask_h[last] = False
        touched.add(last)
        self._fill[v] = last_p

    def update(self, g: DynamicGraph, upd: UpdateBatch) -> DynamicGraph:
        """``apply_update`` + ELL refresh; returns the updated graph."""
        if self._last is not g:
            # caller swapped graphs under us (fresh stream / reset) — resync
            self.rebuild(g)
        g2 = apply_update(g, upd)
        self.refresh(g, g2, upd)
        return g2

    def refresh(self, g: DynamicGraph, g2: DynamicGraph,
                upd: UpdateBatch) -> None:
        """Mirror ``upd`` (which turned ``g`` into ``g2``) into the ELL state.

        Mirrors the COO semantics arc-for-arc: additions past the e_max
        cursor are dropped (as ``add_edges`` drops them) and each masked
        removal kills at most one live copy.
        """
        if self._last is not g:
            self.rebuild(g)

        touched: set = set()
        new_rows: set = set()
        overflow = False
        add_src = to_numpy(upd.add_src)
        add_dst = to_numpy(upd.add_dst)
        add_mask = to_numpy(upd.add_mask)
        slot = self._cursor
        for u, v, m in zip(add_src, add_dst, add_mask):
            if not m:
                continue
            if slot < self.e_max and 0 <= v < self.n_max:
                if not self._add(int(u), int(v), touched, new_rows):
                    overflow = True
                    break
            slot += 1
        self._cursor += int(add_mask.sum())
        if not overflow:
            rem_src = to_numpy(upd.rem_src)
            rem_dst = to_numpy(upd.rem_dst)
            rem_mask = to_numpy(upd.rem_mask)
            for u, v, m in zip(rem_src, rem_dst, rem_mask):
                if m and 0 <= v < self.n_max:
                    self._remove(int(u), int(v), touched)

        if overflow:
            self.rebuild(g2)
        else:
            if touched or new_rows:
                self._push(touched, new_rows)
            self._last = g2

    def _push(self, touched: set, new_rows: set) -> None:
        """Scatter the final host values of touched slots to the device,
        into fresh copies of the device tensors: an :class:`EllGraph`
        handed out earlier stays a snapshot of its mirror version, so its
        cached row index stays valid."""
        dev = self.device
        if touched:
            rc = np.asarray(sorted(touched), np.int64)
            rr = torch.as_tensor(rc[:, 0], device=dev)
            cc = torch.as_tensor(rc[:, 1], device=dev)
            self._cols_d = self._cols_d.clone()
            self._mask_d = self._mask_d.clone()
            self._cols_d[rr, cc] = torch.as_tensor(
                self._cols_h[rc[:, 0], rc[:, 1]], device=dev)
            self._mask_d[rr, cc] = torch.as_tensor(
                self._mask_h[rc[:, 0], rc[:, 1]], device=dev)
        if new_rows:
            nr = np.asarray(sorted(new_rows), np.int64)
            self._row_ids_d = self._row_ids_d.clone()
            self._row_ids_d[torch.as_tensor(nr, device=dev)] = (
                torch.as_tensor(self._row_ids_h[nr], device=dev))

    # -- views ---------------------------------------------------------------

    @property
    def ell(self) -> EllGraph:
        """The current mirror version as an :class:`EllGraph` (a fresh
        object per call; it caches its own row index)."""
        return EllGraph(self._cols_d, self._vals, self._row_ids_d,
                        self._mask_d, self.n_loc)
