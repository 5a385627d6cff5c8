"""Dynamic attributed graph with static shapes, and its mirrors.

The paper's input is a stream of timestamped updates over an attributed
graph: edge additions, edge removals, vertex label changes (§III-B). We keep
preallocated COO buffers (capacity ``e_max``) + masks so every update and
every RWR sweep works on fixed-shape tensors; the edge cursor and the
degree vector are maintained incrementally.

Graphs are stored *directed*; undirected inputs insert both arcs. All
tensors of a graph live on one device, chosen when the graph is built;
constructors take numpy. Updates return new :class:`DynamicGraph` tuples
and never write into the tensors of their input, so an earlier graph stays
valid.

The edge mirrors kept beside the graph — the ELL mirror (:class:`EllCache`)
and the receiver-partitioned COO store (:class:`EdgePartition`) — can be
split over the graph axis of a device mesh (:class:`GraphAxis`): vertices
partition into equal contiguous receiver slices, and slice ``d``'s rows or
arcs live on the axis's device ``d``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.sparse.ell import (EllBlocks, EllGraph, build_ell,
                                    build_ell_sharded, ell_block_capacity,
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


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` → ``cuda:<current>``),
    so two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class PartitionOverflowError(RuntimeError):
    """A receiver slice's static edge capacity was exceeded.

    Raised by the partitioned-storage router (:class:`EdgePartition`) and
    the partitioned ELL mirror when a slice's LIVE arcs outgrow its static
    per-slice capacity — the deterministic compaction already ran, so this
    is a real capacity breach, not cursor fragmentation. The message names
    the slice, its receiver range and the overage; the fix is more headroom
    (``partition_slice_capacity``) or a coarser partition."""


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

    def to(self, device) -> "DynamicGraph":
        """This graph on ``device`` (itself when it is there already)."""
        device = canonical_device(device)
        if device == canonical_device(self.device):
            return self
        return DynamicGraph(*(t.to(device) for t in self))


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
# The graph axis of a device mesh
# ---------------------------------------------------------------------------

class GraphAxis:
    """The graph axis of the engine's device mesh: its devices in shard
    order. Shard ``d`` owns the receiver slice ``[d·n_loc, (d+1)·n_loc)``
    with ``n_loc = n_max / size``; its edge rows or arcs live on
    ``devices[d]`` and its share of every sweep is launched there.

    One process drives every shard, so the mesh's collectives are explicit
    copies in a fixed order: :meth:`gather` concatenates the vertex slices
    on one device with no arithmetic (the ``all_gather``), and
    :meth:`reduce` folds owner-masked partials in shard order (the exact
    ``psum``/``pmax``: non-owners contribute exact zeros). A copy from one
    card to another is ordered after the source's pending work and before
    the destination's later work (``Tensor.to`` synchronizes both current
    streams), so a gather reads finished slices. Devices may repeat: a mesh
    of one card named four times runs the same programs one after the
    other, which checks the distribution but does not speed it up.
    """

    def __init__(self, devices: Sequence):
        self.devices: Tuple[torch.device, ...] = tuple(
            canonical_device(dv) for dv in devices)
        if not self.devices:
            raise ValueError("a graph axis needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def n_loc(self, n_max: int) -> int:
        if n_max % self.size:
            raise ValueError(
                f"n_max {n_max} not divisible by {self.size} graph shards")
        return n_max // self.size

    def broadcast(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on every device of the axis (no copy where it is already)."""
        return [t.to(dv) for dv in self.devices]

    @staticmethod
    def gather(parts: Sequence[torch.Tensor],
               home: torch.device) -> torch.Tensor:
        """Concatenate the shards' vertex slices on ``home``."""
        return torch.cat([p.to(home) for p in parts])

    @staticmethod
    def reduce(parts: Sequence[torch.Tensor], home: torch.device,
               op: str) -> torch.Tensor:
        """Fold full-length partials on ``home`` in shard order: ``"sum"``
        adds, ``"max"`` takes the maximum."""
        out = parts[0].to(home)
        for p in parts[1:]:
            out = out + p.to(home) if op == "sum" else torch.maximum(
                out, p.to(home))
        return out


# ---------------------------------------------------------------------------
# Edge-partitioned COO storage (receiver-sliced) + host update router
# ---------------------------------------------------------------------------

def partition_slice_capacity(e_max: int, n_shards: int,
                             headroom: float = 1.25) -> int:
    """Static per-slice arc capacity of the partitioned layout.

    ``headroom > 1`` absorbs receiver skew: a perfectly balanced stream
    needs ``e_max / n_shards`` slots per slice, real streams concentrate
    some receivers. At the default 1.25x the per-device edge footprint is
    0.3125x the replicated arrays for 4 slices.
    """
    return int(np.ceil(headroom * e_max / n_shards))


class PartitionedEdges(NamedTuple):
    """Receiver-sliced COO edge tensors — the device view of
    :class:`EdgePartition`.

    Entry ``d`` of each field holds only the arcs whose receiver lives in
    vertex slice ``[d·n_loc, (d+1)·n_loc)``, in global insertion order, on
    shard ``d``'s device, with receivers stored slice-LOCAL (``v −
    d·n_loc``). The sweeps segment-reduce straight into local segments —
    no receiver masking — and gather the slices back.
    """

    senders: Tuple[torch.Tensor, ...]        # int32[e_cap_slice] each, global
    receivers_loc: Tuple[torch.Tensor, ...]  # int32[e_cap_slice] each, local
    mask: Tuple[torch.Tensor, ...]           # bool[e_cap_slice] each
    n_loc: int                               # vertex-slice width

    def to(self, devices: Sequence) -> "PartitionedEdges":
        """The same slices with slice ``d`` on ``devices[d]``."""
        devices = [canonical_device(dv) for dv in devices]
        return PartitionedEdges(
            *(tuple(t.to(dv) for t, dv in zip(field, devices))
              for field in (self.senders, self.receivers_loc, self.mask)),
            self.n_loc)


def _pow2_pad(a: np.ndarray) -> np.ndarray:
    """``a`` padded to the next power of two by repeating its last entry
    (a repeated write of the same value is a no-op), so the staged upload
    widths stay logarithmic in the update width."""
    width = max(1, 1 << int(np.ceil(np.log2(max(len(a), 1)))))
    return np.concatenate([a, np.repeat(a[-1:], width - len(a))])


class EdgePartition:
    """Host-maintained receiver-partitioned edge store for a
    :class:`DynamicGraph`, plus the update router that keeps it fresh.

    ``rebuild`` splits the live COO arcs by receiver slice, preserving
    global slot order inside each slice. ``refresh`` routes each
    :class:`UpdateBatch` by destination slice on the host in O(|update|):

    - additions mirror ``add_edges`` arc for arc — a global cursor tracks
      ``g.n_edges`` so arcs the replicated path drops past ``e_max`` are
      dropped here too — and append at the owning slice's fill cursor;
    - removals kill the first live copy of (u, v) in slice slot order,
      which IS global slot order because every copy of an arc lands in the
      receiver owner's slice (matching ``remove_edges``);
    - when a slice's fill cursor hits ``e_cap_slice`` with dead slots
      below it, the slice is compacted in place (live arcs keep their
      relative order, so reduction orders are unchanged); if the LIVE
      count itself would exceed the capacity the router raises
      :class:`PartitionOverflowError` naming the slice and the overage.

    Slice ``d``'s tensors live on ``devices[d]``. Touched slots go up per
    slice as one staged index/value upload padded to a power of two, into
    fresh copies of that slice's tensors (a :class:`PartitionedEdges`
    handed out earlier stays a snapshot); compacted slices go up whole.
    Per-vertex slot multisets and their relative order match the
    replicated arrays, so partitioned sweeps are bitwise the replicated
    ones: dead slots contribute exact zeros and the gather does no
    arithmetic.
    """

    def __init__(self, n_max: int, e_max: int, n_shards: int,
                 e_cap_slice: Optional[int] = None,
                 headroom: float = 1.25,
                 devices: Optional[Sequence] = None):
        if n_max % n_shards:
            raise ValueError(
                f"n_max {n_max} not divisible by n_shards {n_shards}")
        self.n_max = n_max
        self.e_max = e_max
        self.n_shards = n_shards
        self.n_loc = n_max // n_shards
        self.e_cap_slice = (partition_slice_capacity(e_max, n_shards,
                                                     headroom)
                            if e_cap_slice is None else e_cap_slice)
        self.devices = [canonical_device(dv) for dv in
                        (devices if devices is not None
                         else ["cuda"] * n_shards)]
        if len(self.devices) != n_shards:
            raise ValueError(f"{len(self.devices)} devices for {n_shards} "
                             "slices")
        self._last: Optional[DynamicGraph] = None
        self._live: List[int] = []
        self.n_rebuilds = 0
        self.n_compactions = 0

    # -- capacity / introspection -------------------------------------------

    def slice_nbytes(self) -> int:
        """Per-device bytes of one slice's edge tensors (int32 senders +
        int32 local receivers + bool mask)."""
        return self.e_cap_slice * (4 + 4 + 1)

    @staticmethod
    def replicated_nbytes(e_max: int) -> int:
        """Per-device bytes of the replicated COO edge tensors."""
        return e_max * (4 + 4 + 1)

    def occupancy(self) -> float:
        """Worst live-arc fill fraction across slices ∈ [0, 1] — the
        overflow-proximity signal the health watchdog degrades on before
        :class:`PartitionOverflowError` fires (0.0 before any rebuild)."""
        if not self._live:
            return 0.0
        return max(self._live) / self.e_cap_slice

    def _overflow(self, d: int, live: int) -> None:
        raise PartitionOverflowError(
            f"edge slice {d} (receivers [{d * self.n_loc}, "
            f"{(d + 1) * self.n_loc})): {live} live arcs exceed the static "
            f"slice capacity {self.e_cap_slice} by "
            f"{live - self.e_cap_slice} — raise the partition headroom, "
            f"e_max, or the slice count")

    # -- full (re)build ------------------------------------------------------

    def rebuild(self, g: DynamicGraph) -> None:
        """Compact host+device slices from the live edge set of ``g``."""
        em = to_numpy(g.edge_mask)
        s = to_numpy(g.senders)
        r = to_numpy(g.receivers)
        cap = self.e_cap_slice
        send = np.zeros((self.n_shards, cap), np.int32)
        recv = np.zeros((self.n_shards, cap), np.int32)
        mask = np.zeros((self.n_shards, cap), bool)
        self._fill: List[int] = []
        self._live = []
        owner = r // self.n_loc
        for d in range(self.n_shards):
            idx = np.nonzero(em & (owner == d))[0]  # ascending = slot order
            if len(idx) > cap:
                self._overflow(d, len(idx))
            send[d, : len(idx)] = s[idx]
            recv[d, : len(idx)] = r[idx] - d * self.n_loc
            mask[d, : len(idx)] = True
            self._fill.append(len(idx))
            self._live.append(len(idx))
        self._send_h, self._recv_h, self._mask_h = send, recv, mask
        self._dev = [self._upload(d) for d in range(self.n_shards)]
        self._cursor = int(to_numpy(g.n_edges))
        self._last = g
        self.n_rebuilds += 1

    def _upload(self, d: int) -> Tuple[torch.Tensor, ...]:
        dv = self.devices[d]
        return tuple(torch.as_tensor(h[d].copy(), device=dv)
                     for h in (self._send_h, self._recv_h, self._mask_h))

    # -- incremental refresh -------------------------------------------------

    def _compact(self, d: int) -> None:
        """Deterministic spill policy: drop the dead slots of slice ``d``,
        keeping live arcs in their existing (global-slot) order."""
        fill = self._fill[d]
        keep = np.nonzero(self._mask_h[d, :fill])[0]
        nl = len(keep)
        self._send_h[d, :nl] = self._send_h[d, keep]
        self._recv_h[d, :nl] = self._recv_h[d, keep]
        self._mask_h[d, :] = False
        self._mask_h[d, :nl] = True
        self._fill[d] = nl
        self.n_compactions += 1

    def refresh(self, g: DynamicGraph, g2: DynamicGraph,
                upd: UpdateBatch) -> None:
        """Route ``upd`` (which turned ``g`` into ``g2``) into the slices."""
        if self._last is not g:
            self.rebuild(g)
        touched: Set[Tuple[int, int]] = set()
        dirty: Set[int] = set()  # compacted slices → full-slice upload
        add_src = to_numpy(upd.add_src)
        add_dst = to_numpy(upd.add_dst)
        add_mask = to_numpy(upd.add_mask)
        slot = self._cursor
        for u, v, m in zip(add_src, add_dst, add_mask):
            if not m:
                continue
            if slot < self.e_max and 0 <= v < self.n_max:
                d = int(v) // self.n_loc
                j = self._fill[d]
                if j >= self.e_cap_slice:
                    if self._live[d] >= self.e_cap_slice:
                        self._overflow(d, self._live[d] + 1)
                    self._compact(d)
                    dirty.add(d)
                    j = self._fill[d]
                self._send_h[d, j] = u
                self._recv_h[d, j] = int(v) - d * self.n_loc
                self._mask_h[d, j] = True
                self._fill[d] = j + 1
                self._live[d] += 1
                touched.add((d, j))
            slot += 1
        self._cursor += int(add_mask.sum())

        rem_src = to_numpy(upd.rem_src)
        rem_dst = to_numpy(upd.rem_dst)
        rem_mask = to_numpy(upd.rem_mask)
        for u, v, m in zip(rem_src, rem_dst, rem_mask):
            if not (m and 0 <= v < self.n_max):
                continue
            d = int(v) // self.n_loc
            vl = int(v) - d * self.n_loc
            fill = self._fill[d]
            hit = np.nonzero(self._mask_h[d, :fill]
                             & (self._send_h[d, :fill] == u)
                             & (self._recv_h[d, :fill] == vl))[0]
            if len(hit):
                j = int(hit[0])
                self._mask_h[d, j] = False
                self._live[d] -= 1
                touched.add((d, j))
        self._push(touched, dirty)
        self._last = g2

    def _push(self, touched: Set[Tuple[int, int]], dirty: Set[int]) -> None:
        """Upload the final host values of touched slots, slice by slice;
        compacted slices upload whole."""
        for d in sorted(dirty):
            self._dev[d] = self._upload(d)
        by_slice: dict = {}
        for d, j in touched:
            if d not in dirty:
                by_slice.setdefault(d, []).append(j)
        for d, js in sorted(by_slice.items()):
            jj = _pow2_pad(np.asarray(sorted(js), np.int64))
            dv = self.devices[d]
            idx = torch.as_tensor(jj, device=dv)
            fresh = []
            for t, h in zip(self._dev[d],
                            (self._send_h, self._recv_h, self._mask_h)):
                t = t.clone()
                t[idx] = torch.as_tensor(h[d, jj], device=dv)
                fresh.append(t)
            self._dev[d] = tuple(fresh)

    def update(self, g: DynamicGraph, upd: UpdateBatch) -> DynamicGraph:
        """``apply_update`` + partition refresh; returns the updated graph."""
        if self._last is not g:
            self.rebuild(g)
        g2 = apply_update(g, upd)
        self.refresh(g, g2, upd)
        return g2

    # -- views ---------------------------------------------------------------

    @property
    def part(self) -> PartitionedEdges:
        """The current store version as :class:`PartitionedEdges`."""
        return PartitionedEdges(tuple(t[0] for t in self._dev),
                                tuple(t[1] for t in self._dev),
                                tuple(t[2] for t in self._dev), self.n_loc)


# ---------------------------------------------------------------------------
# ELL mirror of the live edge set (the matching hot path's layout)
# ---------------------------------------------------------------------------

def ell_from_graph(g: DynamicGraph, k: int, r_cap: Optional[int] = None,
                   n_shards: int = 1, devices: Optional[Sequence] = None):
    """Fresh *incoming*-adjacency ELL of the live arcs (host-side build).

    Row owner = receiver, columns = senders, unit weights: exactly the
    gather direction of the RWR sweep (``agg[v] = Σ_{u→v} …``) and the
    bounded-BFS frontier sweep. ``r_cap`` defaults to the graph's static
    worst case. ``n_shards > 1`` returns the shard-local row blocks of the
    graph mesh axis instead (:func:`~repro_torch.sparse.ell.
    build_ell_sharded`, block ``d`` on ``devices[d]``, default the graph's
    device; ``r_cap`` then caps one block).
    """
    em = to_numpy(g.edge_mask)
    s = to_numpy(g.senders)[em]
    r = to_numpy(g.receivers)[em]
    if n_shards > 1:
        if r_cap is None:
            r_cap = ell_block_capacity(g.n_max, g.e_max, k, n_shards)
        return build_ell_sharded(
            r, s, g.n_max, n_shards, k=k, r_cap_block=r_cap,
            devices=devices if devices is not None
            else [g.device] * n_shards)
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
    rows from their block's cursor — so ``row_ids`` are NOT sorted; when a
    cursor hits its block's row capacity the cache compacts itself with a
    full rebuild.

    ``n_shards > 1`` keeps the shard-local row-block layout of the graph
    mesh axis: the row axis splits into ``n_shards`` equal blocks, block
    ``d`` holds the rows of vertex slice ``[d·n_loc, (d+1)·n_loc)`` with
    slice-local ``row_ids``, its own spill cursor, and its device tensors
    on ``devices[d]``, and :attr:`ell` is an
    :class:`~repro_torch.sparse.ell.EllBlocks` with ``n`` the slice width.
    The per-vertex entry layout (and so every reduction order) is the
    unsharded mirror's. The host arrays keep the JAX package's layout: all
    blocks stacked, ``(n_shards · r_cap_block, k)``.

    ``partitioned=True`` (with ``n_shards > 1``) sizes each row block for
    ``partition_slice_capacity(e_max, n_shards, headroom)`` arcs instead of
    the full ``e_max``: the per-device block shrinks about 1/g, and a slice
    whose live in-degree outgrows its block raises
    :class:`PartitionOverflowError` at rebuild instead of growing.
    """

    def __init__(self, n_max: int, e_max: int, k: int, n_shards: int = 1,
                 partitioned: bool = False, headroom: float = 1.25,
                 device="cuda", devices: Optional[Sequence] = None):
        if n_max % n_shards:
            raise ValueError(
                f"n_max {n_max} not divisible by n_shards {n_shards}")
        self.n_max = n_max
        self.e_max = e_max
        self.k = k
        self.n_shards = n_shards
        self.n_loc = n_max // n_shards
        self.devices = [canonical_device(dv) for dv in
                        (devices if devices is not None
                         else [device] * n_shards)]
        if len(self.devices) != n_shards:
            raise ValueError(f"{len(self.devices)} devices for {n_shards} "
                             "row blocks")
        self.device = self.devices[0]
        self.partitioned = partitioned and n_shards > 1
        e_cap_block = (partition_slice_capacity(e_max, n_shards, headroom)
                       if self.partitioned else e_max)
        self.r_cap_block = ell_block_capacity(n_max, e_cap_block, k, n_shards)
        self.r_cap = n_shards * self.r_cap_block
        # rows per device block, fixed here (r_cap_block bounds each
        # block's cursor and may be lowered afterwards)
        self._blk = self.r_cap_block
        self._vals = [torch.ones((self._blk, k), dtype=torch.float32,
                                 device=dv) for dv in self.devices]
        self._last: Optional[DynamicGraph] = None
        self.n_rebuilds = 0

    def occupancy(self) -> float:
        """Worst spill-cursor fill fraction across row blocks ∈ [0, 1] —
        overflow proximity in partitioned mode, where a block that fills
        raises :class:`PartitionOverflowError` at the next rebuild instead
        of growing (0.0 before any rebuild)."""
        next_row = getattr(self, "_next_row", None)
        if not next_row:
            return 0.0
        return max((next_row[d] - d * self.r_cap_block) / self.r_cap_block
                   for d in range(self.n_shards))

    def block_nbytes(self) -> int:
        """Device bytes of one row block's slots: int32 cols, f32 vals and
        bool mask (9 B per slot)."""
        return self._blk * self.k * (4 + 4 + 1)

    # -- full (re)build ------------------------------------------------------

    def rebuild(self, g: DynamicGraph) -> None:
        """Compact host+device state from the live edge set of ``g``."""
        em = to_numpy(g.edge_mask)
        s = to_numpy(g.senders)[em]
        r = to_numpy(g.receivers)[em]
        n, k = self.n_max, self.k
        deg_in = np.bincount(r, minlength=n)
        rows_per_v = np.maximum(1, -(-deg_in // k))
        row_ids = np.zeros(self.r_cap, np.int32)
        # physical start row of every vertex: per-block compact packing,
        # each block based at its offset, with its own spill cursor
        start_v = np.zeros(n, np.int64)
        self._next_row: List[int] = []
        for d in range(self.n_shards):
            lo, hi = d * self.n_loc, (d + 1) * self.n_loc
            cs = (d * self.r_cap_block
                  + np.concatenate([[0], np.cumsum(rows_per_v[lo:hi])]))
            need = int(cs[-1]) - d * self.r_cap_block
            if need > self.r_cap_block:
                # only reachable in partitioned mode (the replicated block
                # capacity covers any in-degree distribution) — a slice's
                # live arcs outgrew its shrunken block
                raise PartitionOverflowError(
                    f"ELL slice {d} (receivers [{lo}, {hi})): "
                    f"{int(deg_in[lo:hi].sum())} live arcs need {need} rows"
                    f" > block capacity {self.r_cap_block} (over by "
                    f"{need - self.r_cap_block} rows) — raise the partition"
                    f" headroom, e_max, or the slice count")
            start_v[lo:hi] = cs[:-1]
            self._next_row.append(int(cs[-1]))
            row_ids[int(cs[0]):int(cs[-1])] = np.repeat(
                np.arange(self.n_loc, dtype=np.int32), rows_per_v[lo:hi])
        self._rows: List[List[int]] = [
            list(range(start_v[v], start_v[v] + rows_per_v[v]))
            for v in range(n)]
        self._fill = deg_in.astype(np.int64)
        self._cursor = int(to_numpy(g.n_edges))

        cols = np.zeros((self.r_cap, k), np.int32)
        mask = np.zeros((self.r_cap, k), bool)
        order = np.argsort(r, kind="stable")
        rs, ss = r[order], s[order]
        pos = np.arange(len(rs)) - np.concatenate([[0], np.cumsum(deg_in)])[rs]
        cols[start_v[rs] + pos // k, pos % k] = ss
        mask[start_v[rs] + pos // k, pos % k] = True
        self._cols_h, self._mask_h, self._row_ids_h = cols, mask, row_ids
        self._dev = []
        for d, dv in enumerate(self.devices):
            rows = slice(d * self._blk, (d + 1) * self._blk)
            self._dev.append(tuple(torch.as_tensor(h[rows], device=dv)
                                   for h in (cols, mask, row_ids)))
        self._last = g
        self.n_rebuilds += 1

    # -- incremental refresh -------------------------------------------------

    def _add(self, u: int, v: int, touched: set, new_rows: set) -> bool:
        """Append arc u→v; False if a spill row is unavailable (overflow)."""
        p = int(self._fill[v])
        ri = p // self.k
        if ri == len(self._rows[v]):
            shard = v // self.n_loc
            if self._next_row[shard] >= (shard + 1) * self.r_cap_block:
                return False
            row = self._next_row[shard]
            self._next_row[shard] += 1
            self._rows[v].append(row)
            self._row_ids_h[row] = v % self.n_loc
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
        """Scatter the final host values of touched slots to each block's
        device, into fresh copies of that block's tensors: an ELL handed
        out earlier stays a snapshot of its mirror version, so its cached
        row index stays valid."""
        by_blk: dict = {}
        for row, slot in touched:
            by_blk.setdefault(row // self._blk, ([], []))[0].append(
                (row, slot))
        for row in new_rows:
            by_blk.setdefault(row // self._blk, ([], []))[1].append(row)
        for d, (slots, rows) in sorted(by_blk.items()):
            dv = self.devices[d]
            cols_d, mask_d, rid_d = self._dev[d]
            off = d * self._blk
            if slots:
                rc = np.asarray(sorted(slots), np.int64)
                rr = torch.as_tensor(rc[:, 0] - off, device=dv)
                cc = torch.as_tensor(rc[:, 1], device=dv)
                cols_d = cols_d.clone()
                mask_d = mask_d.clone()
                cols_d[rr, cc] = torch.as_tensor(
                    self._cols_h[rc[:, 0], rc[:, 1]], device=dv)
                mask_d[rr, cc] = torch.as_tensor(
                    self._mask_h[rc[:, 0], rc[:, 1]], device=dv)
            if rows:
                nr = np.asarray(sorted(rows), np.int64)
                rid_d = rid_d.clone()
                rid_d[torch.as_tensor(nr - off, device=dv)] = (
                    torch.as_tensor(self._row_ids_h[nr], device=dv))
            self._dev[d] = (cols_d, mask_d, rid_d)

    # -- views ---------------------------------------------------------------

    def _host_view(self, i: int) -> torch.Tensor:
        if self.n_shards == 1:
            return self._dev[0][i]
        return torch.cat([blk[i].cpu() for blk in self._dev])

    @property
    def _cols_d(self) -> torch.Tensor:
        """The device cols (all blocks stacked on the CPU when sharded)."""
        return self._host_view(0)

    @property
    def _mask_d(self) -> torch.Tensor:
        return self._host_view(1)

    @property
    def _row_ids_d(self) -> torch.Tensor:
        return self._host_view(2)

    @property
    def ell(self):
        """The current mirror version: an :class:`EllGraph` unsharded, an
        :class:`~repro_torch.sparse.ell.EllBlocks` (one block per slice, on
        its device) under the graph axis. A fresh object per call; it
        caches its own row index per block."""
        blocks = tuple(EllGraph(c, v, r, m, self.n_loc)
                       for (c, m, r), v in zip(self._dev, self._vals))
        return blocks[0] if self.n_shards == 1 else EllBlocks(blocks)
