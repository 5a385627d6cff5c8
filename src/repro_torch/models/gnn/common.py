"""Shared GNN machinery: inputs, MLP util, model factory (PyTorch port of
``repro.models.gnn.common``).

Message passing is an edge gather (:func:`gather_rows`, JAX's clamping
``x[idx]``) and the port's fixed-order :func:`segment_sum`, which every
aggregation of the four models goes through. Under ``dtype="bfloat16"``
the message passing runs in bf16 from f32 parameters, cast where they are
used, and the loss is reduced in f32, as in the reference.

Each model reads its graph through :func:`graph_view`, which splits the
forward into node-level work (``view.params``) and edge-level work
(``view.map``, ``view.node_rows``, ``view.aggregate``, ``view.edge_table``,
``view.edge_sums``). With plain parameters the view is one device's: each
helper is the plain function (``gather_rows``, ``segment_sum``, the
identity), so the ops are the unsharded model's. With :class:`EdgeHomes`
(``train.state.make_edge_sharded_train_step``) the edge arrays are
``ShardedTensor`` s split into blocks over the batch axes, as the
reference's cells split them: each block's home runs the edge work on its
edges with its own replica of the parameters and gathers from its own copy
of a node table; the partial sums fold at position 0 in block order
(``distrib.collectives.edge_psum``). Edge state (MeshGraphNet's ``e``,
DimeNet's ``m``) stays on its block between layers. Node-level work — the
node MLPs, the encoder and decoder, the loss — runs at position 0, the
first home, and every node table the edge work reads is sent to the other
homes (``node_send``). The reference instead replicates that work on every
device after its psum; the dry run charges it to position 0.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import GNNConfig
from repro_torch.distrib.collectives import (edge_gather, edge_psum,
                                             edge_scatter, send)
from repro_torch.distrib.sharding import ShardedTensor
from repro_torch.optim.adamw import tree_map
from repro_torch.sparse.segment import gather_rows, segment_sum


class GraphInputs(NamedTuple):
    """One graph (or disjoint union of graphs / sampled block).

    node_feat: (N, d_feat) — dense features (molecular models also get
    positions; generic shapes synthesize them)
    senders/receivers: (E,) int32
    positions: (N, 3) — molecular geometry (schnet/dimenet)
    trip_kj/trip_ji: (T,) int32 — triplet edge indices (dimenet): message on
    edge kj flows into edge ji where kj.receiver == ji.sender
    targets: (N, d_out)
    """

    node_feat: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    targets: torch.Tensor
    positions: Optional[torch.Tensor] = None
    trip_kj: Optional[torch.Tensor] = None
    trip_ji: Optional[torch.Tensor] = None
    edge_feat: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]


def init_mlp(gen: torch.Generator, dims: List[int],
             device=None) -> Dict[str, Any]:
    """f32 Glorot-normal weights and zero biases on ``device`` (default:
    the generator's; ``"meta"`` draws nothing), the reference's
    ``w{i}``/``b{i}`` layout."""
    dev = gen.device if device is None else device
    ps = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ps[f"w{i}"] = (torch.randn((a, b), generator=gen, device=dev)
                       * (2.0 / (a + b)) ** 0.5)
        ps[f"b{i}"] = torch.zeros((b,), device=dev)
    return ps


def mlp(params: Dict[str, Any], x: torch.Tensor, n: int,
        act=F.silu, final_act: bool = False) -> torch.Tensor:
    for i in range(n):
        x = x @ params[f"w{i}"].to(x.dtype) + params[f"b{i}"].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def edge_distances(pos: torch.Tensor, senders: torch.Tensor,
                   receivers: torch.Tensor) -> torch.Tensor:
    d = gather_rows(pos, receivers) - gather_rows(pos, senders)
    return torch.sqrt(torch.clamp_min((d * d).sum(-1), 1e-12))


def gaussian_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.linspace(0.0, cutoff, n_rbf, device=d.device)
    gamma = n_rbf / max(cutoff, 1e-6)
    return torch.exp(-gamma * (d[:, None] - centers[None, :]) ** 2)


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(d < cutoff,
                       0.5 * (torch.cos(math.pi * d / cutoff) + 1.0), 0.0)


class EdgeHomes(NamedTuple):
    """The parameters of a forward over a graph whose edge arrays are split
    into blocks on ``mesh``: each block's home position, in block order
    (position 0 first), and each home's own replica of the parameter tree
    (tensors that collect that home's gradient)."""
    mesh: Any
    homes: Tuple[int, ...]
    params: Tuple[Any, ...]


class EdgeParts(tuple):
    """An edge-level value of a graph on a mesh: one tensor per edge block,
    each at its block's home."""


def node_input(x):
    """A node-level input (replicated on a mesh) as position 0 reads it."""
    return x.shards[0] if isinstance(x, ShardedTensor) else x


class OneDevice:
    """The graph on one device: each helper is the plain function."""

    def __init__(self, params):
        self.params = params

    def map(self, fn: Callable, *args):
        """``fn(params, *args)``: edge-level work."""
        return fn(self.params, *args)

    def node_rows(self, x: torch.Tensor, idx) -> torch.Tensor:
        return gather_rows(x, idx)

    def aggregate(self, msgs, idx, n: int) -> torch.Tensor:
        """Edge messages summed into ``n`` nodes."""
        return segment_sum(msgs, idx, n)

    def edge_table(self, x):
        """An edge-level value read whole (DimeNet's triplets index the
        whole edge list)."""
        return x

    def edge_sums(self, msgs, idx, n_edges: int):
        """Triplet messages summed into the ``n_edges`` edges."""
        return segment_sum(msgs, idx, n_edges)


class EdgeBlocks:
    """The graph on a mesh, its edge arrays split into blocks
    (:class:`EdgeHomes`). ``params`` is position 0's replica, for the
    node-level work; ``map`` runs edge-level work once per block at its
    home, where an argument is read as: an :class:`EdgeParts` value, its
    block's tensor; a ``ShardedTensor`` (an edge array split like the
    blocks, or a replicated input), the home's shard; a tensor (a node
    table made at position 0), sent to the home once (``node_send``);
    anything else as it is."""

    def __init__(self, ep: EdgeHomes):
        if ep.homes[0] != 0:
            raise ValueError(f"edge homes {ep.homes} do not start at "
                             f"position 0")
        self.mesh, self.homes, self.replicas = ep.mesh, ep.homes, ep.params
        self.params = ep.params[0]
        self._sent: Dict[int, Tuple[torch.Tensor, List[torch.Tensor]]] = {}

    def _part(self, a, b: int):
        h = self.homes[b]
        if isinstance(a, EdgeParts):
            return a[b]
        if isinstance(a, ShardedTensor):
            return a.shards[h]
        if isinstance(a, torch.Tensor):
            if h == 0:
                return a
            key = id(a)
            if key not in self._sent:
                self._sent[key] = (a, [None] * len(self.homes))
            parts = self._sent[key][1]
            if parts[b] is None:
                parts[b] = send(a, self.mesh, 0, h, "node_send")
            return parts[b]
        return a

    def map(self, fn: Callable, *args):
        """An :class:`EdgeParts` of ``fn``'s per-block results (a tuple of
        them where ``fn`` returns a tuple)."""
        out = []
        for b, h in enumerate(self.homes):
            with self.mesh.at(h):
                out.append(fn(self.replicas[b],
                              *(self._part(a, b) for a in args)))
        if isinstance(out[0], tuple):
            return tuple(EdgeParts(x) for x in zip(*out))
        return EdgeParts(out)

    def node_rows(self, x: torch.Tensor, idx) -> EdgeParts:
        return self.map(lambda _, x, i: gather_rows(x, i), x, idx)

    def aggregate(self, msgs, idx, n: int) -> torch.Tensor:
        partials = self.map(lambda _, m, i: segment_sum(m, i, n), msgs, idx)
        return edge_psum(self.mesh, self.homes, partials)

    def edge_table(self, x) -> EdgeParts:
        blocks = [self._part(x, b) for b in range(len(self.homes))]
        return EdgeParts(edge_gather(self.mesh, self.homes, blocks))

    def edge_sums(self, msgs, idx, n_edges: int) -> EdgeParts:
        partials = self.map(lambda _, m, i: segment_sum(m, i, n_edges),
                            msgs, idx)
        return EdgeParts(edge_scatter(self.mesh, self.homes, partials))


def graph_view(params):
    """How a forward reads its graph: :class:`EdgeBlocks` for
    :class:`EdgeHomes`, else :class:`OneDevice`."""
    return EdgeBlocks(params) if isinstance(params, EdgeHomes) \
        else OneDevice(params)


def make_model(cfg: GNNConfig):
    """Factory: GNNConfig.kind → model instance (init/forward/loss)."""
    from repro_torch.models.gnn.dimenet import DimeNet
    from repro_torch.models.gnn.graphcast import GraphCast
    from repro_torch.models.gnn.meshgraphnet import MeshGraphNet
    from repro_torch.models.gnn.schnet import SchNet
    return {"schnet": SchNet, "dimenet": DimeNet, "graphcast": GraphCast,
            "meshgraphnet": MeshGraphNet}[cfg.kind](cfg)


class GNNBase:
    def __init__(self, cfg: GNNConfig):
        self.cfg = cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 message passing halves gather/scatter memory traffic;
        reductions stay f32 in the loss."""
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" \
            else torch.float32

    def loss(self, params, inputs: GraphInputs) -> torch.Tensor:
        pred = self.forward(params, inputs).float()
        err = (pred - node_input(inputs.targets).float()) ** 2
        return err.mean()


def gnn_params_from_jax(tree, device="cuda") -> Dict[str, Any]:
    """A JAX GNN's ``init`` tree (leaves as numpy or JAX arrays) as this
    port's f32 parameters on ``device``, in the same nested layout."""
    return tree_map(lambda a: torch.as_tensor(
        np.array(a, dtype=np.float32)).to(device), tree)
