"""Shared GNN machinery: inputs, MLP util, model factory (PyTorch port of
``repro.models.gnn.common``).

Message passing is an edge gather (:func:`gather_rows`, JAX's clamping
``x[idx]``) and the port's fixed-order :func:`segment_sum`, which every
aggregation of the four models goes through. Under ``dtype="bfloat16"``
the message passing runs in bf16 from f32 parameters, cast where they are
used, and the loss is reduced in f32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import GNNConfig
from repro_torch.optim.adamw import tree_map
from repro_torch.sparse.segment import gather_rows


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


def init_mlp(gen: torch.Generator, dims: List[int]) -> Dict[str, Any]:
    """f32 Glorot-normal weights and zero biases on the generator's
    device, the reference's ``w{i}``/``b{i}`` layout."""
    ps = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ps[f"w{i}"] = (torch.randn((a, b), generator=gen, device=gen.device)
                       * (2.0 / (a + b)) ** 0.5)
        ps[f"b{i}"] = torch.zeros((b,), device=gen.device)
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
        err = (pred - inputs.targets.float()) ** 2
        return err.mean()


def gnn_params_from_jax(tree, device="cuda") -> Dict[str, Any]:
    """A JAX GNN's ``init`` tree (leaves as numpy or JAX arrays) as this
    port's f32 parameters on ``device``, in the same nested layout."""
    return tree_map(lambda a: torch.as_tensor(
        np.array(a, dtype=np.float32)).to(device), tree)
