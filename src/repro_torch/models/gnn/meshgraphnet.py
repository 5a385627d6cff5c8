"""MeshGraphNet (Pfaff et al., arXiv:2010.03409) — encode-process-decode
(PyTorch port of ``repro.models.gnn.meshgraphnet``).

Assigned config: n_layers=15, d_hidden=128, aggregator=sum, mlp_layers=2.
Per processor layer: edge MLP(e, x_s, x_r) with residual, then node
MLP(x, Σ_in e) with residual, the sum the fixed-order segment_sum. Edge
features default to relative positions + distance when none are provided.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.gnn.common import GNNBase, GraphInputs, init_mlp, mlp
from repro_torch.sparse.segment import gather_rows, segment_sum


class MeshGraphNet(GNNBase):
    def init(self, gen: torch.Generator, d_feat: int,
             d_edge: int = 4) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_hidden
        ml = cfg.mlp_layers
        p: Dict[str, Any] = {
            "enc_node": init_mlp(gen, [d_feat] + [d] * ml),
            "enc_edge": init_mlp(gen, [d_edge] + [d] * ml),
            "dec": init_mlp(gen, [d] * ml + [cfg.d_out]),
        }
        for i in range(cfg.n_layers):
            p[f"proc{i}"] = {
                "edge": init_mlp(gen, [3 * d] + [d] * ml),
                "node": init_mlp(gen, [2 * d] + [d] * ml),
            }
        return p

    def _edge_feat(self, inputs: GraphInputs) -> torch.Tensor:
        if inputs.edge_feat is not None:
            return inputs.edge_feat
        if inputs.positions is not None:
            rel = (gather_rows(inputs.positions, inputs.receivers)
                   - gather_rows(inputs.positions, inputs.senders))
            dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
            return torch.cat([rel, dist], dim=-1)
        # featureless edges: degree-ish placeholder
        return torch.ones((inputs.n_edges, 4), dtype=inputs.node_feat.dtype,
                          device=inputs.node_feat.device)

    def forward(self, params, inputs: GraphInputs) -> torch.Tensor:
        cfg = self.cfg
        ml = cfg.mlp_layers
        n = inputs.n_nodes
        s, r = inputs.senders, inputs.receivers
        cd = self.compute_dtype
        x = mlp(params["enc_node"], inputs.node_feat.to(cd), ml)
        e = mlp(params["enc_edge"], self._edge_feat(inputs).to(cd), ml)
        for i in range(cfg.n_layers):
            pp = params[f"proc{i}"]
            e = e + mlp(pp["edge"], torch.cat(
                [e, gather_rows(x, s), gather_rows(x, r)], dim=-1), ml)
            agg = segment_sum(e, r, n)
            x = x + mlp(pp["node"], torch.cat([x, agg], dim=-1), ml)
        return mlp(params["dec"], x, ml)
