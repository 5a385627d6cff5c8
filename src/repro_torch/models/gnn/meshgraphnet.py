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

from repro_torch.models.gnn.common import (GNNBase, GraphInputs, graph_view,
                                           init_mlp, mlp, node_input)
from repro_torch.sparse.segment import gather_rows


class MeshGraphNet(GNNBase):
    def init(self, gen: torch.Generator, d_feat: int,
             d_edge: int = 4, device=None) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_hidden
        ml = cfg.mlp_layers
        p: Dict[str, Any] = {
            "enc_node": init_mlp(gen, [d_feat] + [d] * ml, device),
            "enc_edge": init_mlp(gen, [d_edge] + [d] * ml, device),
            "dec": init_mlp(gen, [d] * ml + [cfg.d_out], device),
        }
        for i in range(cfg.n_layers):
            p[f"proc{i}"] = {
                "edge": init_mlp(gen, [3 * d] + [d] * ml, device),
                "node": init_mlp(gen, [2 * d] + [d] * ml, device),
            }
        return p

    @staticmethod
    def _edge_feat(s, r, positions, edge_feat, dtype) -> torch.Tensor:
        """One edge block's features."""
        if edge_feat is not None:
            return edge_feat
        if positions is not None:
            rel = gather_rows(positions, r) - gather_rows(positions, s)
            dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
            return torch.cat([rel, dist], dim=-1)
        # featureless edges: degree-ish placeholder
        return torch.ones((s.shape[0], 4), dtype=dtype, device=s.device)

    def forward(self, params, inputs: GraphInputs) -> torch.Tensor:
        cfg = self.cfg
        ml = cfg.mlp_layers
        n = inputs.n_nodes
        g = graph_view(params)
        s, r = inputs.senders, inputs.receivers
        cd = self.compute_dtype
        nf = node_input(inputs.node_feat)
        x = mlp(g.params["enc_node"], nf.to(cd), ml)
        e = g.map(lambda q, s, r, pos, ef: mlp(
            q["enc_edge"], self._edge_feat(s, r, pos, ef, nf.dtype).to(cd),
            ml), s, r, inputs.positions, inputs.edge_feat)
        for i in range(cfg.n_layers):
            proc = f"proc{i}"
            e = g.map(lambda q, e, xs, xr: e + mlp(q[proc]["edge"], torch.cat(
                [e, xs, xr], dim=-1), ml), e, g.node_rows(x, s),
                g.node_rows(x, r))
            agg = g.aggregate(e, r, n)
            x = x + mlp(g.params[proc]["node"], torch.cat([x, agg], dim=-1),
                        ml)
        return mlp(g.params["dec"], x, ml)
