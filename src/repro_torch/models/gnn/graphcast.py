"""GraphCast (Lam et al., arXiv:2212.12794) — encoder-processor-decoder
mesh GNN (PyTorch port of ``repro.models.gnn.graphcast``).

Assigned config: n_layers=16, d_hidden=512, mesh_refinement=6,
aggregator=sum, n_vars=227. The assigned graph shape is the GRID; the
icosahedral multimesh at refinement r has 10·4^r+2 nodes and 30·4^r
undirected edges (r=6 → 40,962 nodes / 122,880 edges → 245,760 arcs).
grid2mesh connects each grid node to 4 mesh nodes; mesh2grid connects each
grid node to 3 (containing-triangle) mesh nodes — both are input index
arrays so the data pipeline owns the geometry.

On a mesh (``common.EdgeBlocks``) only the processor's mesh arcs are split
into blocks; the encoder and decoder are node-level work and read the
replicated grid↔mesh maps whole.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.gnn.common import (GNNBase, GraphInputs, graph_view,
                                           init_mlp, mlp, node_input)
from repro_torch.sparse.segment import gather_rows, segment_sum


def mesh_sizes(refinement: int) -> Dict[str, int]:
    nodes = 10 * 4 ** refinement + 2
    arcs = 2 * 30 * 4 ** refinement
    return {"mesh_nodes": nodes, "mesh_arcs": arcs}


class GraphCast(GNNBase):
    """inputs.senders/receivers carry the MESH arcs; grid2mesh / mesh2grid
    assignments ride in inputs.trip_kj / trip_ji (reused index slots):
      trip_kj: (N_grid·4,) mesh node per grid→mesh arc (grid node = i//4)
      trip_ji: (N_grid·3,) mesh node per mesh→grid arc (grid node = i//3)
    """

    G2M, M2G = 4, 3

    def init(self, gen: torch.Generator, d_feat: int,
             device=None) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_hidden
        p: Dict[str, Any] = {
            "enc_grid": init_mlp(gen, [d_feat, d, d], device),
            "g2m": init_mlp(gen, [2 * d, d, d], device),
            "m2g": init_mlp(gen, [2 * d, d, d], device),
            "dec": init_mlp(gen, [2 * d, d, cfg.d_out], device),
            "mesh0": init_mlp(gen, [d, d], device),
        }
        for i in range(cfg.n_layers):
            p[f"proc{i}"] = {
                "edge": init_mlp(gen, [2 * d, d, d], device),
                "node": init_mlp(gen, [2 * d, d, d], device),
            }
        return p

    def forward(self, params, inputs: GraphInputs) -> torch.Tensor:
        cfg = self.cfg
        n_grid = inputs.n_nodes
        n_mesh = mesh_sizes(cfg.mesh_refinement)["mesh_nodes"]
        g = graph_view(params)
        p = g.params
        ms, mr = inputs.senders, inputs.receivers          # mesh arcs
        g2m = node_input(inputs.trip_kj)                   # (n_grid·4,)
        m2g = node_input(inputs.trip_ji)                   # (n_grid·3,)
        node_feat = node_input(inputs.node_feat)
        dev = node_feat.device

        # encoder: grid features → latent; grid2mesh aggregation
        xg = mlp(p["enc_grid"], node_feat.to(self.compute_dtype), 2)
        src_grid = torch.arange(n_grid, device=dev).repeat_interleave(
            self.G2M)
        x_src = gather_rows(xg, src_grid)
        msg = mlp(p["g2m"],
                  torch.cat([x_src, torch.zeros_like(x_src)], -1), 2)
        xm = segment_sum(msg, g2m, n_mesh)
        xm = mlp(p["mesh0"], xm, 1)

        # processor: interaction network on the multimesh
        for i in range(cfg.n_layers):
            proc = f"proc{i}"
            e = g.map(lambda q, xs, xr: mlp(q[proc]["edge"], torch.cat(
                [xs, xr], -1), 2), g.node_rows(xm, ms), g.node_rows(xm, mr))
            agg = g.aggregate(e, mr, n_mesh)
            xm = xm + mlp(p[proc]["node"], torch.cat([xm, agg], -1), 2)

        # decoder: mesh2grid
        dst_grid = torch.arange(n_grid, device=dev).repeat_interleave(
            self.M2G)
        back = mlp(p["m2g"],
                   torch.cat([gather_rows(xm, m2g),
                              gather_rows(xg, dst_grid)], -1), 2)
        xg_out = segment_sum(back, dst_grid, n_grid)
        return mlp(p["dec"], torch.cat([xg, xg_out], -1), 2)
