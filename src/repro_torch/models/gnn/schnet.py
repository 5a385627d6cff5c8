"""SchNet (Schütt et al., arXiv:1706.08566) — continuous-filter
convolutions (PyTorch port of ``repro.models.gnn.schnet``).

Assigned config: n_interactions=3, d_hidden=64, rbf=300, cutoff=10.
cfconv: W(d_ij) = filter-MLP(rbf(d_ij))·cutoff(d_ij); message = x_j ⊙ W(d_ij);
aggregate by the fixed-order segment_sum; atom-wise dense layers between
interactions.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models.gnn.common import (GNNBase, GraphInputs,
                                           cosine_cutoff, edge_distances,
                                           gaussian_rbf, graph_view,
                                           init_mlp, mlp, node_input)


def _ssp(x):
    """Shifted softplus, SchNet's activation: ``jax.nn.softplus(x) -
    log 2``, softplus as JAX's ``logaddexp(x, 0)`` (its gradient at 0 is
    1/2, where a clamp's would be 1)."""
    return torch.logaddexp(x, x.new_zeros(())) - math.log(2.0)


class SchNet(GNNBase):
    def init(self, gen: torch.Generator, d_feat: int,
             device=None) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_hidden
        p: Dict[str, Any] = {
            "embed": init_mlp(gen, [d_feat, d], device),
            "out": init_mlp(gen, [d, d // 2, cfg.d_out], device),
        }
        for i in range(cfg.n_layers):
            p[f"int{i}"] = {
                "filt": init_mlp(gen, [cfg.n_rbf, d, d], device),
                "in": init_mlp(gen, [d, d], device),
                "post": init_mlp(gen, [d, d, d], device),
            }
        return p

    def forward(self, params, inputs: GraphInputs) -> torch.Tensor:
        cfg = self.cfg
        n = inputs.n_nodes
        g = graph_view(params)
        p = g.params
        s, r = inputs.senders, inputs.receivers
        x = mlp(p["embed"], node_input(inputs.node_feat).to(
            self.compute_dtype), 1)
        cd = x.dtype

        def geometry(q, pos, s, r):
            dist = edge_distances(pos, s, r)
            return (gaussian_rbf(dist, cfg.n_rbf, cfg.cutoff).to(cd),
                    cosine_cutoff(dist, cfg.cutoff).to(cd))

        rbf, cut = g.map(geometry, inputs.positions, s, r)
        for i in range(cfg.n_layers):
            ip = p[f"int{i}"]

            def filt(q, rbf, cut, i=i):
                w = mlp(q[f"int{i}"]["filt"], rbf, 2, act=_ssp,
                        final_act=False)
                return w * cut[:, None]

            w = g.map(filt, rbf, cut)
            h = mlp(ip["in"], x, 1)
            msg = g.map(lambda q, hs, w: hs * w, g.node_rows(h, s), w)
            agg = g.aggregate(msg, r, n)
            x = x + mlp(ip["post"], agg, 2, act=_ssp)
        return mlp(p["out"], x, 2, act=_ssp)
