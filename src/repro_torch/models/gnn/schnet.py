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
                                           gaussian_rbf, init_mlp, mlp)
from repro_torch.sparse.segment import gather_rows, segment_sum


def _ssp(x):
    """Shifted softplus, SchNet's activation: ``jax.nn.softplus(x) -
    log 2``, softplus as JAX's ``logaddexp(x, 0)`` (its gradient at 0 is
    1/2, where a clamp's would be 1)."""
    return torch.logaddexp(x, x.new_zeros(())) - math.log(2.0)


class SchNet(GNNBase):
    def init(self, gen: torch.Generator, d_feat: int) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_hidden
        p: Dict[str, Any] = {
            "embed": init_mlp(gen, [d_feat, d]),
            "out": init_mlp(gen, [d, d // 2, cfg.d_out]),
        }
        for i in range(cfg.n_layers):
            p[f"int{i}"] = {
                "filt": init_mlp(gen, [cfg.n_rbf, d, d]),
                "in": init_mlp(gen, [d, d]),
                "post": init_mlp(gen, [d, d, d]),
            }
        return p

    def forward(self, params, inputs: GraphInputs) -> torch.Tensor:
        cfg = self.cfg
        n = inputs.n_nodes
        x = mlp(params["embed"], inputs.node_feat.to(self.compute_dtype), 1)
        dist = edge_distances(inputs.positions, inputs.senders,
                              inputs.receivers)
        rbf = gaussian_rbf(dist, cfg.n_rbf, cfg.cutoff).to(x.dtype)
        cut = cosine_cutoff(dist, cfg.cutoff).to(x.dtype)
        for i in range(cfg.n_layers):
            ip = params[f"int{i}"]
            w = mlp(ip["filt"], rbf, 2, act=_ssp, final_act=False)
            w = w * cut[:, None]
            h = mlp(ip["in"], x, 1)
            msg = gather_rows(h, inputs.senders) * w
            agg = segment_sum(msg, inputs.receivers, n)
            x = x + mlp(ip["post"], agg, 2, act=_ssp)
        return mlp(params["out"], x, 2, act=_ssp)
