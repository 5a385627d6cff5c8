"""DimeNet (Gasteiger et al., arXiv:2003.03123) — directional message
passing (PyTorch port of ``repro.models.gnn.dimenet``).

Assigned config: n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6. Messages live on DIRECTED EDGES; each interaction block routes
message m_kj into m_ji through a spherical-basis bilinear layer over the
angle ∠(kj, ji): the triplet gather/scatter regime. Triplet index lists
(trip_kj, trip_ji) are inputs, precomputed by the data pipeline.

The bilinear layer ``einsum("td,dbe,tb->te", x_kj, W, a)`` contracts
``x_kj`` with ``W`` first — one (T, d) × (d, nb·e) product — then sums
the nb slices weighted by ``a``, so no (T, d, nb, e) tensor is formed.
``arccos``, ``sin`` and ``cos`` round differently from XLA's by a few
ulps, and the sums run in another order, so the port agrees with the
reference within a tolerance (``tests/test_torch_gnn.py``), not bitwise.

On a mesh (``common.EdgeBlocks``) the triplets split like the edges, and
both index the whole edge list: a triplet block reads the senders,
receivers, distances and each layer's ``mt`` whole (``edge_table``, an
``edge_gather``), and its sums into the edges come back to their blocks
(``edge_sums``, an ``edge_scatter``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.gnn.common import (GNNBase, GraphInputs,
                                           edge_distances, graph_view,
                                           init_mlp, mlp)
from repro_torch.sparse.segment import gather_rows


def _radial_basis(d: torch.Tensor, n_radial: int,
                  cutoff: float) -> torch.Tensor:
    """Sine Bessel basis: sqrt(2/c)·sin(nπd/c)/d."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    dc = torch.clamp_min(d[:, None], 1e-6)
    # the reference's jnp.sqrt of the f32 scalar 2/c
    scale = float(np.sqrt(np.float32(2.0 / cutoff)))
    return scale * torch.sin(n * math.pi * dc / cutoff) / dc


def _spherical_basis(angle: torch.Tensor, d_kj: torch.Tensor,
                     n_spherical: int, n_radial: int,
                     cutoff: float) -> torch.Tensor:
    """Simplified a_{SBF}: cos(l·θ) ⊗ radial(d) — (T, n_spherical·n_radial)."""
    l = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    ang = torch.cos(l[None, :] * angle[:, None])              # (T, S)
    rad = _radial_basis(d_kj, n_radial, cutoff)                # (T, R)
    return (ang[:, :, None] * rad[:, None, :]).reshape(angle.shape[0], -1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


class DimeNet(GNNBase):
    def init(self, gen: torch.Generator, d_feat: int,
             device=None) -> Dict[str, Any]:
        cfg = self.cfg
        d, nb = cfg.d_hidden, cfg.n_bilinear
        sbf = cfg.n_spherical * cfg.n_radial
        dev = gen.device if device is None else device
        p: Dict[str, Any] = {
            "embed_edge": init_mlp(gen, [2 * d_feat + cfg.n_radial, d], dev),
            "out": init_mlp(gen, [d, d, cfg.d_out], dev),
        }
        for i in range(cfg.n_layers):
            p[f"blk{i}"] = {
                "sbf_w": torch.randn((sbf, nb), generator=gen,
                                     device=dev) * 0.1,
                "bilinear": torch.randn((d, nb, d), generator=gen,
                                        device=dev) * (1.0 / d),
                "msg": init_mlp(gen, [d, d], dev),
                "rbf_w": init_mlp(gen, [cfg.n_radial, d], dev),
                "update": init_mlp(gen, [d, d, d], dev),
            }
        return p

    def forward(self, params, inputs: GraphInputs) -> torch.Tensor:
        cfg = self.cfg
        cutoff = 10.0
        cd = self.compute_dtype
        n, e = inputs.n_nodes, inputs.n_edges
        g = graph_view(params)
        pos = inputs.positions
        s, r = inputs.senders, inputs.receivers
        kj, ji = inputs.trip_kj, inputs.trip_ji
        d, nb = cfg.d_hidden, cfg.n_bilinear

        def embed(q, pos, nf, s, r):
            dist = edge_distances(pos, s, r)
            rbf = _radial_basis(dist, cfg.n_radial, cutoff)
            # edge embedding from endpoint features + rbf
            h0 = torch.cat([gather_rows(nf, s), gather_rows(nf, r), rbf],
                           dim=-1).to(cd)
            return dist, rbf, mlp(q["embed_edge"], h0, 1)    # m: (E, d)

        dist, rbf, m = g.map(embed, pos, inputs.node_feat, s, r)

        # triplet geometry: angle between edge kj and edge ji at shared j
        def angles(q, pos, s, r, dist, kj, ji):
            s_kj, r_kj = gather_rows(s, kj), gather_rows(r, kj)
            s_ji, r_ji = gather_rows(s, ji), gather_rows(r, ji)
            v_kj = gather_rows(pos, r_kj) - gather_rows(pos, s_kj)
            v_ji = gather_rows(pos, r_ji) - gather_rows(pos, s_ji)
            cosang = (v_kj * v_ji).sum(-1) / torch.clamp_min(
                _norm(v_kj) * _norm(v_ji), 1e-9)
            angle = torch.arccos(torch.clamp(cosang, -1.0 + 1e-6,
                                             1.0 - 1e-6))
            sbf = _spherical_basis(angle, gather_rows(dist, kj),
                                   cfg.n_spherical, cfg.n_radial, cutoff)
            return sbf.to(cd)                                 # (T, S·R)

        sbf = g.map(angles, pos, g.edge_table(s), g.edge_table(r),
                    g.edge_table(dist), kj, ji)

        for i in range(cfg.n_layers):
            blk = f"blk{i}"
            mt = g.map(lambda q, m: mlp(q[blk]["msg"], m, 1), m)  # (E, d)

            # directional message: bilinear over spherical basis (T triplets)
            def bilinear(q, sbf, mt, kj):
                bp = q[blk]
                a = sbf @ bp["sbf_w"].to(cd)                  # (T, nb)
                x_kj = gather_rows(mt, kj)                    # (T, d)
                w = bp["bilinear"].to(cd).reshape(d, nb * d)
                T = kj.shape[0]
                y = (x_kj @ w).reshape(T, nb, d)              # (T, nb, d)
                return (y * a[:, :, None]).sum(dim=1)         # (T, d)

            t_msg = g.map(bilinear, sbf, g.edge_table(mt), kj)
            agg = g.edge_sums(t_msg, ji, e)

            def update(q, m, agg, rbf):
                gate = mlp(q[blk]["rbf_w"], rbf.to(cd), 1)
                return m + mlp(q[blk]["update"], agg * gate, 2)

            m = g.map(update, m, agg, rbf)

        # output: edge → node scatter
        node = g.aggregate(m, r, n)
        return mlp(g.params["out"], node, 2)
