"""dimenet [gnn] — n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6. [arXiv:2003.03123; unverified]. Values match the JAX package's
``repro.configs.dimenet``."""

from repro_torch.config.base import GNN_SHAPES, ArchConfig, GNNConfig

SOURCE = "arXiv:2003.03123; unverified"

FULL = GNNConfig(dtype="bfloat16", kind="dimenet", n_layers=6, d_hidden=128, n_bilinear=8,
                 n_spherical=7, n_radial=6, d_out=1, triplets_per_edge=8)

SMOKE = GNNConfig(kind="dimenet", n_layers=2, d_hidden=16, n_bilinear=2,
                  n_spherical=3, n_radial=3, d_out=1, triplets_per_edge=4)


def full() -> ArchConfig:
    return ArchConfig("dimenet", "gnn", FULL, GNN_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("dimenet", "gnn", SMOKE, GNN_SHAPES, source=SOURCE)
