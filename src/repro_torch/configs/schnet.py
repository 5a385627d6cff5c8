"""schnet [gnn] — n_interactions=3 d_hidden=64 rbf=300 cutoff=10.
[arXiv:1706.08566; paper]. Values match the JAX package's
``repro.configs.schnet``."""

from repro_torch.config.base import GNN_SHAPES, ArchConfig, GNNConfig

SOURCE = "arXiv:1706.08566; paper"

FULL = GNNConfig(dtype="bfloat16", kind="schnet", n_layers=3, d_hidden=64, n_rbf=300,
                 cutoff=10.0, d_out=1)

SMOKE = GNNConfig(kind="schnet", n_layers=2, d_hidden=16, n_rbf=16,
                  cutoff=5.0, d_out=1)


def full() -> ArchConfig:
    return ArchConfig("schnet", "gnn", FULL, GNN_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("schnet", "gnn", SMOKE, GNN_SHAPES, source=SOURCE)
