"""meshgraphnet [gnn] — n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2.
[arXiv:2010.03409; unverified]. Values match the JAX package's
``repro.configs.meshgraphnet``."""

from repro_torch.config.base import GNN_SHAPES, ArchConfig, GNNConfig

SOURCE = "arXiv:2010.03409; unverified"

FULL = GNNConfig(dtype="bfloat16", kind="meshgraphnet", n_layers=15, d_hidden=128,
                 aggregator="sum", mlp_layers=2, d_out=3)

SMOKE = GNNConfig(kind="meshgraphnet", n_layers=2, d_hidden=16,
                  aggregator="sum", mlp_layers=2, d_out=3)


def full() -> ArchConfig:
    return ArchConfig("meshgraphnet", "gnn", FULL, GNN_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("meshgraphnet", "gnn", SMOKE, GNN_SHAPES,
                      source=SOURCE)
