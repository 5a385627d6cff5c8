"""graphcast [gnn] — n_layers=16 d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227; encoder-processor-decoder mesh GNN.
[arXiv:2212.12794; unverified]. Values match the JAX package's
``repro.configs.graphcast``."""

from repro_torch.config.base import GNN_SHAPES, ArchConfig, GNNConfig

SOURCE = "arXiv:2212.12794; unverified"

FULL = GNNConfig(dtype="bfloat16", kind="graphcast", n_layers=16, d_hidden=512,
                 mesh_refinement=6, n_vars=227, aggregator="sum", d_out=227)

SMOKE = GNNConfig(kind="graphcast", n_layers=2, d_hidden=32,
                  mesh_refinement=1, n_vars=8, aggregator="sum", d_out=8)


def full() -> ArchConfig:
    return ArchConfig("graphcast", "gnn", FULL, GNN_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("graphcast", "gnn", SMOKE, GNN_SHAPES, source=SOURCE)
