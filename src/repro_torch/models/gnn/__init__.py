"""SchNet, DimeNet, MeshGraphNet and GraphCast (PyTorch port of
``repro.models.gnn``); every aggregation is the fixed-order
``repro_torch.sparse.segment_sum``."""

from repro_torch.models.gnn.common import GraphInputs, make_model

__all__ = ["GraphInputs", "make_model"]
