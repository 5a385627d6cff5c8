"""The distributed layers (PyTorch port of ``repro.distrib``): the
sharding rules and placement on a mesh (``sharding``), the collectives
(``collectives``), and fault tolerance — the straggler monitor and the
elastic re-mesh (``fault``)."""

from repro_torch.distrib.sharding import (
    batch_axes,
    bst_param_specs,
    gnn_param_specs,
    lm_param_specs,
    state_specs_like,
)

__all__ = [
    "batch_axes",
    "lm_param_specs",
    "gnn_param_specs",
    "bst_param_specs",
    "state_specs_like",
]
