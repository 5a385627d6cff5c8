"""COO (edge-list) sparse ops (PyTorch port of ``repro.sparse.coo``),
through :func:`repro_torch.sparse.segment.segment_sum`, so they sum in its
fixed order."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sparse.segment import gather_rows, segment_sum


def scatter_add(messages: torch.Tensor, receivers: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Aggregate per-edge messages into per-node sums: (E, d) → (N, d)."""
    return segment_sum(messages, receivers, n_nodes)


def coo_spmm(senders: torch.Tensor, receivers: torch.Tensor,
             weights: torch.Tensor, x: torch.Tensor, n_nodes: int,
             edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[v] = sum_{(u→v) in E} w_uv * x[u]; padded edges masked out."""
    msg = gather_rows(x, senders) * weights[:, None].to(x.dtype)
    if edge_mask is not None:
        msg = torch.where(edge_mask[:, None], msg, 0.0)
        # route masked edges to a dump row to keep the scatter well-formed
        receivers = torch.where(edge_mask, receivers, n_nodes)
        return segment_sum(msg, receivers, n_nodes + 1)[:n_nodes]
    return segment_sum(msg, receivers, n_nodes)
