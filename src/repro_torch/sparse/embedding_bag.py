"""EmbeddingBag — gather + segment-reduce (PyTorch port of
``repro.sparse.embedding_bag``).

The rows are taken as ``jnp.take`` takes them (:func:`take_rows`) and
reduced by the port's fixed-order :func:`segment_sum` or by
:func:`segment_max`, so a bag sums its rows in index order on either
device. ``torch.nn.functional.embedding_bag`` is not used: its CUDA sum
order and its handling of ids out of range are not JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sparse.segment import segment_max, segment_sum, take_rows


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: Optional[torch.Tensor] = None,
                  bag_ids: Optional[torch.Tensor] = None,
                  n_bags: Optional[int] = None,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged bag-reduce over embedding rows.

    Either ``offsets`` (torch-style, bag b = indices[offsets[b]:offsets[b+1]])
    or explicit ``bag_ids`` per index may be given.
    """
    if bag_ids is None:
        if offsets is None:
            raise ValueError("embedding_bag needs offsets or bag_ids")
        n_bags = offsets.shape[0]
        positions = torch.arange(indices.shape[0], device=indices.device,
                                 dtype=offsets.dtype)
        # bag_ids[i] = number of offsets <= i, less one
        bag_ids = torch.searchsorted(offsets, positions, right=True) - 1
    if n_bags is None:
        raise ValueError("embedding_bag with bag_ids needs n_bags")
    rows = take_rows(table, indices)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    if mode == "sum":
        return segment_sum(rows, bag_ids, n_bags)
    if mode == "mean":
        tot = segment_sum(rows, bag_ids, n_bags)
        cnt = segment_sum(torch.ones(bag_ids.shape, dtype=rows.dtype,
                                     device=rows.device), bag_ids, n_bags)
        return tot / torch.clamp_min(cnt, 1.0)[:, None]
    if mode == "max":
        return segment_max(rows, bag_ids, n_bags)
    raise ValueError(f"unknown mode {mode!r}")
