"""Error-feedback top-k gradient compression (PyTorch port of
``repro.optim.compression``).

Before the cross-pod gradient all-reduce, each leaf keeps only its top
``ratio`` fraction of entries by magnitude; the residual is carried into
the next step's gradient (error feedback). k = max(1, ⌊ratio · size⌋)
per leaf; the threshold is the k-th largest |value| (``torch.topk``) and
the mask is ``|x| >= threshold``, as in the reference, so ties with the
k-th value are all kept. The sent tensor stays dense; the sparse wire
format is ``distrib.collectives.sparse_allreduce``. As in the reference,
no train step applies it (``TrainConfig.grad_compression`` is wired into
none).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import tree_map


class CompressionState(NamedTuple):
    residual: Any  # same structure/shapes as grads, f32


def compression_init(params) -> CompressionState:
    return CompressionState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _topk_mask(x: torch.Tensor, ratio: float) -> torch.Tensor:
    flat = torch.abs(x).reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    thresh = torch.topk(flat, k).values[-1]
    return torch.abs(x) >= thresh


class _Sent:
    """One leaf's (sent, residual), a leaf to ``tree_map``."""

    def __init__(self, g: torch.Tensor, r: torch.Tensor, ratio: float):
        acc = g.float() + r
        sent = torch.where(_topk_mask(acc, ratio), acc, 0.0)
        self.sent, self.residual = sent.to(g.dtype), acc - sent


def compress_grads(grads, state: CompressionState,
                   ratio: float) -> Tuple[Any, CompressionState]:
    """Returns (sparsified grads, new residual state)."""
    if ratio >= 1.0:
        return grads, state
    pairs = tree_map(lambda g, r: _Sent(g, r, ratio), grads, state.residual)
    return (tree_map(lambda p: p.sent, pairs),
            CompressionState(tree_map(lambda p: p.residual, pairs)))
