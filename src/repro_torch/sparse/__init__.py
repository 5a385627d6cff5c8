"""Sparse layouts and ops: segment reductions, ELL, COO, embedding bags
and the neighbor sampler (PyTorch port of ``repro.sparse``)."""

from repro_torch.sparse.segment import (segment_max, segment_mean,
                                        segment_softmax, segment_sum)
from repro_torch.sparse.ell import EllGraph, build_ell, ell_spmm, ell_spmv
from repro_torch.sparse.coo import coo_spmm, scatter_add
from repro_torch.sparse.embedding_bag import embedding_bag
from repro_torch.sparse.sampler import NeighborSampler

__all__ = [
    "segment_sum",
    "segment_max",
    "segment_mean",
    "segment_softmax",
    "EllGraph",
    "build_ell",
    "ell_spmv",
    "ell_spmm",
    "coo_spmm",
    "scatter_add",
    "embedding_bag",
    "NeighborSampler",
]
