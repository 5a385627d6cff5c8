"""Sparse layouts (ELL). The JAX package's segment, COO, embedding-bag
and sampler modules wait for the GNNs and BST (ROADMAP items 13.3 and
13.4)."""

from repro_torch.sparse.ell import EllGraph, build_ell, ell_spmm, ell_spmv

__all__ = ["EllGraph", "build_ell", "ell_spmv", "ell_spmm"]
