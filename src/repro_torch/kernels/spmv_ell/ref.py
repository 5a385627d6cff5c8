"""Plain PyTorch versions of the two ELL kernels.

They compute the same functions as the CUDA kernels in ``csrc/`` with
ordinary tensor ops — per-slot gathers, multiplies and adds +
``index_add_`` for the SpMM, gather + masked max +
``scatter_reduce(amax)`` + the clamp for the reach sweep — and serve
the CPU path of the wrappers in ``ops.py`` and the kernel-vs-plain
checks on the card. Rows are processed in chunks so the gathers stay
bounded at the full mirror's shapes.

``ell_row_partials_ref`` and ``ell_row_maxima_ref`` are the first of the
two phases on their own: the unreduced per-row partial sums and maxima
(the functions of the JAX package's two Pallas kernels), before the
segment sum or max over ``row_ids``.
"""

from __future__ import annotations

import torch

_CHUNK_ELEMS = 1 << 26  # gathered floats per chunk (256 MiB)


def _chunks(r: int, k: int, d: int):
    step = max(1, _CHUNK_ELEMS // max(k * d, 1))
    for lo in range(0, r, step):
        yield lo, min(r, lo + step)


def ell_row_partials_ref(cols: torch.Tensor, vals: torch.Tensor,
                         mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``p[r,:] = Σ_k mask·vals·x[cols[r,k],:]`` per ELL row → (R, d), summed
    in ascending k by one elementwise multiply and one add per slot."""
    w = torch.where(mask, vals, torch.zeros_like(vals)).to(x.dtype)
    c = cols.to(torch.int64)
    partial = torch.zeros((cols.shape[0], x.shape[1]), dtype=x.dtype,
                          device=x.device)
    for j in range(cols.shape[1]):
        partial = partial + w[:, j, None] * x[c[:, j]]
    return partial


def ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
                 row_ids: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """``y[v,:] = Σ_{rows r of v} Σ_k mask·vals·x[cols[r,k],:]`` → (n, d).

    Each row's partial is summed in ascending k (``ell_row_partials_ref``),
    and the partials are added to their vertex in row order, so a column's
    value never depends on how many other columns ride along (a batched
    matmul picks its summation order by shape): a sweep block split over
    the query axis gives the bits of the whole block."""
    r = cols.shape[0]
    d = x.shape[1]
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for lo, hi in _chunks(r, 1, d):
        partial = ell_row_partials_ref(cols[lo:hi], vals[lo:hi],
                                       mask[lo:hi], x)
        y.index_add_(0, row_ids[lo:hi].to(torch.int64), partial)
    return y


def ell_row_maxima_ref(cols: torch.Tensor, mask: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """``p[r,:] = max_k mask·x[cols[r,k],:]`` per ELL row → (R, d); a masked
    slot counts as 0."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    gathered = torch.where(mask[..., None], x[cols.to(torch.int64)], zero)
    return gathered.amax(dim=1)


def ell_reach_ref(cols: torch.Tensor, mask: torch.Tensor,
                  row_ids: torch.Tensor, x: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``y[v,:] = max(0, max_{rows r of v} max_k mask·x[cols[r,k],:])`` for
    indicator ``x ∈ [0, 1]`` → (n, d); vertices with no row get 0."""
    r, k = cols.shape
    d = x.shape[1]
    y = torch.full((n, d), float("-inf"), dtype=x.dtype, device=x.device)
    for lo, hi in _chunks(r, k, d):
        partial = ell_row_maxima_ref(cols[lo:hi], mask[lo:hi], x)
        idx = row_ids[lo:hi].to(torch.int64)[:, None].expand(-1, d)
        y.scatter_reduce_(0, idx, partial, reduce="amax", include_self=True)
    # vertices owning no row come out of the max at -inf; reach wants 0
    return torch.clamp(y, min=0.0)
