"""Plain PyTorch versions of the two ELL kernels.

They compute the same functions as the CUDA kernels in ``csrc/`` with
ordinary tensor ops — gather + ``einsum`` + ``index_add_`` for the SpMM,
gather + masked max + ``scatter_reduce(amax)`` + the clamp for the reach
sweep — and serve the CPU path of the wrappers in ``ops.py`` and the
kernel-vs-plain checks on the card. Rows are processed in chunks so the
``(rows, K, d)`` gather stays bounded at the full mirror's shapes.
"""

from __future__ import annotations

import torch

_CHUNK_ELEMS = 1 << 26  # gathered floats per chunk (256 MiB)


def _chunks(r: int, k: int, d: int):
    step = max(1, _CHUNK_ELEMS // max(k * d, 1))
    for lo in range(0, r, step):
        yield lo, min(r, lo + step)


def ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
                 row_ids: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """``y[v,:] = Σ_{rows r of v} Σ_k mask·vals·x[cols[r,k],:]`` → (n, d)."""
    r, k = cols.shape
    d = x.shape[1]
    w = torch.where(mask, vals, torch.zeros_like(vals)).to(x.dtype)
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for lo, hi in _chunks(r, k, d):
        gathered = x[cols[lo:hi].to(torch.int64)]          # (rows, K, d)
        partial = torch.einsum("rk,rkd->rd", w[lo:hi], gathered)
        y.index_add_(0, row_ids[lo:hi].to(torch.int64), partial)
    return y


def ell_reach_ref(cols: torch.Tensor, mask: torch.Tensor,
                  row_ids: torch.Tensor, x: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``y[v,:] = max(0, max_{rows r of v} max_k mask·x[cols[r,k],:])`` for
    indicator ``x ∈ [0, 1]`` → (n, d); vertices with no row get 0."""
    r, k = cols.shape
    d = x.shape[1]
    y = torch.full((n, d), float("-inf"), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for lo, hi in _chunks(r, k, d):
        gathered = torch.where(mask[lo:hi, :, None],
                               x[cols[lo:hi].to(torch.int64)], zero)
        partial = gathered.amax(dim=1)                      # (rows, d)
        idx = row_ids[lo:hi].to(torch.int64)[:, None].expand(-1, d)
        y.scatter_reduce_(0, idx, partial, reduce="amax", include_self=True)
    # vertices owning no row come out of the max at -inf; reach wants 0
    return torch.clamp(y, min=0.0)
