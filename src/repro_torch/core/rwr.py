"""Random Walk with Restart — the goodness signal of G-Ray (paper §III-A).

``r = c·e + (1−c)·Pᵀr`` iterated to (near) fixed point, with the
row-stochastic transition ``P = D⁻¹A``. Two interchangeable sweep backends:

  * ``coo`` — gather + ``index_add_`` over the live COO arcs,
  * ``ell`` — the ELL SpMM kernel (``repro_torch.kernels.spmv_ell``) over
    the incoming-adjacency ELL mirror. Pass the mirror as ``ell=`` (see
    :class:`~repro_torch.core.graph.EllCache`); the transition weights are
    applied by pre-scaling the iterate with 1/deg, so the mirror only needs
    structural refreshes.

Many restart vectors run as one ``(n, S)`` dense block, and the
*incremental* variant warm-starts from the previous fixed point and needs
only a few sweeps. With ``rwr_adaptive`` the sweep count is measured: the
loop stops as soon as every column's ∞-norm residual drops to ``tol`` (a
hard cap bounds the trip count); a converged column freezes while the
stragglers keep sweeping, and the retired column-sweeps are counted
(``n_col_skipped``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.graph import DynamicGraph, transition_weights
from repro_torch.kernels.spmv_ell import ops as ell_ops
from repro_torch.sparse.ell import EllGraph


def _combine(e: torch.Tensor, agg: torch.Tensor, c: float) -> torch.Tensor:
    """``c·e + (1−c)·agg`` as two products and then an add — three separate
    eager ops, so the multiply-add is never contracted into an FMA and the
    rounding matches on every device."""
    ce = c * e
    scaled = (1.0 - c) * agg
    return ce + scaled


def _sweep(g: DynamicGraph, w: torch.Tensor, r: torch.Tensor,
           e: torch.Tensor, c: float) -> torch.Tensor:
    """One power-iteration sweep over all restart columns: (n, S) → (n, S)."""
    msg = r[g.senders.to(torch.int64)] * w[:, None]          # (E, S)
    agg = torch.zeros_like(r).index_add_(0, g.receivers.to(torch.int64), msg)
    return _combine(e, agg, c)


def _sweep_ell(ell: EllGraph, inv_deg: torch.Tensor, r: torch.Tensor,
               e: torch.Tensor, c: float) -> torch.Tensor:
    """ELL-backend sweep: agg[v] = Σ_{u→v} r[u]/deg(u) via the kernel.

    The per-arc weight 1/deg(sender) depends only on the *column* vertex, so
    it factors out of the gather: A_in @ (r ⊙ inv_deg) — the mirror carries
    unit weights and never needs a weight refresh.
    """
    agg = ell_ops.ell_spmm(ell.cols, ell.vals, ell.mask, ell.row_ids,
                           r * inv_deg[:, None], ell.n,
                           index=ell.row_index())
    return _combine(e, agg, c)


def _sweep_fn(g: DynamicGraph, e: torch.Tensor, c: float,
              ell: Optional[EllGraph]):
    """The per-iteration sweep closure for either backend."""
    if ell is None:
        w = transition_weights(g)
        return lambda r: _sweep(g, w, r, e, c)
    inv_deg = 1.0 / torch.clamp(g.degree, min=1.0)
    return lambda r: _sweep_ell(ell, inv_deg, r, e, c)


def rwr(g: DynamicGraph, e: torch.Tensor, iters: int = 30, c: float = 0.15,
        r0: Optional[torch.Tensor] = None,
        ell: Optional[EllGraph] = None) -> torch.Tensor:
    """Batched RWR. ``e``: (n_max, S) restart distributions (columns sum ≤ 1).

    ``r0`` warm-starts the iteration (incremental mode); defaults to ``e``.
    ``ell`` selects the ELL sweep backend (must mirror ``g``'s live arcs);
    ``None`` keeps the COO path.
    """
    r = e if r0 is None else r0
    sweep = _sweep_fn(g, e, c, ell)
    for _ in range(iters):
        r = sweep(r)
    return r


def rwr_adaptive(g: DynamicGraph, e: torch.Tensor, max_iters: int = 30,
                 tol: float = 1e-4, c: float = 0.15,
                 r0: Optional[torch.Tensor] = None,
                 ell: Optional[EllGraph] = None
                 ) -> Tuple[torch.Tensor, int, int]:
    """Residual-adaptive RWR → ``(r, n_sweeps, n_col_skipped)``.

    Sweeps until every column's ∞-norm residual drops to ``tol`` or
    ``max_iters``, whichever first. Convergence is tracked PER COLUMN: a
    column whose residual is already ≤ ``tol`` keeps its current value
    (bitwise stable from then on) while the stragglers sweep, and
    ``n_col_skipped`` totals the column-sweeps the mask retired. One count
    of the live columns comes to the host per sweep: it both ends the loop
    and feeds the skip count.
    """
    r = e if r0 is None else r0
    sweep = _sweep_fn(g, e, c, ell)
    n_cols = r.shape[1]
    active = torch.ones(n_cols, dtype=torch.bool, device=r.device)
    i = 0
    skipped = 0
    while i < max_iters:
        n_active = int(active.sum())
        if n_active == 0:
            break
        r_new = sweep(r)
        res = (r_new - r).abs().amax(dim=0)                  # (S,)
        take = active & (res > tol)
        skipped += n_cols - n_active
        r = torch.where(take[None, :], r_new, r)
        active = take
        i += 1
    return r, i, skipped


def restart_onehot(ids: torch.Tensor, n_max: int) -> torch.Tensor:
    """(S,) vertex ids → (n_max, S) one-hot restart matrix (ids outside
    ``[0, n_max)`` give an all-zero column)."""
    ids = ids.to(torch.int64)
    e = torch.zeros((n_max, ids.shape[0]), dtype=torch.float32,
                    device=ids.device)
    ok = (ids >= 0) & (ids < n_max)
    col = torch.arange(ids.shape[0], device=ids.device)
    e[ids[ok], col[ok]] = 1.0
    return e


def label_restarts(g: DynamicGraph, n_labels: int) -> torch.Tensor:
    """(n_max, L) restart matrix: column ℓ uniform over live label-ℓ."""
    onehot = (g.labels[:, None].to(torch.int64)
              == torch.arange(n_labels, device=g.labels.device)[None, :]
              ).to(torch.float32)
    onehot = onehot * g.node_mask[:, None]
    counts = torch.clamp(onehot.sum(dim=0, keepdim=True), min=1.0)
    return onehot / counts


def label_rwr(g: DynamicGraph, n_labels: int, iters: int = 30,
              c: float = 0.15, r0: Optional[torch.Tensor] = None,
              ell: Optional[EllGraph] = None) -> torch.Tensor:
    """Label-conditioned RWR table r_lab: (n_max, L).

    Column ℓ is the RWR fixed point whose restart distribution is uniform
    over live vertices with label ℓ; r_lab[v, ℓ] is the proximity between v
    and the label-ℓ population — the seed-finder goodness input.
    """
    e = label_restarts(g, n_labels)
    return rwr(g, e, iters=iters, c=c, r0=r0, ell=ell)


def label_rwr_adaptive(g: DynamicGraph, n_labels: int, max_iters: int = 30,
                       tol: float = 1e-4, c: float = 0.15,
                       r0: Optional[torch.Tensor] = None,
                       ell: Optional[EllGraph] = None
                       ) -> Tuple[torch.Tensor, int, int]:
    """Residual-adaptive :func:`label_rwr` →
    ``(r_lab, n_sweeps, n_col_skipped)``."""
    e = label_restarts(g, n_labels)
    return rwr_adaptive(g, e, max_iters=max_iters, tol=tol, c=c, r0=r0,
                        ell=ell)


def rwr_residual(g: DynamicGraph, r: torch.Tensor, e: torch.Tensor,
                 c: float = 0.15,
                 ell: Optional[EllGraph] = None) -> torch.Tensor:
    """‖r − (c·e + (1−c)·Pᵀr)‖∞ per column — convergence diagnostics."""
    nxt = _sweep_fn(g, e, c, ell)(r)
    return (nxt - r).abs().amax(dim=0)
