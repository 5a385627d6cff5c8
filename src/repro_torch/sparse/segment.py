"""Segment reductions and gathers with JAX's index semantics — the GNN
message-passing primitive (PyTorch port of ``repro.sparse.segment``).

Every segment sum of the port goes through :func:`segment_sum`, so its
order lives here: each segment's rows are added in ascending row order,
starting from zero, with no float atomics. On a CUDA tensor it is an
accumulating ``index_put_``, which CUDA runs sorted: a stable radix sort
of the ids, then each segment's rows added in sorted (so ascending) order.
Data of one column would take CUDA's warp-reduction kernel for a slice of
one element, whose order is fixed but not ascending, so a 1-D sum is taken
as the first column of a two-column sum. On a CPU tensor it is
``index_add``, a serial loop over the rows (the CPU's accumulating
``index_put_`` splits rows over threads), so f32 sums are the card's bit
for bit, and the reference's; a meta tensor (the dry run's) takes the same
route, so a dry run counts one add per element. The backward of the sum is
a gather, and the backward of the gathers below (advanced indexing) is
again an accumulating ``index_put_``: no ``index_add_``, ``scatter_add_``,
``torch.gather`` or ``index_select`` is differentiated on CUDA on these
paths.

JAX's index semantics, which the reference relies on (``sparse/coo.py``
routes masked arcs to a dump row ``n``; padded cells carry id ``n``):

- a scatter (:func:`segment_sum`, :func:`segment_max`) drops ids outside
  ``[0, num_segments)``, negative ones too;
- NumPy-style indexing ``x[idx]`` (:func:`gather_rows`) counts a negative
  id from the end, then clamps into ``[0, n)``;
- ``jnp.take`` and ``jnp.take_along_axis`` (:func:`take_rows`,
  :func:`take_along_fields`) count a negative id ≥ -n from the end and
  fill ids outside ``[-n, n)`` with NaN.

Torch raises on such ids on the CPU and fires a device-side assert on
CUDA, so each function here maps them first. ``segment_max`` of an empty
segment is ``-inf`` (the dtype's least value for integers), as in JAX.
"""

from __future__ import annotations

import torch


def _kept(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids as int64, those outside ``[0, num_segments)`` routed to the dump
    row ``num_segments``."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    return torch.where(keep, ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ data[i]`` over ``segment_ids[i] == s``, rows added in
    ascending ``i`` from zero; ids outside ``[0, num_segments)`` dropped."""
    ids = _kept(segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    if data.device.type in ("cpu", "meta"):
        # a serial loop over the rows in order; the CPU's accumulating
        # index_put_ splits the rows over threads (on meta tensors, the
        # dry run's, the same route: one add per element, as the CPU's)
        return out.index_add(0, ids, data)[:num_segments]
    if data.dim() == 1:
        two = torch.stack([data, torch.zeros_like(data)], dim=1)
        return segment_sum(two, ids, num_segments)[:, 0]
    out = out.index_put((ids,), data, accumulate=True)
    return out[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maximum; an empty segment gives ``-inf`` (the least
    value of an integer dtype); ids outside the range dropped."""
    ids = _kept(segment_ids, num_segments)
    low = (float("-inf") if data.is_floating_point()
           else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), low)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = out.scatter_reduce(0, index, data, "amax", include_self=True)
    return out[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                                 device=data.device), segment_ids,
                      num_segments)
    cnt = torch.clamp_min(cnt, 1)
    if data.dim() > 1:
        cnt = cnt.reshape((-1,) + (1,) * (data.dim() - 1))
    return tot / cnt


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically-stable softmax within each segment (edge-softmax)."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    # empty segments give a -inf max; the gather never reads them, since
    # their ids do not appear in segment_ids
    shifted = logits - gather_rows(seg_max, segment_ids)
    expd = torch.exp(shifted)
    denom = segment_sum(expd, segment_ids, num_segments)
    return expd / torch.clamp_min(gather_rows(denom, segment_ids), 1e-30)


def from_end(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Ids as int64, a negative one counted from the end (``idx + n``)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as JAX indexes: a negative id counts from the end, then
    every id is clamped into ``[0, len(x))``."""
    n = x.shape[0]
    return x[from_end(idx, n).clamp(0, n - 1)]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)``: rows of ``table``; a negative id
    ≥ -n counts from the end, an id outside ``[-n, n)`` gives a NaN row."""
    n = table.shape[0]
    j = from_end(idx, n)
    valid = (j >= 0) & (j < n)
    rows = table[j.clamp(0, n - 1)]
    return rows.masked_fill(~valid.reshape(valid.shape + (1,) * (
        rows.dim() - valid.dim())), float("nan"))


def take_along_fields(tables: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """``take_along_axis(tables[None], ids[:, :, None, None], axis=2)``:
    ``tables`` (F, V, e), ``ids`` (B, F) → (B, F, e), row ``ids[b, f]`` of
    table ``f``, with :func:`take_rows`' semantics for ids out of range."""
    F, V = tables.shape[:2]
    j = from_end(ids, V)
    valid = (j >= 0) & (j < V)
    fields = torch.arange(F, device=ids.device)[None, :]
    rows = tables[fields, j.clamp(0, V - 1)]
    return rows.masked_fill(~valid[..., None], float("nan"))
