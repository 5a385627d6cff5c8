"""The collectives of the sharded train step, and the reference's
``sparse_allreduce`` / ``hierarchical_psum`` (PyTorch port of
``repro.distrib.collectives``).

One process drives every mesh position, so a collective is an explicit
copy or sum over the positions' tensors in a fixed order, with no float
atomics: the results do not depend on how many devices the mesh names.
Each one adds the bytes it moves between positions to ``mesh.bytes``
under its name (``all_gather``, ``all_gather_grad``, ``expert_send``,
``node_send``, ``user_send``, ``grad_psum``, ``grad_send``,
``norm_gather``, ``reshard``, ``edge_psum``, ``edge_gather``,
``edge_scatter``, ``emb_ids_home``, ``emb_rows_fold``,
``emb_grad_gather``, ``emb_rows_permute``, ``emb_grad_permute``,
``emb_ids_permute``, ``emb_ids_gather``,
``emb_rows_model``, ``emb_rows_data``, ``emb_rows_relayout``,
``emb_rows_home``, ``emb_grad_data``, ``emb_grad_home``, ``tp_act``,
``tp_partial``, ``tp_grad_act``, ``tp_grad_partial``, ``xent_stats``,
``tp_zero_gather``, ``tp_zero_scatter``, ``tp_model_sum``,
``tp_heads_gather``, ``expert_gather``, ``tp_rows_gather``,
``tp_rows_scatter``, ``tp_logits_gather``, ``tp_resplit``,
``moe_group_probs``, ``moe_group_probs_grad``, ``moe_group_dispatch``,
``loss_sum``, ``moe_aux_sum``, ``norm_sum``, ``prefill_span``,
``train_span``, ``sparse_allreduce``, ``hierarchical_psum``), and,
where it names both ends, under its source and receiver (``Mesh.moves``),
so a dry run can read the collective bytes from the mesh.
The step's collectives (and its AdamW) also run under
``torch.profiler.record_function`` ranges named in :data:`SPANS`, so a
profile attributes device time to them.

The step's view of one leaf for one batch shard is a :class:`ShardView`:
its blocks as leaves that collect that batch shard's gradient (they share
the shards' storage). ``full()`` all-gathers them onto the batch shard's
device; the gather's backward hands each block its slice of the gradient.
``blocks()`` leaves an expert weight where it lives (:class:`Blocks`):
``moe_block`` sends each expert shard's slice of the dispatch buffer there
(:func:`send`) and brings the products back. ``take_rows`` and
``take_along_fields`` look rows up in a table split along its rows (BST's
item table, the LM's ``embed`` under ``fsdp``) or its vocab axis (BST's
user tables) where the rows lie, as the reference's partitioner forms the
lookup (:func:`take_rows_where_they_lie`; ``HomeViews.take_rows`` looks
several homes' batch up at once), so the table is never gathered whole.
The LM's ``embed`` under ``tp2d``, split on its rows over "model" and its
columns over "data", is looked up as the reference's partitioner forms
that lookup (:func:`take_rows_two_axis`, through ``TPView.take_rows`` and
``StationaryView.take_rows``).
With ``grad=False`` (the sharded serving steps under ``fsdp``) a view reads
the shards as they are.

Serving under ``tp2d`` with the batch whole moves no parameter
(:class:`StationaryView`, :class:`Rows`, :func:`block_matmul`): the
activations stay at the home as :class:`Rows`, each product runs on the
positions that hold the weight's blocks, and :func:`each` runs the rest of
the model at the home. ``block_matmul``'s backward differentiates that
pattern; no step calls it now.

The ``fsdp`` train step and prefill on the vocab-parallel route keep the
LM's head (or its tied table) where its blocks lie, as the reference's
partitioner forms it (:func:`vocab_parallel_xent`, :func:`head_logits`,
:class:`LyingHead`): the hidden rows go to the blocks, only per-row
statistics and dX partials are reduced. BST's ``mlp_w0`` keeps its column
blocks where they lie (:func:`column_row_product`).

The train step under ``tp2d`` splits the work as the reference's
partitioner does, Megatron over "model" × ZeRO over "data" (:class:`TPView`,
:func:`tp_linear`, :func:`split_heads`, :func:`tp_vocab_xent`): every
position holds its batch shard's rows of a microbatch (``Rows`` over all
the positions, the same at each position of a "model" group), gathers
each weight's "model" block along "data" (``tp_zero_gather``; the
backward a reduce-scatter, ``tp_zero_scatter``) and multiplies there; a
row block's partial products, and a column block's dX partials, are
summed over "model" in f32 and rounded once (``tp_model_sum``); the heads
and the experts split over "model" (``tp_heads_gather``,
``expert_gather``), the loss's per-row statistics cross "model"
(``xent_stats``), and the partials of one microbatch's sums (the loss's
sums and counts, the MoE aux loss's means and counts) are added over
"data" (:func:`batch_sum`: ``loss_sum``, ``moe_aux_sum``). Serving under
``tp2d`` with the batch split reads the same views without gradients
(:meth:`TPView.serving`) and splits as the reference's partitioner splits
its jitted prefill and decode: where a weight splits over "data" on its
output dimension only (a decode step's ``wo`` / ``wd``, the untied head)
the rows move to its blocks instead of the blocks to the rows
(:func:`tp_rows_linear`: ``tp_rows_gather``, ``tp_model_sum``,
``tp_rows_scatter``); a decode step's router, split over "data" on its
input dimension only, is re-split over "model" where it lies and its
partials summed over "model" (:func:`tp_resplit_linear`: ``tp_resplit``,
``tp_model_sum``). Where one MoE group spans several batch shards, the
group's router probabilities and dispatch rows cross "data"
(:func:`span_gather`, :func:`span_select`: ``moe_group_probs``,
``moe_group_dispatch``), at a serving step and in the train step alike:
the probabilities' gradients go back to the shards that own them
(``moe_group_probs_grad``), and each dispatch row's gradient is its
owner's own.

A graph whose edge arrays are split into blocks (the GNNs' edge sharding)
folds its per-block partial sums in block order (:func:`edge_psum`), reads
an edge table whole where it needs it (:func:`edge_gather`) and splits a
scatter into the edge table back into its blocks (:func:`edge_scatter`).

Each collective's copies run inside ``Mesh.moving()``, and a send's
backward moves the working position (``Mesh.shift``) to where the
gradient goes, so a dry run charges every op to the position doing it.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.distrib.sharding import (Layout, ShardedTensor, assemble,
                                          entry_axes)
from repro_torch.sparse.segment import (from_end, segment_sum,
                                       take_along_fields, take_rows)


# profiler ranges of the sharded train steps
SPANS = ("all_gather", "all_gather_grad", "expert_send", "node_send",
         "user_send", "grad_psum", "norm_gather", "adamw", "edge_psum",
         "edge_gather", "edge_scatter", "emb_ids_home", "emb_rows_fold",
         "emb_grad_gather", "emb_rows_permute", "emb_grad_permute",
         "emb_ids_permute", "emb_ids_gather",
         "emb_rows_model", "emb_rows_data", "emb_rows_relayout",
         "emb_rows_home", "emb_grad_data", "emb_grad_home",
         "tp_act", "tp_partial", "tp_grad_act", "tp_grad_partial",
         "xent_stats", "tp_zero_gather", "tp_zero_scatter", "tp_model_sum",
         "tp_heads_gather", "expert_gather", "tp_rows_gather",
         "tp_rows_scatter", "tp_logits_gather", "tp_resplit",
         "moe_group_probs", "moe_group_probs_grad", "moe_group_dispatch",
         "loss_sum", "moe_aux_sum", "norm_sum", "prefill_span", "train_span")
span = torch.profiler.record_function


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _AllGather(torch.autograd.Function):
    """Blocks (one tensor per block of ``layout``, in ``layout.blocks()``
    order, held at ``sources``) → the whole tensor at position ``dst``; the
    backward sends each block its slice of the gradient."""

    @staticmethod
    def forward(ctx, layout: Layout, sources: Tuple[int, ...], dst: int,
                *parts):
        mesh = layout.mesh
        blocks = layout.blocks()
        for src, part in zip(sources, parts):
            if src != dst:
                mesh.count("all_gather", _nbytes(part), to=dst)
        ctx.layout, ctx.sources, ctx.dst = layout, sources, dst
        ctx.devices = [p.device for p in parts]
        with span("all_gather"), mesh.moving():
            return assemble(layout, dict(zip(blocks, parts)),
                            mesh.device(dst), parts[0].dtype)

    @staticmethod
    def backward(ctx, grad):
        lay, mesh = ctx.layout, ctx.layout.mesh
        out = []
        with span("all_gather_grad"), mesh.moving():
            for block, src, dev in zip(lay.blocks(), ctx.sources,
                                       ctx.devices):
                g = grad[lay.slices(block)]
                if src != ctx.dst:
                    mesh.count("all_gather_grad", _nbytes(g), to=src)
                # a contiguous slice on the block's device is handed over
                # as it is (no second copy of a gathered leaf's gradient)
                if g.device != dev or not g.is_contiguous():
                    with mesh.at(src):
                        g = torch.empty(g.shape, dtype=g.dtype,
                                        device=dev).copy_(g)
                out.append(g)
        return (None, None, None, *out)


class _Send(torch.autograd.Function):
    """A contiguous copy of ``x`` from position ``src`` to ``dst``; the
    backward sends the gradient back. Both count under ``name`` (with
    ``pair``, under its source and receiver too: ``Mesh.moves``)."""

    @staticmethod
    def forward(ctx, x, mesh, src: int, dst: int, name: str,
                pair: bool = False):
        ctx.mesh, ctx.src, ctx.dst, ctx.device = mesh, src, dst, x.device
        ctx.name, ctx.pair = name, pair
        if src != dst:
            mesh.count(name, _nbytes(x), to=dst, frm=src if pair else None)
        with span(name), mesh.moving():
            return torch.empty(x.shape, dtype=x.dtype,
                               device=mesh.device(dst)).copy_(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.src != ctx.dst:
            ctx.mesh.count(ctx.name, _nbytes(grad), to=ctx.src,
                           frm=ctx.dst if ctx.pair else None)
        ctx.mesh.shift(ctx.src)
        with span(ctx.name), ctx.mesh.moving():
            return (torch.empty(grad.shape, dtype=grad.dtype,
                                device=ctx.device).copy_(grad),
                    None, None, None, None, None)


class _SendSlices(torch.autograd.Function):
    """Consecutive slices of ``x`` along dimension 1 (``sizes``), each
    copied from position ``src`` to its position in ``dsts``; the backward
    copies each slice's gradient back into its place (no sum, so a −0
    stays −0)."""

    @staticmethod
    def forward(ctx, x, mesh, src: int, dsts: Tuple[int, ...],
                sizes: Tuple[int, ...]):
        ctx.mesh, ctx.src, ctx.dsts, ctx.sizes = mesh, src, dsts, sizes
        ctx.shape, ctx.device = x.shape, x.device
        outs, lo = [], 0
        with span("expert_send"), mesh.moving():
            for dst, n in zip(dsts, sizes):
                part = x.narrow(1, lo, n)
                if dst != src:
                    mesh.count("expert_send", _nbytes(part), to=dst)
                outs.append(torch.empty(part.shape, dtype=x.dtype,
                                        device=mesh.device(dst)).copy_(part))
                lo += n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        g = None
        lo = 0
        ctx.mesh.shift(ctx.src)
        with span("expert_send"), ctx.mesh.moving():
            for dst, n, gi in zip(ctx.dsts, ctx.sizes, grads):
                if g is None:
                    g = torch.empty(ctx.shape, dtype=gi.dtype,
                                    device=ctx.device)
                if dst != ctx.src:
                    ctx.mesh.count("expert_send", _nbytes(gi), to=ctx.src)
                g.narrow(1, lo, n).copy_(gi)
                lo += n
        return g, None, None, None, None


def send_slices(x: torch.Tensor, mesh, src: int, dsts: Sequence[int],
                sizes: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """``x`` (at position ``src``) cut along dimension 1 into slices of
    ``sizes``, each copied, contiguous, to its position in ``dsts``;
    differentiable."""
    return _SendSlices.apply(x, mesh, src, tuple(dsts), tuple(sizes))


def send(x: torch.Tensor, mesh, src: int, dst: int,
         name: str = "expert_send", pair: bool = False) -> torch.Tensor:
    """``x`` (at position ``src``) copied, contiguous, to position
    ``dst``'s device; differentiable; counted under ``name`` (with
    ``pair``, under both ends too)."""
    return _Send.apply(x, mesh, src, dst, name, pair)


def _block_grad(g: torch.Tensor, local: torch.Tensor, inside: torch.Tensor,
                n: int) -> torch.Tensor:
    """The gradient of a block of ``n`` table rows from the gradient rows
    ``g`` of ids at ``local`` offsets in it: one :func:`segment_sum` in
    the rows' order, the sorted accumulating ``index_put_`` (on the CPU,
    ``index_add``) of the unsharded lookup's backward. The ids not
    ``inside`` the block go to rows of their own past it, which are
    dropped: routed to one row they would be that row's duplicates, which
    CUDA's sorted ``index_put_`` adds one after another."""
    local = local.reshape(-1)
    spread = n + torch.arange(local.numel(), device=local.device)
    return segment_sum(g.reshape(-1, g.shape[-1]),
                       torch.where(inside.reshape(-1), local, spread),
                       n + local.numel())[:n]


# -- the two-axis lookup as the reference's partitioner forms it --------------
#
# ``embed`` under ``tp2d`` lies as P("model", "data"): vocab block k and column
# block c at the position with "model" coordinate k and "data" coordinate c.
# The reference looks it up as ``params["embed"].astype(cd)[tokens]``, pinned
# to the batch's layout in the forward and the prefill, not pinned at a decode
# step. Its compiled HLO on a 2 x 2 ("data", "model") mesh, and the train
# step's on 4 x 4 and 1 x 4 (read by ``tests/test_torch_tp_train.py`` and
# ``tests/test_torch_tp_serve.py``, the lookup's collectives told apart by
# their op and source line) forms it so:
#
# * the batch split over "data", pinned (the train step's forward, a
#   prefill): the ids permuted from (d, m) to (m, d) (collective-permute),
#   then gathered along "model" (all-gather), so every position holds the
#   whole microbatch's ids; each position takes the rows of its own (V/M,
#   d/D) block, masked, in the compute dtype; the partial rows all-reduced
#   over "model" (here a reduce-scatter and an all-gather, each entry
#   selected from the block that owns its row); the rows exchanged along
#   "data" (all-to-all), after which each batch shard holds its own rows
#   whole. The backward: the gradient rows exchanged along "data"
#   (all-to-all), then a scatter-add into each position's own block, no
#   other collective. On a 2 x 1 mesh the ids are gathered along "data"
#   instead (no permute, no all-reduce); on 1 x M only the all-reduce over
#   "model" is left.
# * the batch split, not pinned (a decode step): the same ids and
#   all-reduce, no all-to-all: each position is left with the whole batch's
#   rows of its column block.
# * the batch whole: the ids are every chip's already; only the all-reduce
#   over "model", the columns left split over "data".


class _LookupPlan(NamedTuple):
    """Where :class:`_TwoAxisLookup` moves what, per position: the batch
    shards whose ids it looks up (``need``, in batch order), where each
    needed shard's ids come from as hops ``(name, from, to)``
    (``ids``), the position of each vocab block its fold selects from
    (``fold``, in vocab block order), and per output position, the
    position that serves each column block of its rows (``serve``)."""
    need: Tuple[Tuple[int, ...], ...]
    ids: Tuple[Tuple[Tuple[Tuple[str, int, int], ...], ...], ...]
    fold: Tuple[Tuple[int, ...], ...]
    serve: Dict[int, Tuple[int, ...]]


def _line(mesh, pos: int, axis: str) -> List[int]:
    """The positions that differ from ``pos`` on ``axis`` only, in
    ascending ``axis`` coordinate (``pos`` alone without that axis)."""
    if axis not in mesh.axis_names:
        return [pos]
    c = dict(mesh.coords(pos))
    out = []
    for i in range(mesh.axis_size(axis)):
        c[axis] = i
        out.append(_position(mesh, c))
    return out


@functools.lru_cache(maxsize=256)
def _lookup_plan(mesh, spec, shape: Tuple[int, ...],
                 shard: Tuple[int, ...], outs: Tuple[int, ...],
                 whole: bool) -> _LookupPlan:
    """The :class:`_LookupPlan` of a table ``shape`` under ``spec`` on
    ``mesh``, position p holding batch shard ``shard[p]``'s ids (with
    ``whole``, every shard's, placed by the step), the rows wanted at
    ``outs``. A position looks up the shards of its "data" line (with
    ``whole``, all of them), which a position then serves to the outputs
    on that line; the ids come the reference's way: permuted and gathered
    along "model" on a square ("data", "model") mesh with the batch over
    "data", else gathered along "data"."""
    lay = Layout(mesh, spec, shape)
    n_shards = max(shard) + 1
    own = [lay.block_of(p) for p in range(mesh.size)]
    C = lay.counts[1]
    need, ids, fold = [], [], []
    square = (mesh.axis_names == ("data", "model") and not whole
              and mesh.shape[0] == mesh.shape[1] > 1 and C > 1
              and all(shard[p] == mesh.coords(p)["data"]
                      for p in range(mesh.size)))
    for p in range(mesh.size):
        if whole:
            mine = tuple(range(n_shards))
        elif C > 1:
            mine = tuple(sorted({shard[q] for q in _line(mesh, p, "data")}))
        else:
            mine = (shard[p],)
        need.append(mine)
        hops = []
        for s in mine:
            if whole or (s == shard[p] and not square):
                hops.append(())
            elif square:
                # (d, m) holds shard m after the permute; shard s comes
                # from (d, s), which took it from (s, d)
                c = mesh.coords(p)
                mid = _position(mesh, {"data": c["data"], "model": s})
                src = _position(mesh, {"data": s, "model": c["data"]})
                hops.append(tuple(h for h in (
                    ("emb_ids_permute", src, mid),
                    ("emb_ids_gather", mid, p)) if h[1] != h[2]))
            else:
                src = next(q for q in _line(mesh, p, "data")
                           if shard[q] == s)
                hops.append((("emb_ids_gather", src, p),))
        ids.append(tuple(hops))
        peers = _line(mesh, p, "model")
        fold.append(tuple(
            p if own[p][0] == k else
            next(q for q in peers if own[q] == (k, own[p][1]))
            for k in range(lay.counts[0])))
    serve = {}
    for o in outs:
        line = _line(mesh, o, "data")
        serve[o] = tuple(o if own[o][1] == c else
                         next(q for q in line if own[q][1] == c)
                         for c in range(C))
        if any(shard[o] not in need[q] for q in serve[o]):
            raise ValueError(f"lookup: position {o}'s rows are not looked "
                             f"up on its 'data' line")
    return _LookupPlan(tuple(need), tuple(ids), tuple(fold), serve)


class _TwoAxisLookup(torch.autograd.Function):
    """:func:`take_rows_two_axis`; the inputs are every position's
    block."""

    @staticmethod
    def forward(ctx, mesh, lay, plan: _LookupPlan, held, dtype,
                names: Tuple[str, str], grad_outs, *leaves):
        n, rows = lay.shape[0], lay.block_shape[0]
        own = [lay.block_of(p) for p in range(mesh.size)]
        # the ids each position looks up, moved along their hops (a hop
        # that several positions' ids share, the permute, moves once)
        at: Dict[Tuple[int, int], torch.Tensor] = {}
        moved: Dict[Tuple[str, int, int, int], torch.Tensor] = {}
        for p, hops_p in enumerate(plan.ids):
            for s, hops in zip(plan.need[p], hops_p):
                t = held[hops[0][1] if hops else p][s]
                for name, frm, to in hops:
                    key = (name, s, frm, to)
                    if key not in moved:
                        with span(name), mesh.at(to), mesh.moving():
                            mesh.count(name, _nbytes(t), frm=frm, to=to)
                            moved[key] = t.to(mesh.device(to), copy=True)
                    t = moved[key]
                at[(s, p)] = t
        del moved
        j, parts, local = [], [], []
        for p in range(mesh.size):
            with mesh.at(p):
                idx = torch.cat([at[(s, p)] for s in plan.need[p]])
                j.append(from_end(idx, n))
                local.append(j[p] - own[p][0] * rows)
                parts.append(leaves[p][local[p].clamp(0, rows - 1)]
                             .to(dtype))
        del at
        # the fold over "model": each line's partials folded at and sent to
        # its own positions
        folded = [None] * mesh.size
        for srcs in dict.fromkeys(plan.fold):
            flat = _fold(mesh, srcs, [parts[q] for q in srcs],
                         lambda q: _owners(j[q], rows, parts[q].shape[-1]),
                         srcs, "emb_rows_model")
            for p in srcs:
                with mesh.at(p):
                    valid = (j[p] >= 0) & (j[p] < n)
                    folded[p] = flat[p].reshape(parts[p].shape).masked_fill(
                        ~valid[..., None], float("nan"))
            del flat
        del parts
        # each output's batch shard, its column blocks from the positions
        # of its "data" line that hold them
        name = names[0]
        results = []
        for o, srcs in plan.serve.items():
            s = _shard_of(plan, held, o)
            pieces = []
            for q in srcs:
                b = folded[q].shape[0] // len(plan.need[q])
                lo = plan.need[q].index(s) * b
                piece = folded[q].narrow(0, lo, b)
                if q != o:
                    with span(name), mesh.at(o), mesh.moving():
                        mesh.count(name, _nbytes(piece), frm=q, to=o)
                        piece = piece.to(mesh.device(o))
                pieces.append(piece)
            with mesh.at(o):
                results.append(pieces[0].clone() if len(pieces) == 1
                               else torch.cat(pieces, dim=-1))
        ctx.mesh, ctx.lay, ctx.plan, ctx.grad_name = mesh, lay, plan, \
            names[1]
        ctx.shards = [_shard_of(plan, held, o) for o in plan.serve]
        ctx.leaf_dtypes = [t.dtype for t in leaves]
        ctx.save_for_backward(*local)
        ctx.mark_non_differentiable(*(r for o, r in zip(plan.serve, results)
                                      if o not in grad_outs))
        ctx.set_materialize_grads(False)
        return tuple(results)

    @staticmethod
    def backward(ctx, *grads):
        mesh, lay, plan = ctx.mesh, ctx.lay, ctx.plan
        rows, e = lay.block_shape
        outs = list(plan.serve)
        local = ctx.saved_tensors
        need = ctx.needs_input_grad[7:]
        result = [None] * mesh.size
        name = ctx.grad_name
        for p in range(mesh.size):
            if not need[p]:
                continue
            c = lay.block_of(p)[1]
            line = set(_line(mesh, p, "data"))
            pieces, any_grad = [], False
            for s in plan.need[p]:
                mine = [o for o, so, g in zip(outs, ctx.shards, grads)
                        if so == s and g is not None]
                near = [o for o in mine if o in line]
                o = (near or mine or [None])[0]
                if o is None:
                    pieces.append(None)
                    continue
                g = grads[outs.index(o)].narrow(-1, c * e, e)
                with span(name), mesh.at(p), mesh.moving():
                    if o != p:
                        mesh.count(name, _nbytes(g), frm=o, to=p)
                    g = g.to(mesh.device(p), copy=True)
                pieces.append(g)
                any_grad = True
            if not any_grad:
                continue
            with mesh.at(p):
                like = next(g for g in pieces if g is not None)
                g = torch.cat([torch.zeros_like(like) if g is None
                               else g for g in pieces])
                inside = (local[p] >= 0) & (local[p] < rows)
                result[p] = _block_grad(g, local[p], inside, rows).to(
                    ctx.leaf_dtypes[p]).reshape(lay.block_shape)
        return (None,) * 7 + tuple(result)


def _owners(j: torch.Tensor, rows: int, e: int) -> torch.Tensor:
    """The block that owns each entry of the flattened (…, ``e``) rows of
    the ids ``j`` (counted from the end), blocks of ``rows`` rows."""
    return (j // rows).reshape(-1, 1).expand(-1, e).reshape(-1)


def _fold(mesh, srcs: Sequence[int], parts: Sequence[torch.Tensor], owner,
          to: Sequence[int], name: str) -> Dict[int, torch.Tensor]:
    """The partial rows ``parts[k]`` of block k (its rows of every id, the
    others masked), held at ``srcs[k]``, folded as an all-reduce's
    reduce-scatter and all-gather move them: the flattened partials cut
    into K chunks, chunk k folded at ``srcs[k]`` from every block's chunk,
    each entry taken from the block that owns its row (``owner(q)``, at
    ``q``: the owning block of each flattened entry) — a select, never a
    sum, so a −0.0 row stays −0.0 — then every folded chunk sent to each
    position of ``to``. Both halves count under ``name``. The folded
    rows, flattened, at each position of ``to``."""
    K, T = len(srcs), parts[0].numel()
    cut = [k * T // K for k in range(K + 1)]
    flat = []
    for q, part in zip(srcs, parts):
        with mesh.at(q):
            flat.append(part.reshape(-1))
    chunks = []
    for k, dst in enumerate(srcs):
        lo, size = cut[k], cut[k + 1] - cut[k]
        with mesh.at(dst):
            own = owner(dst).narrow(0, lo, size)
            out = flat[k].narrow(0, lo, size)
        for i, q in enumerate(srcs):
            if q == dst or not size:
                continue
            with span(name), mesh.at(dst), mesh.moving():
                piece = flat[i].narrow(0, lo, size)
                mesh.count(name, _nbytes(piece), frm=q, to=dst)
                piece = piece.to(mesh.device(dst))
            with mesh.at(dst):
                out = torch.where(own == i, piece, out)
        chunks.append(out)
    del flat
    folded = {}
    for p in to:
        pieces = []
        for q, ch in zip(srcs, chunks):
            if q != p and ch.numel():
                with span(name), mesh.at(p), mesh.moving():
                    mesh.count(name, _nbytes(ch), frm=q, to=p)
                    ch = ch.to(mesh.device(p))
            pieces.append(ch)
        with mesh.at(p):
            folded[p] = torch.cat(pieces)
    return folded


def _shard_of(plan: _LookupPlan, held, o: int) -> int:
    """The batch shard whose rows output position ``o`` takes: the one
    its ids are, or with every shard at every position, ``o``'s place
    among the outputs."""
    if len(held[o]) == 1:
        return next(iter(held[o]))
    return list(plan.serve).index(o)


def take_rows_two_axis(x: ShardedTensor, leaves, held, shard, outs,
                       dtype, names: Tuple[str, str], grad_outs=(),
                       whole: bool = False) -> List[torch.Tensor]:
    """``sparse.segment.take_rows`` of the (n, e) table ``x`` in ``dtype``
    (the cast table's rows, bit for bit), formed as the reference's
    partitioner forms its lookup (see above): ``held[p]`` maps the batch
    shards whose ids position p holds to them (``shard[p]`` its own; with
    ``whole`` every shard, placed there by the step). The ids move to the
    positions that look them up (``emb_ids_permute``,
    ``emb_ids_gather``); each position takes its own block's rows
    (``leaves[p]``) of the whole batch of its "data" line; the partial
    rows cross "model" as an all-reduce's reduce-scatter and all-gather
    move them (``emb_rows_model``: 2(K − 1)/K of a position's partial rows
    into each position of a line of K vocab blocks), each entry selected
    at its chunk's owner from the block that owns its row (an id outside
    ``[-n, n)`` gives a NaN row); each output position in ``outs`` takes
    its shard's rows of each column block from the position of its "data"
    line that holds it (``names[0]``). The rows at ``outs``, in order.

    The backward (from the outputs in ``grad_outs``; the others take no
    gradient): each block's holder takes its column block of every
    looked-up shard's gradient rows from that shard's output on its
    "data" line (``names[1]``; else the shard's first output), in batch
    order, and sums them by one :func:`segment_sum` into its block in
    ``dtype`` (then the leaf's dtype): the order of one device's
    ``take_rows`` backward over the same batch, not a sum per batch
    shard."""
    mesh = x.mesh
    plan = _lookup_plan(mesh, x.spec, tuple(x.shape), tuple(shard),
                        tuple(outs), whole)
    return list(_TwoAxisLookup.apply(mesh, x.layout, plan, held, dtype,
                                     names, frozenset(grad_outs), *leaves))


# -- a table split along its rows only, as the reference's partitioner forms
#    the lookup ---------------------------------------------------------------
#
# BST's item table lies as P("model", None) (its user tables as P(None,
# "model", None), split along their vocab axis) and the LM's ``embed`` under
# ``fsdp`` as P(("data", "model"), None), the batch split over "data". The
# reference's compiled train steps (read by
# ``tests/test_torch_sharded_train.py`` and
# ``tests/test_torch_sharded_gnn_bst.py``, its prefill by
# ``tests/test_torch_tp_serve.py``, the lookup's collectives told apart by
# their op and source line) form the lookup so: where the table's blocks lie
# along the batch axes too (the LM's), the ids are gathered along "data"
# (all-gather), so every position holds the whole batch's; each position
# takes the rows of its own block, masked; the partial rows are all-reduced
# over the positions of the blocks (both axes for the LM's table, "model"
# for BST's), after which every position holds its rows whole. BST's user
# tables ride in the item table's all-reduce (one tuple). The backward:
# the gradient rows gathered along "data" where the ids were, then a
# scatter-add into each position's own block, nothing else.
#
# A table whose rows split over "data" alone, each block repeated along
# "model" (``fit_spec``'s fallback where 256 does not divide the vocabulary,
# qwen3's 151,936 rows), the reference looks up on the "model" columns: the
# batch is cut into one chunk a column (batch shard d on column d when the
# axes are equal), the ids go from the batch shards to their column
# (collective-permute, then an all-gather along "data" where a column takes
# several shards), each position masks its block's rows of its column's
# chunk, the partials are all-reduced along "data" within the column, each
# shard's rows go back (collective-permute); the backward sends the
# gradient rows the ids' way, scatter-adds each column's into its blocks and
# all-reduces each block's gradient over "model" (the port's ``grad_psum``,
# which adds every batch shard's gradients at the block's owner).
#
# The port keeps each batch shard at one home (``batch_groups``): its ids
# and its gradient rows go from the home to the positions of its group
# (``emb_ids_home``, ``emb_grad_home``: the reference's ``in_shardings``
# replicate the batch over "model"), and the fold's all-gather goes to the
# homes only (on the columns, to the one position that sends each home its
# rows).


def _rows_over_data(x: ShardedTensor) -> bool:
    """Whether ``x`` is split along its rows over "data" alone, each block
    repeated along a "model" axis of more than one position."""
    mesh = x.mesh
    return (tuple(mesh.axis_names) == ("data", "model")
            and mesh.axis_size("model") > 1 and _split_along(x, 0)
            and tuple(x.layout.axes[0]) == ("data",))


def _column(mesh, d: int) -> Tuple[int, Tuple[int, ...]]:
    """Batch shard ``d``'s column in the lookup of a table split over
    "data" alone (:func:`_rows_over_data`): the "model" index whose
    positions look its rows up, and the "data" indices on it where its ids
    land from the shard (D / M of them when M divides D and is smaller,
    the rest of the column then gathering them along "data"; else the
    whole column)."""
    D, M = mesh.axis_size("data"), mesh.axis_size("model")
    if D > M and D % M == 0:
        g = D // M
        return d // g, tuple(M * (d % g) + k for k in range(M))
    return d * M // D, tuple(range(D))


class _RowPlan(NamedTuple):
    """Where :class:`_RowLookup` moves what: the position of each block
    (``sources``, in block order), the homes whose rows it looks up
    (``homes``, in batch order), per block and home the hops of the
    home's ids (its gradient rows the same way) to the block's position,
    ``(kind, from, to)``: within the home's group (``"home"``), from the
    home to its "model" column (``"permute"``, the reference's
    collective-permute), along the batch axes (``"gather"``); and per home
    the position the fold leaves its rows at (``relays``: the home, or on a
    column the position that sends them to it)."""
    sources: Tuple[int, ...]
    homes: Tuple[int, ...]
    routes: Tuple[Tuple[Tuple[Tuple[str, int, int], ...], ...], ...]
    relays: Tuple[int, ...]


@functools.lru_cache(maxsize=256)
def _row_plan(mesh, sources: Tuple[int, ...], homes: Tuple[int, ...],
              groups: Tuple[Tuple[int, ...], ...], columns: bool) -> _RowPlan:
    """The :class:`_RowPlan` of blocks at ``sources`` looked up for the
    batch shards at ``homes`` (each with its ``groups`` entry). A home's
    ids reach a block's position in its own group directly, and any other
    through the position of the group on the block's line along the batch
    axes (the one that agrees with the block's position on every axis
    the group spans). With ``columns`` (the blocks on the homes' "model"
    column, :func:`_column`) they go from the home straight to the
    positions where they land, and along "data" from there."""
    routes, relays = [], []
    for h in homes:
        if columns:
            c, land = _column(mesh, mesh.coords(h)["data"])
            relays.append(_position(mesh, {"data": land[0], "model": c}))
        else:
            relays.append(h)
    for q in sources:
        per = []
        for h, g in zip(homes, groups):
            if q == h:
                per.append(())
                continue
            if columns:
                c, land = _column(mesh, mesh.coords(h)["data"])
                a = mesh.coords(q)["data"]
                r = q if a in land else _position(mesh, {
                    "data": land[0] + a % len(land), "model": c})
                hops = (("home" if r in g else "permute", h, r),
                        ("gather", r, q))
            elif q in g:
                hops = (("home", h, q),)
            else:
                spans = [x for x in mesh.axis_names
                         if len({mesh.coords(p)[x] for p in g}) > 1]
                r = next(p for p in g if all(
                    mesh.coords(p)[x] == mesh.coords(q)[x] for x in spans))
                hops = (("home", h, r), ("gather", r, q))
            per.append(tuple(hop for hop in hops if hop[1] != hop[2]))
        routes.append(tuple(per))
    return _RowPlan(sources, homes, tuple(routes), tuple(relays))


def _hop(mesh, moved: dict, i: int, t: torch.Tensor, hops, prefix
         ) -> torch.Tensor:
    """``t`` (home ``i``'s) moved along ``hops``, each counted under
    ``prefix`` + its kind (``prefix`` a function of the kind: under what it
    gives); a hop already in ``moved`` moves once."""
    for kind, frm, to in hops:
        key = (i, frm, to)
        if key not in moved:
            name = prefix(kind) if callable(prefix) else prefix + kind
            with span(name), mesh.at(to), mesh.moving():
                mesh.count(name, _nbytes(t), frm=frm, to=to)
                moved[key] = t.to(mesh.device(to), copy=True)
        t = moved[key]
    return t


class _RowLookup(torch.autograd.Function):
    """:func:`take_rows_where_they_lie` over one set of blocks; the inputs
    are each home's ids, then each block."""

    @staticmethod
    def forward(ctx, mesh, plan: _RowPlan, dim: int, n: int, dtype,
                n_homes: int, *tensors):
        ids, leaves = tensors[:n_homes], tensors[n_homes:]
        rows = leaves[0].shape[dim]
        moved, j, local, parts = {}, [], [], []
        for k, (q, leaf) in enumerate(zip(plan.sources, leaves)):
            got = [_hop(mesh, moved, i, t, hops, "emb_ids_")
                   for i, (t, hops) in enumerate(zip(ids, plan.routes[k]))]
            with mesh.at(q):
                jq = from_end(torch.cat(got) if len(got) > 1 else got[0], n)
                lq = jq - k * rows
                at = lq.clamp(0, rows - 1)
                if dim == 0:
                    part = leaf[at]
                else:
                    fields = torch.arange(leaf.shape[0],
                                          device=leaf.device)[None, :]
                    part = leaf[fields, at]
                parts.append(part.to(dtype))
                j.append(jq)
                local.append(lq)
        del moved
        e = parts[0].shape[-1]
        flat = _fold(mesh, plan.sources, parts,
                     lambda q: _owners(j[plan.sources.index(q)], rows, e),
                     list(dict.fromkeys(plan.relays)), "emb_rows_fold")
        shape = parts[0].shape
        del parts, j
        out, lo = [], 0
        for h, r, t in zip(plan.homes, plan.relays, ids):
            with mesh.at(r):
                mine = flat[r].reshape(shape).narrow(0, lo, t.shape[0])
            if r != h:
                with span("emb_rows_permute"), mesh.at(h), mesh.moving():
                    mesh.count("emb_rows_permute", _nbytes(mine), frm=r,
                               to=h)
                    mine = mine.to(mesh.device(h), copy=True)
            with mesh.at(h):
                jh = from_end(t, n)
                valid = (jh >= 0) & (jh < n)
                out.append(mine.masked_fill(~valid[..., None],
                                            float("nan")))
            lo += t.shape[0]
        ctx.mesh, ctx.plan, ctx.dim, ctx.rows = mesh, plan, dim, rows
        ctx.leaves = [(t.dtype, t.shape) for t in leaves]
        ctx.n_homes = n_homes
        ctx.save_for_backward(*local)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, plan, rows = ctx.mesh, ctx.plan, ctx.rows
        need = ctx.needs_input_grad[6 + ctx.n_homes:]
        moved, result = {}, []
        for k, (q, lq) in enumerate(zip(plan.sources, ctx.saved_tensors)):
            if not need[k]:
                result.append(None)
                continue
            got = [_hop(mesh, moved, i, g, hops, "emb_grad_")
                   for i, (g, hops) in enumerate(zip(grads, plan.routes[k]))]
            dtype, shape = ctx.leaves[k]
            with mesh.at(q):
                g = torch.cat(got) if len(got) > 1 else got[0]
                inside = (lq >= 0) & (lq < rows)
                n = rows
                if ctx.dim == 1:
                    n = lq.shape[-1] * rows
                    lq = torch.arange(lq.shape[-1],
                                      device=lq.device) * rows + lq
                result.append(_block_grad(g, lq, inside, n).to(dtype)
                              .reshape(shape))
        return (None,) * (6 + ctx.n_homes) + tuple(result)


def take_rows_where_they_lie(views: Sequence["ShardView"],
                             ids: Sequence[torch.Tensor], dim: int = 0,
                             dtype: torch.dtype = None
                             ) -> List[torch.Tensor]:
    """``sparse.segment.take_rows`` (``dim`` 0) or ``take_along_fields``
    (``dim`` 1, (F, V, e) tables) of the leaf of ``views`` — one
    :class:`ShardView` per batch shard, each at its home with its ids
    ``ids`` there, the leaf split along ``dim`` only — in ``dtype``
    (default the leaf's; the cast table's rows, bit for bit), formed as
    the reference's partitioner forms the lookup (see above). The views
    that read the same blocks from the same positions (all of them, but
    on a table split over "data" alone, where each "model" column reads
    its own: :func:`_column`) are looked up together, in batch order.
    Each home's ids go to the position of every such block (``emb_ids_home``
    within the home's group, ``emb_ids_permute`` across both axes, then
    ``emb_ids_gather`` along the batch axes); each block's position takes
    its rows of every home's ids, masked; the partial rows are
    reduce-scattered over the blocks' positions and every folded chunk
    all-gathered to each home, or on a column to the position that sends
    the home its rows (``emb_rows_fold``: 2(K − 1)/K of the partials into
    a receiver that holds a block, K blocks; then ``emb_rows_permute``),
    each entry selected at its chunk's position from the block that owns
    its row (an id outside ``[-n, n)`` gives a NaN row). Each home's rows,
    in order.

    The backward: each home's gradient rows go to every block's position
    the way its ids went (``emb_grad_home``, ``emb_grad_permute``,
    ``emb_grad_gather``), and the position sums the rows of all the homes
    looked up together, in batch order, into its block by one
    :func:`segment_sum` in ``dtype``, then casts it to the leaf's dtype:
    the order of one device's backward over the same rows. The blocks'
    gradients go to the blocks of the first of those views."""
    v0 = views[0]
    mesh, lay = v0.x.mesh, v0.x.layout
    order = sorted(v0.proxies)
    columns = _rows_over_data(v0.x)
    for v in views if columns else ():
        v.to_column()
    together: Dict[Tuple[int, ...], List[int]] = {}
    for i, v in enumerate(views):
        together.setdefault(tuple(v.sources[b] for b in order),
                            []).append(i)
    out: List[torch.Tensor] = [None] * len(views)
    for srcs, members in together.items():
        vs = [views[i] for i in members]
        plan = _row_plan(mesh, srcs, tuple(v.home for v in vs),
                         tuple(tuple(v.group) for v in vs), columns)
        rows = _RowLookup.apply(mesh, plan, dim, lay.shape[dim],
                                dtype or v0.x.dtype, len(vs),
                                *(ids[i] for i in members),
                                *(vs[0].proxies[b] for b in order))
        for i, r in zip(members, rows):
            out[i] = r
    return out


def _split_along(x: ShardedTensor, dim: int) -> bool:
    """Whether ``x`` is split along ``dim`` and no other dimension."""
    counts = x.layout.counts
    return counts[dim] > 1 and all(c == 1 for i, c in enumerate(counts)
                                   if i != dim)


class Blocks(NamedTuple):
    """A leaf split along dimension ``dim`` (0 unless said) into equal
    blocks, each on the device of the mesh position that holds it;
    ``home`` is the position whose batch shard uses them."""
    parts: List[torch.Tensor]
    positions: List[int]
    home: int
    mesh: object
    dim: int = 0


class ShardView:
    """One batch shard's handle on a sharded leaf in the sharded train
    and serving steps. Each block is taken from a position of the batch
    shard's own group (``group``) where one holds it, else from the first
    holder (a table split over "data" alone, looked up, from the batch
    shard's "model" column: :meth:`to_column`); ``proxies`` are those shards as leaves that require grad, so
    one batch shard's microbatches add their gradients into them
    (autograd's accumulation, in microbatch order) apart from every other
    batch shard's; with ``grad=False`` the shards themselves."""

    def __init__(self, x: ShardedTensor, home: int, group: Sequence[int],
                 grad: bool = True):
        lay = x.layout
        self.x, self.home, self.group = x, home, tuple(group)
        self.grad = grad
        self.sources: Dict[Tuple[int, ...], int] = {}
        for block in lay.blocks():
            holders = lay.holders(block)
            mine = [p for p in holders if p in group]
            self.sources[block] = mine[0] if mine else holders[0]
        self.proxies = {block: self._proxy(pos)
                        for block, pos in self.sources.items()}

    def _proxy(self, pos: int) -> torch.Tensor:
        shard = self.x.shards[pos]
        return shard.detach().requires_grad_(True) if self.grad else shard

    def to_column(self) -> None:
        """Read a table split over "data" alone (:func:`_rows_over_data`)
        from the batch shard's "model" column, where the reference looks
        its rows up (:func:`_column`): each block from its holder there.
        The lookup calls it before it reads the blocks, so the view's
        gradients collect there (no other read of such a table comes
        first: a tied one is gathered, not looked up)."""
        mesh = self.x.mesh
        c = _column(mesh, mesh.coords(self.home)["data"])[0]
        for block, pos in self.sources.items():
            at = next(p for p in self.x.layout.holders(block)
                      if mesh.coords(p)["model"] == c)
            if at != pos:
                self.sources[block] = at
                self.proxies[block] = self._proxy(at)

    def full(self) -> torch.Tensor:
        """The whole leaf on the home position's device."""
        blocks = self.x.layout.blocks()
        if len(blocks) == 1 and self.sources[blocks[0]] == self.home:
            return self.proxies[blocks[0]]
        return _AllGather.apply(self.x.layout,
                                tuple(self.sources[b] for b in blocks),
                                self.home,
                                *(self.proxies[b] for b in blocks))

    def blocks(self) -> Blocks:
        """The leaf's blocks along dimension 0 where they live (an expert
        weight under expert parallelism); every other dimension must be
        whole."""
        lay = self.x.layout
        if any(c != 1 for c in lay.counts[1:]):
            raise ValueError(f"blocks(): {self.x!r} is split past dim 0")
        order = sorted(self.proxies)
        return Blocks([self.proxies[b] for b in order],
                      [self.sources[b] for b in order], self.home,
                      self.x.mesh)

    def grads(self):
        """(block, source position, gradient) per block; ``None`` where the
        loss did not reach it."""
        for block, proxy in self.proxies.items():
            yield block, self.sources[block], proxy.grad

    @property
    def splits_rows(self) -> bool:
        """Whether the leaf is split along its rows and nothing else (then
        :meth:`take_rows` looks it up where the rows lie)."""
        return _split_along(self.x, 0)

    def take_rows(self, ids: torch.Tensor,
                  dtype: torch.dtype = None) -> torch.Tensor:
        """``sparse.segment.take_rows`` of the leaf in ``dtype`` (default
        the leaf's) at ``ids`` (at the home), the rows looked up where they
        lie when the leaf is split along its rows only
        (:func:`take_rows_where_they_lie`); otherwise of the whole
        leaf."""
        return self._lookup(ids, 0, dtype)

    def take_along_fields(self, ids: torch.Tensor) -> torch.Tensor:
        """``sparse.segment.take_along_fields`` of the (F, V, e) leaf at
        ``ids`` (B, F), the rows looked up where they lie when the leaf is
        split along V only; otherwise of the whole leaf."""
        return self._lookup(ids, 1, None)

    def _lookup(self, ids: torch.Tensor, dim: int, dtype) -> torch.Tensor:
        if _split_along(self.x, dim):
            return take_rows_where_they_lie([self], [ids], dim, dtype)[0]
        whole = self.full()
        if dtype is not None:
            whole = whole.to(dtype)
        return (take_rows(whole, ids) if dim == 0
                else take_along_fields(whole, ids))


class HomeViews:
    """A leaf as the homes of one microbatch that spans several batch
    shards read it in the ``fsdp`` train step
    (``train.state.make_sharded_train_step`` with fewer microbatches than
    batch shards): each home's :class:`ShardView`, homes in batch order.
    :func:`local` makes it :class:`Rows` of each home's whole leaf (or its
    blocks), gathered at that home; :func:`each` and :func:`each_home` hand
    each home its own view."""

    def __init__(self, views: Sequence[ShardView], homes: Sequence[int],
                 mesh):
        self.views, self.homes, self.mesh = list(views), list(homes), mesh

    def part(self, home: int) -> ShardView:
        return self.views[self.homes.index(home)]

    @property
    def splits_rows(self) -> bool:
        return self.views[0].splits_rows

    def take_rows(self, ids: "Rows", dtype: torch.dtype = None) -> "Rows":
        """``sparse.segment.take_rows`` of the leaf, split along its rows
        only (:attr:`splits_rows`), in ``dtype`` at each home's ids
        (``Rows``): one lookup of the homes' batch where the rows lie
        (:func:`take_rows_where_they_lie`), as the reference looks its
        whole batch up at once."""
        return Rows(take_rows_where_they_lie(self.views, ids.parts, 0, dtype),
                    self.homes, self.mesh)


def local(x, experts: bool = False):
    """A batch shard's tensor for a parameter leaf: a :class:`ShardView`'s
    whole leaf (or, with ``experts``, its blocks where they live), each
    home's as :class:`Rows` for :class:`HomeViews`; a plain tensor, or a
    :class:`StationaryView`, as it is."""
    if isinstance(x, ShardView):
        return x.blocks() if experts else x.full()
    if isinstance(x, HomeViews):
        out = []
        for view, home in zip(x.views, x.homes):
            with x.mesh.at(home):
                out.append(local(view, experts))
        return Rows(out, x.homes, x.mesh)
    return x


# -- the weights where they lie (``tp2d``) -------------------------------------

class Rows(NamedTuple):
    """The activations of every batch shard, each on its home position's
    device, in batch order."""
    parts: List[torch.Tensor]
    homes: List[int]
    mesh: object

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> torch.Size:
        """Each batch shard's shape (the shards are equal)."""
        return self.parts[0].shape


class StationaryView:
    """A placed parameter leaf whose blocks stay where they lie. The batch
    shards read a 2-D weight through :func:`block_matmul` (``.T`` is the
    transposed weight, the blocks transposed where they lie), a table
    through :meth:`take_rows`, and any other leaf through :meth:`part`.
    ``leaves[pos]`` is the block position ``pos`` holds: with ``grad`` a
    leaf that requires grad and shares the shard's storage (as
    ``ShardView.proxies``), so it collects the gradient of the work done
    there; otherwise the shard itself. ``.T`` shares the leaves."""

    def __init__(self, x: ShardedTensor, transposed: bool = False,
                 grad: bool = False, leaves=None, ids=None):
        self.x, self.transposed, self.ids = x, transposed, ids
        used = {a for axes in x.layout.axes for a in axes}
        self._free = [a for a in x.mesh.axis_names if a not in used]
        if leaves is None:
            leaves = [s.detach().requires_grad_(True) if grad else s
                      for s in x.shards]
        self.leaves: List[torch.Tensor] = leaves

    @property
    def T(self) -> "StationaryView":
        return StationaryView(self.x, not self.transposed,
                              leaves=self.leaves)

    @property
    def shape(self) -> Tuple[int, ...]:
        s = tuple(self.x.shape)
        return s[::-1] if self.transposed else s

    @property
    def counts(self) -> Tuple[int, ...]:
        c = tuple(self.x.layout.counts)
        return c[::-1] if self.transposed else c

    def holder(self, block: Tuple[int, ...], home: int) -> int:
        """The position that serves ``block`` to the batch shard at
        ``home``: of the block's holders, the one whose coordinates on the
        mesh axes the leaf's spec leaves out are the home's."""
        return self._home_part(home) + self._block_part(block)

    def _home_part(self, home: int) -> int:
        """``home``'s row-major position counted on the axes the spec
        leaves out only (a position is the sum of its axes' parts)."""
        mesh, pos, stride = self.x.mesh, 0, 1
        coords = mesh.coords(home)
        for a, n in zip(reversed(mesh.axis_names), reversed(mesh.shape)):
            if a in self._free:
                pos += coords[a] * stride
            stride *= n
        return pos

    def _block_part(self, block: Tuple[int, ...]) -> int:
        """``block``'s row-major position counted on the axes the spec
        names."""
        mesh, lay = self.x.mesh, self.x.layout
        if self.transposed:
            block = tuple(block)[::-1]
        want = {}
        for axes, i in zip(lay.axes, block):
            for a in reversed(axes):
                want[a] = i % mesh.axis_size(a)
                i //= mesh.axis_size(a)
        pos, stride = 0, 1
        for a, n in zip(reversed(mesh.axis_names), reversed(mesh.shape)):
            pos += want.get(a, 0) * stride
            stride *= n
        return pos

    def block_at(self, pos: int) -> torch.Tensor:
        """The block position ``pos`` holds, transposed with the view."""
        leaf = self.leaves[pos]
        return leaf.T if self.transposed else leaf

    def part(self, home: int):
        """The leaf as the batch shard at ``home`` reads it without a move:
        the home's own copy of a leaf it holds whole, or a 3-D leaf split
        along one dimension (an expert weight: along its experts, or along
        d_ff under ``moe_shard="ffn"``) as :class:`Blocks` on the positions
        that serve them."""
        lay = self.x.layout
        if all(c == 1 for c in lay.counts):
            return self.leaves[home]
        split = [i for i, c in enumerate(lay.counts) if c != 1]
        if self.transposed or len(split) != 1 or len(lay.counts) != 3:
            raise ValueError(f"{self.x!r} is not an expert weight split "
                             f"along one dimension: read it through "
                             f"block_matmul or take_rows")
        pos = [self.holder(b, home) for b in lay.blocks()]
        return Blocks([self.leaves[p] for p in pos], pos, home,
                      self.x.mesh, split[0])

    def take_rows(self, ids: Rows, dtype: torch.dtype = None) -> Rows:
        """``sparse.segment.take_rows`` of the (n, e) table in ``dtype``
        (default the table's) at each batch shard's ids, formed as the
        reference's partitioner forms its lookup with the batch whole
        (:func:`take_rows_two_axis`): every position looks the whole batch
        up in its own block (the batch's ids at every position, placed by
        the step: ``ids`` at construction, as the reference's
        ``in_shardings`` replicate them), the partial rows cross "model"
        (``emb_rows_model``), and each home takes its rows of each column
        block from the position of its "data" line that holds it
        (``emb_rows_home``: the port's rows live at the homes, where the
        reference leaves the columns split over "data"; the backward's
        gradient rows go the other way, ``emb_grad_home``)."""
        lay = self.x.layout
        if self.transposed or len(lay.counts) != 2:
            raise ValueError(f"take_rows of {self.x!r}: not an (n, e) table")
        if self.ids is None:
            raise ValueError(f"take_rows of {self.x!r}: the step places the "
                             f"batch's ids at every position "
                             f"(StationaryView(..., ids=...))")
        mesh, D = ids.mesh, len(ids.homes)
        Bd = ids.parts[0].shape[0]
        held = [{s: t[s * Bd:(s + 1) * Bd] for s in range(D)}
                for t in self.ids]
        shard = [0] * mesh.size
        for s, h in enumerate(ids.homes):
            shard[h] = s
        out = take_rows_two_axis(
            self.x, self.leaves, held, shard, ids.homes,
            dtype or self.x.dtype, ("emb_rows_home", "emb_grad_home"),
            ids.homes, whole=True)
        return Rows(out, ids.homes, mesh)

    def _columns(self, pos: int, j: int, width: int) -> int:
        """Where entries ``j·width … (j+1)·width − 1`` of this 1-D leaf
        start in the block position ``pos`` holds, which must cover them."""
        lay = self.x.layout
        n = lay.block_shape[0]
        lo = j * width - lay.block_of(pos)[0] * n
        if lo < 0 or lo + width > n:
            raise ValueError(f"position {pos} does not hold entries "
                             f"{j * width}..{(j + 1) * width - 1} of "
                             f"{self.x!r}")
        return lo


def each(fn, *args):
    """``fn(*args)`` once per batch shard at its home (``Mesh.at``) where an
    argument is :class:`Rows` (its shard's tensor), a
    :class:`StationaryView` (:meth:`StationaryView.part` at the home) or
    :class:`HomeViews` (the home's view): the results as Rows, a tuple of
    results as a tuple of Rows. Without Rows, ``fn(*args)``."""
    rows = next((a for a in args if isinstance(a, Rows)), None)
    if rows is None:
        return fn(*args)
    outs = []
    for d, home in enumerate(rows.homes):
        with rows.mesh.at(home):
            outs.append(fn(*(a.parts[d] if isinstance(a, Rows)
                             else a.part(home)
                             if isinstance(a, (StationaryView, HomeViews))
                             else a for a in args)))
    if isinstance(outs[0], tuple):
        return tuple(Rows(list(o), rows.homes, rows.mesh)
                     for o in zip(*outs))
    return Rows(outs, rows.homes, rows.mesh)


def each_home(fn, params, *args):
    """:func:`each` of ``fn(params, *args)`` where ``params`` is a tree
    (dicts, lists) whose :class:`HomeViews` leaves each home reads as its
    own :class:`ShardView`."""
    rows = next(a for a in args if isinstance(a, Rows))

    def at(tree, home):
        if isinstance(tree, dict):
            return {k: at(v, home) for k, v in tree.items()}
        if isinstance(tree, list):
            return [at(v, home) for v in tree]
        return tree.part(home) if isinstance(tree, HomeViews) else tree
    return each(lambda home, *a: fn(at(params, home), *a),
                Rows(list(rows.homes), rows.homes, rows.mesh), *args)


def block_plan(w: StationaryView, homes: Sequence[int]
               ) -> List[Tuple[Tuple[int, int], int, List[int]]]:
    """The work of a product with the (n_in, n_out) weight ``w`` for the
    batch shards at ``homes``: per block (i, j), in row-major block order,
    and per group of batch shards one holder serves (those whose part on
    the spec's free axes is the same: :meth:`StationaryView.holder`),
    ``((i, j), holder, batch shard indices)``. Each holder appears once."""
    D_in, D_out = w.counts
    by_part: Dict[int, List[int]] = {}
    for d, home in enumerate(homes):
        by_part.setdefault(w._home_part(home), []).append(d)
    return [((i, j), part + w._block_part((i, j)), ds)
            for i in range(D_in) for j in range(D_out)
            for part, ds in by_part.items()]


def block_matmul(x: Rows, w: StationaryView, dtype: torch.dtype,
                 bias: StationaryView = None) -> Rows:
    """``x @ w.to(dtype) + bias`` for the rows of every batch shard, each
    at its home, with the (n_in, n_out) weight ``w`` split into D_in ×
    D_out blocks that stay where they lie. The slice of each home's rows
    that block (i, j) contracts goes to the block's holder for that home
    (:meth:`StationaryView.holder`; ``tp_act``), which multiplies the
    slices of all the homes it serves, stacked, by its block in one
    product (the bias's entries of column block j added to the products
    of i = 0, where the holder keeps them). The partial products, in f32
    when D_in > 1, go back to their homes (``tp_partial``), which join the
    column blocks of each i in ascending j, add the i in ascending order in
    f32 and cast the sum once to ``dtype``. A block served at the home
    itself moves nothing, and with D_in = D_out = 1 at the home it is
    ``x @ w.to(dtype)`` bit for bit.

    The backward (:class:`_BlockMatmul`) is the forward with i and j
    swapped: column block j of each home's dY goes to every holder of a
    block (i, j) that served it (``tp_grad_act``); the holder's dX partial
    dY_j @ W_ijᵀ (f32 when D_out > 1) comes home (``tp_grad_partial``),
    where the partials are added in ascending j and cast once to X's
    dtype. The holder computes each home's dW_ij as its own product,
    rounded as autograd rounds the one-device product (in ``dtype``, then
    widened to the leaf's dtype), and adds them in ascending batch order
    into its block's leaf; the bias's gradient is dY_j's column sums at the
    holder of (0, j). On one position with one home and one block it is
    autograd's backward of ``x @ w.to(dtype) + bias`` bit for bit."""
    plan = block_plan(w, x.homes)
    wpos = tuple(h for _, h, _ in plan)
    bpos = (tuple(h for (i, _), h, _ in plan if i == 0)
            if bias is not None else ())
    outs = _BlockMatmul.apply(
        x.mesh, tuple(x.homes), w, bias, dtype, plan, len(x.parts),
        *x.parts, *(w.leaves[h] for h in wpos),
        *(bias.leaves[h] for h in bpos))
    return Rows(list(outs), x.homes, x.mesh)


class _BlockMatmul(torch.autograd.Function):
    """:func:`block_matmul`'s forward and backward; the inputs are the
    homes' rows, then the weight's leaf at each plan entry's holder, then
    the bias's leaf at each holder of an i = 0 block."""

    @staticmethod
    def forward(ctx, mesh, homes, w, bias, dtype, plan, n_x, *tensors):
        xparts = tensors[:n_x]
        wl = dict(zip((h for _, h, _ in plan),
                      tensors[n_x:n_x + len(plan)]))
        bl = dict(zip((h for (i, _), h, _ in plan if i == 0),
                      tensors[n_x + len(plan):]))
        n_in, n_out = w.shape
        D_in, D_out = w.counts
        b_out = n_out // D_out
        cut = _cut_rows(mesh, homes, xparts, n_in, D_in)
        rows = [len(c[0]) for c in cut]
        # with D_in > 1 the holders' partials are f32, so that the sum is
        # rounded to ``dtype`` once, as one product's f32 accumulator is
        pd = dtype if D_in == 1 else torch.float32
        saved = []
        ys = [None] * len(homes)
        # block row by block row: each home adds row i's partials (its
        # column blocks joined in ascending j) to its running sum
        for i in range(D_in):
            got = [[None] * D_out for _ in homes]
            for (bi, j), h, ds in plan:
                if bi != i:
                    continue
                xs = _move(mesh, [cut[d][i] for d in ds],
                           [homes[d] for d in ds], h, "tp_act")
                with mesh.at(h):
                    xin = xs[0] if len(xs) == 1 else torch.cat(xs)
                    del xs
                    wc = _compute_block(w, wl[h], dtype)
                    saved += [xin, wc]
                    p = _mm(xin, wc, pd)
                    if bias is not None and i == 0:
                        lo = bias._columns(h, j, b_out)
                        p = p + bl[h].narrow(0, lo, b_out).to(pd)
                    ps = (torch.split(p, [rows[d] for d in ds])
                          if len(ds) > 1 else (p,))
                del p
                for d, q in zip(ds, ps):
                    got[d][j], = _move(mesh, [q], [h], homes[d],
                                       "tp_partial")
                del ps
            for d, home in enumerate(homes):
                with mesh.at(home):
                    c = got[d][0] if D_out == 1 else torch.cat(got[d], dim=1)
                    got[d] = None
                    ys[d] = c if ys[d] is None else ys[d] + c
                del c
        out = []
        for xd, home, y in zip(xparts, homes, ys):
            with mesh.at(home):
                out.append(y.to(dtype).reshape(*xd.shape[:-1], n_out))
        del ys
        ctx.save_for_backward(*saved)
        ctx.mesh, ctx.homes, ctx.w, ctx.bias = mesh, homes, w, bias
        ctx.dtype, ctx.plan, ctx.pd = dtype, plan, pd
        ctx.x_meta = [(xd.shape, xd.dtype) for xd in xparts]
        ctx.w_dtypes = {h: t.dtype for h, t in wl.items()}
        ctx.b_meta = {h: (t.shape, t.dtype) for h, t in bl.items()}
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, homes, w, plan = ctx.mesh, ctx.homes, ctx.w, ctx.plan
        dtype, pd = ctx.dtype, ctx.pd
        saved = ctx.saved_tensors
        n_in, n_out = w.shape
        D_in, D_out = w.counts
        b_out = n_out // D_out
        dys = []
        for g, home in zip(grads, homes):
            with mesh.at(home):
                dys.append(g.reshape(-1, n_out).to(dtype))
        # the dX partials: f32 when D_out > 1, added at the home in
        # ascending j as they come and cast there once
        gpd = dtype if D_out == 1 else torch.float32
        acc = [[None] * D_in for _ in homes]
        gw, gb = {}, {}
        order = sorted(range(len(plan)), key=lambda k: plan[k][0][::-1])
        for k in order:
            (i, j), h, ds = plan[k]
            xin, wc = saved[2 * k], saved[2 * k + 1]
            dyh = _move(mesh, [dys[d] if D_out == 1
                               else dys[d].narrow(1, j * b_out, b_out)
                               for d in ds], [homes[d] for d in ds], h,
                        "tp_grad_act")
            with mesh.at(h):
                gxs, g_w = _holder_grads(xin, dyh, wc, gpd, ctx.w_dtypes[h])
                gw[k] = g_w.t() if w.transposed else g_w
                if ctx.bias is not None and i == 0:
                    shape, bdt = ctx.b_meta[h]
                    g_b = None
                    for dyd in dyh:
                        t = dyd.to(pd).sum(0).to(bdt)
                        g_b = t if g_b is None else g_b + t
                    lo = ctx.bias._columns(h, j, b_out)
                    if g_b.shape != shape:
                        whole = torch.zeros(shape, dtype=bdt,
                                            device=g_b.device)
                        whole.narrow(0, lo, b_out).copy_(g_b)
                        g_b = whole
                    gb[k] = g_b
            del dyh
            for d, p in zip(ds, gxs):
                p, = _move(mesh, [p], [h], homes[d], "tp_grad_partial")
                with mesh.at(homes[d]):
                    acc[d][i] = p if acc[d][i] is None else acc[d][i] + p
            del gxs, p
        gxs = [_join_home(mesh, home, parts, xdt, shape)
               for (shape, xdt), home, parts in zip(ctx.x_meta, homes, acc)]
        del acc
        return (None,) * 7 + (*gxs, *(gw[k] for k in range(len(plan))),
                              *(gb[k] for k in sorted(gb)))


def _cut_rows(mesh, homes, parts, n_in: int, D_in: int):
    """Each home's rows as (rows, n_in), split at the home into the D_in
    column slices the weight's block rows contract."""
    cut = []
    for xd, home in zip(parts, homes):
        with mesh.at(home):
            flat = xd.reshape(-1, n_in)
            cut.append(torch.split(flat, n_in // D_in, dim=1) if D_in > 1
                       else (flat,))
    return cut


def _compute_block(w: StationaryView, leaf: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """A holder's block of ``w`` as the product reads it: transposed with
    the view, in the compute dtype."""
    return (leaf.T if w.transposed else leaf).to(dtype)


def _move(mesh, parts, srcs, dst: int, name: str) -> List[torch.Tensor]:
    """``parts[k]`` (at position ``srcs[k]``) at position ``dst``, in
    order; the bytes of those that move counted under ``name``. Not a node
    of autograd: the functions here move the gradients themselves."""
    with span(name), mesh.moving():
        n = sum(_nbytes(p) for p, src in zip(parts, srcs) if src != dst)
        if n:
            mesh.count(name, n, to=dst)
        with mesh.at(dst):
            return [p.to(mesh.device(dst)) for p in parts]


def _holder_grads(x: torch.Tensor, dys: List[torch.Tensor],
                  wc: torch.Tensor, gpd: torch.dtype, wdt: torch.dtype):
    """A holder's backward of its block product ``x @ wc``, where ``x``
    stacks the rows of the homes it serves and ``dys`` holds each home's
    dY block, in batch order: each home's dX partial in ``gpd``, from one
    product over the stacked rows, and the block's dW, each home's its own
    product rounded as autograd rounds the one-device product (in ``wc``'s
    dtype, then widened to the leaf's ``wdt``) and added in batch order."""
    rows = [len(t) for t in dys]
    dy = dys[0] if len(dys) == 1 else torch.cat(dys)
    gx = _input_grad(dy, wc, x, gpd)
    del dy
    gxs = torch.split(gx, rows) if len(rows) > 1 else (gx,)
    xs = torch.split(x, rows) if len(rows) > 1 else (x,)
    g_w = None
    for xd, dyd in zip(xs, dys):
        t = _weight_grad(xd, wc, dyd).to(wdt)
        g_w = t if g_w is None else g_w + t
    return gxs, g_w


def _join_home(mesh, home: int, parts, dtype: torch.dtype, shape):
    """A home's column blocks ``parts`` (its gradient's f32 or compute-
    dtype sums) cast to ``dtype`` and joined in order, as ``shape``."""
    with mesh.at(home):
        cols = [g.to(dtype) for g in parts]
        g = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        return g.reshape(shape)


def _onehot(labels: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """The one-hot rows of ``labels`` over vocab entries ``lo … lo + n − 1``
    (a label elsewhere, or −1, gives a zero row)."""
    return (labels - lo)[..., None] == torch.arange(n, device=labels.device)



def _weight_grad(x: torch.Tensor, w: torch.Tensor,
                 dy: torch.Tensor) -> torch.Tensor:
    """The gradient of ``w`` in ``x @ w`` for ``dy``, computed as autograd's
    ``mm`` backward computes it (a column-major ``w`` gets its gradient
    as ``(dyᵀ x)ᵀ``)."""
    if w.stride(0) == 1 and w.stride(1) == w.shape[0]:
        return dy.t().mm(x).t()
    return x.t().mm(dy)


def _input_grad(dy: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                out: torch.dtype) -> torch.Tensor:
    """The gradient of ``x`` in ``x @ w`` for ``dy``, in ``out``: as
    autograd's ``mm`` backward computes it where ``out`` is ``dy``'s dtype,
    else through :func:`_mm`."""
    if out != dy.dtype:
        return _mm(dy, w.t(), out)
    if x.stride(0) == 1 and x.stride(1) == x.shape[0]:
        return w.mm(dy.t()).t()
    return dy.mm(w.t())


def _mm(a: torch.Tensor, b: torch.Tensor, out: torch.dtype) -> torch.Tensor:
    """``a @ b`` with the result in ``out``: the card's and meta's f32
    output of a bf16/f16 product (``torch.mm``'s ``out_dtype``), the
    operands widened on the CPU, which has no such product; the products
    of two bf16 or f16 entries are exact in f32 either way."""
    if out == a.dtype:
        return a @ b
    if a.device.type == "cpu":
        return a.to(out) @ b.to(out)
    return torch.mm(a, b, out_dtype=out)


# -- the head where it lies (the ``fsdp`` vocab-parallel loss and prefill) ----
#
# Under ``fsdp`` the head lies as P(None, ("data", "model")) (a tied table as
# P(("data", "model"), None), read as its transpose), one vocab block a
# position, or, where the vocabulary does not divide 256 (qwen3's 151,936
# entries), as ``fit_spec``'s fallback P(None, "data"), each block repeated
# along "model". The reference's compiled ``fsdp`` train step and prefill
# (read by ``tests/test_torch_sharded_train.py`` and
# ``tests/test_torch_tp_serve.py``, the head's collectives told apart by op
# and source line: the product ``hidden @ head_w`` and the log-sum-exp's
# reductions) form the head so:
#
# * one block a position: the hidden rows are all-gathered along "data", so
#   each position holds every row of the batch; each multiplies them by its
#   block; the row maximum and the sum of the exponentials are all-reduced
#   over every position (an f32 per row each). The backward: each position's
#   dX partial of every row is all-reduced along "data", then each batch
#   shard's rows over "model"; each block's dW stays where the block lies.
# * the fallback on a square mesh: the hidden rows go to the transposed
#   position (collective-permute) and are all-gathered along "model", so
#   position (a, b) multiplies every row by block a; the statistics are
#   all-reduced along "data". The backward works on (batch shard d, block
#   m) at position (d, m): the head block comes there from (m, d)
#   (collective-permute), the dX partials are all-reduced over "model" and
#   the block's dW goes back to (m, d) (collective-permute), where the
#   block gradients of the batch shards are added over "model" (the step's
#   ``grad_psum``).
#
# The port keeps a batch shard at its home, so the rows (and the labels)
# reach the shard's group first (``head_rows_home``, ``head_labels``); the
# target logit's partials go home (``head_target``), the loss's gradient
# to the blocks (``head_scale``) and, in the fallback, each (batch shard,
# block)'s logit gradient from the position that formed the logits
# (``head_grad_relayout``): moves the reference's partitioner makes in
# other forms (a gathered one-hot contraction, an all-to-all).


def _form(lay, mesh, transposed: bool):
    """:func:`head_form` of a head placed by the layout ``lay``."""
    if len(lay.counts) != 2:
        return None
    v = 0 if transposed else 1
    if lay.counts[1 - v] != 1 or (lay.counts[v] == 1 and mesh.size > 1):
        return None
    if lay.counts[v] == mesh.size:
        return "lie"
    if (tuple(mesh.axis_names) == ("data", "model")
            and tuple(lay.axes[v]) == ("data",)
            and mesh.axis_size("data") == mesh.axis_size("model")):
        return "column"
    return None


def head_form(x: ShardedTensor, transposed: bool = False):
    """How the reference's partitioner forms the product with the head
    ``x`` ((d, V); with ``transposed`` a tied (V, d) table read as its
    transpose), by its layout: ``"lie"`` where the vocabulary is split into
    one block a position of the mesh (one block on a mesh of one
    position), ``"column"`` where it is split over "data" alone on a
    square ("data", "model") mesh, each block repeated along "model"; else
    None (the head is then read whole)."""
    return _form(x.layout, x.mesh, transposed)


def _to(mesh, t: torch.Tensor, frm: int, to: int, name: str) -> torch.Tensor:
    """``t`` (at ``frm``) at ``to``, counted under ``name`` where it moves."""
    if frm == to:
        return t
    with span(name), mesh.at(to), mesh.moving():
        mesh.count(name, _nbytes(t), frm=frm, to=to)
        return t.to(mesh.device(to), copy=True)


def _allreduce(mesh, srcs: Sequence[int], parts: Sequence[torch.Tensor],
               to: Sequence[int], name: str, combine
               ) -> Dict[int, torch.Tensor]:
    """``parts[k]`` (equal shapes, at ``srcs[k]``) all-reduced as a
    reduce-scatter and an all-gather move them: the flattened parts cut
    into K chunks, chunk k combined at ``srcs[k]`` from every part's chunk
    in ascending k (``combine(acc, piece)``: ``torch.add``,
    ``torch.maximum``), then every combined chunk sent to each position of
    ``to``. Both halves count under ``name``. The reduced parts,
    flattened, at each position of ``to``; with one part, the part."""
    K, T = len(srcs), parts[0].numel()
    cut = [k * T // K for k in range(K + 1)]
    flat = []
    for q, part in zip(srcs, parts):
        with mesh.at(q):
            flat.append(part.reshape(-1))
    chunks = []
    for k, dst in enumerate(srcs):
        lo, size = cut[k], cut[k + 1] - cut[k]
        out = None
        for i, q in enumerate(srcs):
            with mesh.at(dst):
                piece = flat[i].narrow(0, lo, size)
            if q != dst and size:
                with span(name), mesh.at(dst), mesh.moving():
                    mesh.count(name, _nbytes(piece), frm=q, to=dst)
                    piece = piece.to(mesh.device(dst))
            with mesh.at(dst):
                out = piece if out is None else combine(out, piece)
        chunks.append(out)
    del flat
    reduced = {}
    for p in to:
        pieces = []
        for q, ch in zip(srcs, chunks):
            if q != p and ch.numel():
                with span(name), mesh.at(p), mesh.moving():
                    mesh.count(name, _nbytes(ch), frm=q, to=p)
                    ch = ch.to(mesh.device(p))
            pieces.append(ch)
        with mesh.at(p):
            reduced[p] = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return reduced


class _HeadPlan(NamedTuple):
    """Where :class:`_VocabParallelXent` and :func:`head_logits` work: ``form``
    (:func:`head_form`); the positions that form logits (``sites``, in
    position order) and the vocab block each forms (``blocks``); per site
    and home the hops of the home's rows there, ``(kind, from, to)``,
    kind ``"home"`` (within the home's group), ``"permute"`` or
    ``"gather"`` (``routes``); the sites whose statistics fold together,
    in block order (``stats``); per home the sites whose target partials it
    adds, in block order (``targets``); in the fallback, per home and
    block, in block order, the position that takes the backward's work on
    them (``units``; where each block lies once, the block's site)."""
    form: str
    sites: Tuple[int, ...]
    blocks: Tuple[int, ...]
    routes: Tuple[Tuple[Tuple[Tuple[str, int, int], ...], ...], ...]
    stats: Tuple[Tuple[int, ...], ...]
    targets: Tuple[Tuple[int, ...], ...]
    units: Tuple[Tuple[int, ...], ...]


@functools.lru_cache(maxsize=64)
def _head_plan(mesh, spec, shape: Tuple[int, ...], transposed: bool,
               homes: Tuple[int, ...],
               groups: Tuple[Tuple[int, ...], ...]) -> _HeadPlan:
    """The :class:`_HeadPlan` of a head ``shape`` placed by ``spec``
    (``transposed``: a tied table) for the batch shards at ``homes``, each
    with its ``groups`` entry. One block a position: each block's position
    forms every home's logits of it, the rows routed as
    :func:`_row_plan` routes a lookup's ids. The fallback: every position
    (a, b) forms block a, a home's rows going from the home to (d, a) of
    its group, to (a, d) and along "model" to (a, b); the statistics fold
    along "data"; batch shard d's work on block m is at (d, m)."""
    from repro_torch.distrib.sharding import Layout
    lay = Layout(mesh, spec, shape)
    v = 0 if transposed else 1
    form = _form(lay, mesh, transposed)
    sites = tuple(range(mesh.size))
    if form == "lie":
        blocks = tuple(lay.block_of(q)[v] for q in sites)
        routes = _row_plan(mesh, sites, homes, groups, False).routes
        order = tuple(sorted(sites, key=lambda q: blocks[q]))
        return _HeadPlan(form, sites, blocks, routes, (order,),
                         (order,) * len(homes), ())
    if form != "column":
        raise ValueError(f"a head placed as {spec} on {mesh!r} is read "
                         f"whole")
    D = mesh.axis_size("data")

    def at(a, b):
        return _position(mesh, {"data": a, "model": b})
    blocks = tuple(mesh.coords(q)["data"] for q in sites)
    routes = []
    for q in sites:
        a, b = mesh.coords(q)["data"], mesh.coords(q)["model"]
        per = []
        for h in homes:
            s = mesh.coords(h)["data"]
            hops = (("home", h, at(s, a)), ("permute", at(s, a), at(a, s)),
                    ("gather", at(a, s), q))
            per.append(tuple(hop for hop in hops if hop[1] != hop[2]))
        routes.append(tuple(per))
    stats = tuple(tuple(at(a, b) for a in range(D)) for b in range(D))
    units = tuple(tuple(at(mesh.coords(h)["data"], m) for m in range(D))
                  for h in homes)
    return _HeadPlan(form, sites, blocks, tuple(routes), stats,
                     (stats[0],) * len(homes), units)


def _head_leaves(views: Sequence["ShardView"], form: str, v: int):
    """The leaves that take the head's gradient, in vocab order: the first
    view's blocks (one block a position), or each view's blocks on its
    "model" column (the fallback, :meth:`ShardView.to_column`), views in
    batch order."""
    if form == "lie":
        views = views[:1]
    out = []
    for view in views:
        if form == "column":
            view.to_column()
        out += [view.proxies[b] for b in sorted(view.proxies,
                                                key=lambda b: b[v])]
    return out


def _rows_of(t: torch.Tensor, sizes: Sequence[int], i: int) -> torch.Tensor:
    """Home ``i``'s rows of ``t``, which stacks every home's in order."""
    return t.narrow(0, sum(sizes[:i]), sizes[i])


class _VocabParallelXent(torch.autograd.Function):
    """:func:`vocab_parallel_xent`; the inputs are the homes' hidden rows,
    their labels, then :func:`_head_leaves`."""

    @staticmethod
    def forward(ctx, mesh, plan, x, transposed, homes, n, *tensors):
        hs, labs, leaves = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        cd, d = hs[0].dtype, hs[0].shape[-1]
        sizes = [h.numel() // d for h in hs]
        K = len(set(plan.blocks))
        Vb = x.shape[0 if transposed else 1] // K
        moved_h, moved_l = {}, {}
        xs, wcs, ps, lq, ms = {}, {}, {}, {}, {}
        # every site: each home's rows times its block, the row maxima
        for q in plan.sites:
            rows = [_hop(mesh, moved_h, i, h, plan.routes[q][i], "head_rows_")
                    for i, h in enumerate(hs)]
            lab = [_hop(mesh, moved_l, i, t, plan.routes[q][i],
                        lambda kind: "head_labels")
                   for i, t in enumerate(labs)]
            with mesh.at(q):
                xq = [r.reshape(-1, d) for r in rows]
                xs[q] = xq[0] if n == 1 else torch.cat(xq)
                lab = [t.reshape(-1) for t in lab]
                lq[q] = lab[0] if n == 1 else torch.cat(lab)
                wcs[q] = _site_weight(x, q, transposed, cd)
                ps[q] = _mm(xs[q], wcs[q], cd)
                ms[q] = ps[q].float().amax(dim=-1)
            del rows, xq
        del moved_h, moved_l
        # the statistics: the maxima, then the sums of the exponentials,
        # all-reduced over each group's sites (one block: logsumexp's bits)
        lse = {}
        for group in plan.stats:
            got = _allreduce(mesh, group, [ms[q] for q in group], group,
                             "head_stats", torch.maximum)
            sums = []
            for q in group:
                with mesh.at(q):
                    ms[q] = got[q]
                    sums.append(torch.exp(ps[q].float() - got[q][:, None])
                                .sum(dim=-1))
            got = _allreduce(mesh, group, sums, group, "head_stats",
                             torch.add)
            for q in group:
                with mesh.at(q):
                    lse[q] = ms[q] + torch.log(got[q])
        del ms
        # each home's target logits from the sites, its sum and count
        tots, counts = [], []
        for i, (h, lab_h) in enumerate(zip(homes, labs)):
            t = None
            for q in plan.targets[i]:
                with mesh.at(q):
                    lg = _rows_of(ps[q], sizes, i).float()
                    lg = lg.reshape(*lab_h.shape, Vb)
                    lab = _rows_of(lq[q], sizes, i).reshape(lab_h.shape)
                    lo = plan.blocks[q] * Vb
                    if K == 1:   # the one-hot contraction's own bits
                        tq = torch.einsum("bsv,bsv->bs", lg,
                                          _onehot(lab, lo, Vb).float())
                    else:        # its value, without an f32 one-hot
                        j = (lab.long() - lo)[..., None]
                        inside = (j >= 0) & (j < Vb)
                        tq = torch.where(inside, lg.gather(
                            -1, j.clamp(0, Vb - 1)), 0.0)[..., 0]
                    del lg
                tq = _to(mesh, tq, q, h, "head_target")
                with mesh.at(h):
                    t = tq if t is None else t + tq
            with mesh.at(h):
                lse_h = _rows_of(lse[h], sizes, i).reshape(lab_h.shape)
                valid = lab_h >= 0
                tots.append(torch.where(valid, lse_h - t, 0.0).sum())
                counts.append(valid.sum().to(torch.int32))
        sites = plan.sites
        # the fallback's backward reads the logits of the sites (m, m) only
        kept = (set(sites) if plan.form == "lie" else
                {_position(mesh, {"data": m, "model": m}) for m in range(K)})
        with mesh.at(homes[0]):
            none = hs[0].new_empty(0)
        ctx.save_for_backward(*(xs[q] for q in sites),
                              *(wcs[q] for q in sites),
                              *(ps[q] if q in kept else none for q in sites),
                              *(lq[q] for q in sites),
                              *(lse[q] for q in sites), *leaves)
        del ps
        ctx.mesh, ctx.plan, ctx.transposed, ctx.homes = (mesh, plan,
                                                         transposed, homes)
        ctx.sizes, ctx.Vb, ctx.K = sizes, Vb, K
        ctx.h_meta = [(h.shape, h.dtype) for h in hs]
        ctx.mark_non_differentiable(*counts)
        return tuple(tots) + tuple(counts)

    @staticmethod
    def backward(ctx, *grads):
        mesh, plan, homes = ctx.mesh, ctx.plan, ctx.homes
        sizes, Vb, K, tr = ctx.sizes, ctx.Vb, ctx.K, ctx.transposed
        n, S = len(homes), len(plan.sites)
        saved = ctx.saved_tensors
        xs, wcs, ps, lq, lse = (dict(zip(plan.sites, saved[j * S:(j + 1) * S]))
                                for j in range(5))
        leaves = saved[5 * S:]
        gpd = ctx.h_meta[0][1] if K == 1 else torch.float32
        scales = {}

        def scale(i, q):
            """Home ``i``'s gradient of its sum, at ``q``."""
            if (i, q) not in scales:
                scales[(i, q)] = _to(mesh, grads[i], homes[i], q,
                                     "head_scale")
            return scales[(i, q)]

        def logit_grad(q, i):
            """The gradient of site ``q``'s logits of home ``i``'s rows
            (all homes' with ``i`` None), in the compute dtype."""
            rows = range(n) if i is None else (i,)
            with mesh.at(q):
                gs = []
                for r in rows:
                    g = scale(r, q)
                    with mesh.at(q):
                        gs.append(torch.where(_rows_of(lq[q], sizes, r) >= 0,
                                              g, 0.0))
                g = gs[0] if len(gs) == 1 else torch.cat(gs)
                lo = 0 if i is None else sum(sizes[:i])
                size = sum(sizes) if i is None else sizes[i]
                lg = ps[q].narrow(0, lo, size).float()
                # logsumexp's backward, then the one-hot contraction's
                dl = g[:, None] * torch.exp(
                    lg - lse[q].narrow(0, lo, size)[:, None])
                del lg
                hot = _onehot(lq[q].narrow(0, lo, size),
                              plan.blocks[q] * Vb, Vb)
                if K == 1:      # autograd's own ops on one device
                    dl = dl - hot.float() * g[:, None]
                else:           # their values, without an f32 one-hot
                    dl = torch.where(hot, dl - g[:, None], dl)
                del hot
                return dl.to(wcs[q].dtype)

        gws = [None] * len(leaves)
        parts = [dict() for _ in range(n)]   # home → {unit: dX partial}
        if plan.form == "lie":
            order = plan.stats[0]
            for j, q in enumerate(order):
                dl = logit_grad(q, None)
                with mesh.at(q):
                    dys = (torch.split(dl, sizes) if n > 1 else (dl,))
                    gxs, g_w = _holder_grads(xs[q], list(dys), wcs[q], gpd,
                                             leaves[j].dtype)
                    gws[j] = g_w.t() if tr else g_w
                    del dl, dys
                    gx = gxs[0] if n == 1 else torch.cat(gxs)
                    for i in range(n):
                        parts[i][q] = gx if K > 1 else _rows_of(gx, sizes, i)
            if K > 1:
                # along "data", every row; then each home's rows over the
                # sites of its group, to the home
                lines: Dict[Tuple, List[int]] = {}
                for q in plan.sites:
                    c = mesh.coords(q)
                    lines.setdefault(tuple(v for a, v in c.items()
                                           if a != "data"), []).append(q)
                summed = {}
                for line in lines.values():
                    if len(line) == 1:
                        summed[line[0]] = parts[0][line[0]]
                        continue
                    got = _allreduce(mesh, line, [parts[0][q] for q in line],
                                     line, "head_grad_data", torch.add)
                    summed.update(got)
                for i in range(n):
                    group = [q for q in plan.sites if all(
                        mesh.coords(q)[a] == mesh.coords(homes[i])[a]
                        for a in mesh.axis_names if a != "model")]
                    rows = []
                    for q in group:
                        with mesh.at(q):
                            rows.append(_rows_of(summed[q].reshape(
                                -1, xs[q].shape[1]), sizes, i))
                    parts[i] = {q: r for q, r in zip(group, rows)}
        else:
            D = K
            for i, h in enumerate(homes):
                s = mesh.coords(h)["data"]
                for m in range(D):
                    u = plan.units[i][m]
                    src = _position(mesh, {"data": m, "model": m})
                    dl = _to(mesh, logit_grad(src, i), src, u,
                             "head_grad_relayout")
                    leaf = leaves[i * D + m]
                    held = _position(mesh, {"data": m, "model": s})
                    with mesh.at(held):
                        w = leaf.detach()
                    w = _to(mesh, w, held, u, "head_block_permute")
                    with mesh.at(u):
                        wc = (w.T if tr else w).to(dl.dtype)
                        xi = _rows_of(xs[u], sizes, i)
                        parts[i][u] = _input_grad(dl, wc, xi, gpd)
                        g_w = _weight_grad(xi, wc, dl).to(leaf.dtype)
                        g_w = g_w.t() if tr else g_w
                        del dl, wc, w
                    gws[i * D + m] = _to(mesh, g_w, u, held,
                                         "head_wgrad_permute")
        ghs = []
        for i, (h, (shape, hdt)) in enumerate(zip(homes, ctx.h_meta)):
            group = list(parts[i])
            if len(group) == 1:
                g = parts[i][group[0]]
            else:
                g = _allreduce(mesh, group, [parts[i][q] for q in group],
                               [h], "head_grad_model", torch.add)[h]
            with mesh.at(h):
                ghs.append(g.to(hdt).reshape(shape))
        return ((None,) * 6 + tuple(ghs) + (None,) * n + tuple(gws))


def _site_weight(x: ShardedTensor, q: int, transposed: bool,
                 dtype) -> torch.Tensor:
    """The block position ``q`` holds as the product reads it, (d, V/K) in
    ``dtype``."""
    leaf = x.shards[q]
    return (leaf.T if transposed else leaf).to(dtype)


def vocab_parallel_xent(hidden: "Rows", labels: "Rows",
                        views: Sequence["ShardView"],
                        transposed: bool = False) -> Tuple["Rows", "Rows"]:
    """Each home's sum of the cross entropy of the logits ``hidden @
    head`` over its labels ≥ 0, and its int32 count of them
    (``models.layers.softmax_xent_sharded``'s terms), over the blocks of
    the head where they lie (``views``: one :class:`ShardView` a home, in
    batch order; ``transposed``: a tied table), formed as the reference's
    partitioner forms the vocab-parallel loss (see above): the rows go to
    every block's position (``head_rows_home``, ``head_rows_gather``; the
    fallback's ``head_rows_permute``), each position takes its block's
    logits of every row in the compute dtype, the row maxima and the sums
    of the exponentials are all-reduced over the positions of the blocks
    (``head_stats``), lse = max + log(sum), and each block's target logits
    go home (``head_target``, added in block order). One block gives
    ``softmax_xent_sharded``'s bits.

    The backward: each home's gradient goes to the blocks (``head_scale``);
    the logits' gradient, softmax − one-hot as autograd takes it on one
    device, cast to the compute dtype; each block's dW is each home's own
    product added in batch order, and stays where the block lies (the
    fallback: made at (d, m) with the block brought there,
    ``head_block_permute``, and sent back, ``head_wgrad_permute``); the dX
    partials (f32 with more than one block) are all-reduced along "data"
    over every row (``head_grad_data``), then each home's rows over its
    group to the home (``head_grad_model``), and cast once."""
    x, mesh = views[0].x, hidden.mesh
    form = head_form(x, transposed)
    plan = _head_plan(mesh, x.spec, tuple(x.shape), transposed,
                      tuple(hidden.homes), tuple(tuple(v.group)
                                                 for v in views))
    leaves = _head_leaves(views, form, 0 if transposed else 1)
    n = len(hidden.parts)
    out = _VocabParallelXent.apply(mesh, plan, x, transposed,
                                   tuple(hidden.homes), n, *hidden.parts,
                                   *labels.parts, *leaves)
    return (Rows(list(out[:n]), hidden.homes, mesh),
            Rows(list(out[n:]), hidden.homes, mesh))


def head_logits(rows: "Rows", views: Sequence["ShardView"],
                transposed: bool = False) -> List[torch.Tensor]:
    """Each home's logits ``rows @ head`` (the head's blocks where they
    lie, as :func:`vocab_parallel_xent` reads them; no gradient), formed as the
    reference's partitioner forms a prefill's: the rows go to every
    block's position as the loss's do, each position multiplies them by its
    block in the rows' dtype, and the blocks of each home's logits are
    joined in vocab order at position 0 (``logits_gather``, the port's
    own: the reference leaves them where they are)."""
    x, mesh = views[0].x, rows.mesh
    plan = _head_plan(mesh, x.spec, tuple(x.shape), transposed,
                      tuple(rows.homes), tuple(tuple(v.group)
                                               for v in views))
    cd, d = rows.dtype, rows.parts[0].shape[-1]
    sizes = [t.numel() // d for t in rows.parts]
    n = len(rows.parts)
    moved, blocks = {}, {}
    first = {}          # vocab block → the first site that forms it
    for q in plan.sites:
        first.setdefault(plan.blocks[q], q)
    for j, q in sorted(first.items()):
        got = [_hop(mesh, moved, i, t, plan.routes[q][i], "head_rows_")
               for i, t in enumerate(rows.parts)]
        with mesh.at(q):
            xq = [t.reshape(-1, d) for t in got]
            xq = xq[0] if n == 1 else torch.cat(xq)
            blocks[j] = _to(mesh, _mm(xq, _site_weight(x, q, transposed, cd),
                                      cd), q, 0, "logits_gather")
        del got, xq
    out = []
    with mesh.at(0):
        for i, t in enumerate(rows.parts):
            parts = [_rows_of(blocks[j], sizes, i) for j in sorted(blocks)]
            lg = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            out.append(lg.reshape(*t.shape[:-1], lg.shape[-1]))
    return out


class LyingHead:
    """The LM's head where its blocks lie, as the ``fsdp`` steps read it
    (``TransformerLM`` on the vocab-parallel route): the views of
    ``params["head"]``, or with ``transposed`` of a tied table read as its
    transpose, one :class:`ShardView` a home (a :class:`HomeViews`, or one
    view). :meth:`xent` takes the loss (:func:`vocab_parallel_xent`),
    :meth:`logits` a prefill's logits (:func:`head_logits`)."""

    def __init__(self, views, transposed: bool = False):
        if isinstance(views, HomeViews):
            self.views, self.mesh = list(views.views), views.mesh
        else:
            self.views, self.mesh = [views], views.x.mesh
        self.transposed = transposed

    def xent(self, hidden, labels):
        """The mean cross entropy: a home's tensor for one view's hidden
        tensor; for ``Rows`` each home's sum and count added over the
        homes (``collectives.batch_mean``), as Rows."""
        if isinstance(hidden, Rows):
            return batch_mean(*vocab_parallel_xent(
                hidden, labels, self.views, self.transposed), None)
        home = self.views[0].home
        tots, counts = vocab_parallel_xent(
            Rows([hidden], [home], self.mesh),
            Rows([labels], [home], self.mesh), self.views, self.transposed)
        with self.mesh.at(home):
            return tots.parts[0] / torch.clamp_min(counts.parts[0], 1)

    def logits(self, rows: "Rows") -> List[torch.Tensor]:
        return head_logits(rows, self.views, self.transposed)


# -- a column block product and its row blocks' after it (BST's ``mlp_w0``) --
#
# BST's ``mlp_w0`` lies as P(None, "model"), its bias and ``mlp_w1``
# replicated. The reference's compiled train step (read by
# ``tests/test_torch_sharded_gnn_bst.py``, the MLP line's collectives) keeps
# the column blocks where they lie: each position of a batch shard's
# "model" group multiplies the shard's rows by its column block, adds its
# bias entries, takes the activation and multiplies by the matching rows of
# ``mlp_w1``; the partial products are all-reduced over "model". The
# backward all-reduces the dX partials of ``mlp_w0``'s input over "model";
# each block's dW stays where the block lies. The port's batch shard lies
# at its home, so its rows go to the group first (``mlp_rows_home``), the
# sum's gradient goes back to it (``mlp_grad_home``), and the bias's and
# ``mlp_w1``'s slices come from the home's copy of the replicated leaves
# (``mlp_weights_home``, their gradients back the same way): the
# reference's positions each hold their own copy.


class _GroupCopy(torch.autograd.Function):
    """``x`` (at ``home``) at each position of ``pos`` (``mlp_rows_home``);
    the backward all-reduces the copies' gradients to the home as a
    reduce-scatter and an all-gather move them, added in ``pos`` order
    (``mlp_grad_sum``)."""

    @staticmethod
    def forward(ctx, mesh, home, pos, x):
        ctx.mesh, ctx.home, ctx.pos, ctx.shape = mesh, home, pos, x.shape
        return tuple(x.clone() if p == home
                     else _to(mesh, x, home, p, "mlp_rows_home")
                     for p in pos)

    @staticmethod
    def backward(ctx, *grads):
        g = _allreduce(ctx.mesh, ctx.pos, grads, [ctx.home], "mlp_grad_sum",
                       torch.add)[ctx.home]
        return None, None, None, g.reshape(ctx.shape)


class _GroupSum(torch.autograd.Function):
    """The partial products ``parts`` (at ``pos``) all-reduced to ``home``
    as a reduce-scatter and an all-gather move them, added in ``pos``
    order (``mlp_sum``); the backward copies the sum's gradient to every
    position of ``pos`` (``mlp_grad_home``)."""

    @staticmethod
    def forward(ctx, mesh, home, pos, *parts):
        ctx.mesh, ctx.home, ctx.pos = mesh, home, pos
        total = _allreduce(mesh, pos, parts, [home], "mlp_sum",
                           torch.add)[home]
        return total.reshape(parts[0].shape)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None) + tuple(
            g.clone() if p == ctx.home
            else _to(ctx.mesh, g, ctx.home, p, "mlp_grad_home")
            for p in ctx.pos)


def column_row_product(x: torch.Tensor, w0: "ShardView", b0, w1, act
                       ) -> torch.Tensor:
    """``act(x @ w0 + b0) @ w1`` for a batch shard's rows ``x`` (at its
    home), with ``w0`` split into column blocks over the shard's group
    (:class:`ShardView`) that stay where they lie, as the reference's
    partitioner forms BST's ``mlp_w0`` (see above): the rows go to each
    block's position (``mlp_rows_home``), which multiplies them by its
    block, adds its entries of ``b0``, applies ``act`` and multiplies by its
    rows of ``w1`` (both sent from the home's copy, ``mlp_weights_home``);
    the partial products are added at the home in block order
    (``mlp_sum``: a reduce-scatter and an all-gather's bytes). One block at
    the home is the plain product, bit for bit."""
    mesh, home = w0.x.mesh, w0.home
    order = sorted(w0.proxies)
    pos = tuple(w0.sources[b] for b in order)
    bias, w_next = local(b0), local(w1)
    width = w0.x.shape[1] // len(order)
    xs = _GroupCopy.apply(mesh, home, pos, x)
    parts = []
    for j, (b, p, xp) in enumerate(zip(order, pos, xs)):
        bj = bias.narrow(0, j * width, width)
        wj = w_next.narrow(0, j * width, width)
        if p != home:
            bj = send(bj, mesh, home, p, "mlp_weights_home", True)
            wj = send(wj, mesh, home, p, "mlp_weights_home", True)
        with mesh.at(p):
            parts.append(act(xp @ w0.proxies[b] + bj) @ wj)
    return _GroupSum.apply(mesh, home, pos, *parts)


# -- Megatron over "model" × ZeRO over "data" (the tp2d train step) -----------
#
# The train step under ``tp2d`` splits the work as the reference's partitioner
# does under ``act_spec = P("data", None, None)``: every position of the mesh
# holds its batch shard's activations (``Rows`` over all the positions), the
# same at every position of the shard's "model" group, except where a layer
# splits them by "model" (the heads, a column block, the experts). A weight is
# read through a :class:`TPView`: each position gathers, along "data", the
# blocks of its own "model" column (``tp_zero_gather``) and multiplies there
# (:func:`tp_linear`); a row block's f32 partial products are summed over
# "model" (``tp_model_sum``). Every collective's backward is its conjugate (a
# gather ↔ a reduce-scatter, a sum ↔ the identity, a slice of replicated work
# ↔ a gather of the slices' gradients).


def _model_of(mesh, pos: int) -> int:
    """``pos``'s "model" coordinate (0 on a mesh without that axis)."""
    return mesh.coords(pos).get("model", 0)


def _model_size(mesh) -> int:
    return mesh.axis_size("model") if "model" in mesh.axis_names else 1


def _position(mesh, coords: Dict[str, int]) -> int:
    """The row-major position of ``coords``."""
    pos = 0
    for a, n in zip(mesh.axis_names, mesh.shape):
        pos = pos * n + coords[a]
    return pos


class _GatherPlan(NamedTuple):
    """Where each position's gathered tensor of a leaf comes from
    (:meth:`TPView.gathered`): per position, its shape, and per block it
    reads ``(block, holder, slices in the gathered tensor)``; per block,
    its owner (first holder) and the collector of each batch shard that
    reads it, in batch order."""
    shape: Tuple[Tuple[int, ...], ...]
    reads: Tuple[Tuple[Tuple[Tuple[int, ...], int, Tuple[slice, ...]], ...],
                 ...]
    owners: Dict[Tuple[int, ...], int]
    collectors: Dict[Tuple[int, ...], Tuple[int, ...]]


@functools.lru_cache(maxsize=4096)
def _gather_plan(mesh, spec, shape: Tuple[int, ...],
                 groups: Tuple[Tuple[int, ...], ...]) -> _GatherPlan:
    """The :class:`_GatherPlan` of a ``shape`` leaf under ``spec`` on
    ``mesh`` with batch shards ``groups`` (made once per layout: a dry run
    on 256 positions reads it for every leaf of every layer)."""
    lay = Layout(mesh, spec, shape)
    reads, shapes = [], []
    firsts: Dict[Tuple[int, ...], Dict[int, int]] = {}
    shard = {p: d for d, g in enumerate(groups) for p in g}
    for pos in range(mesh.size):
        coords = mesh.coords(pos)
        m = coords.get("model", 0)
        # per dimension, the block indices whose "model" digit is m
        wanted = []
        for axes, n in zip(lay.axes, lay.counts):
            keep = []
            for k in range(n):
                digits, r = {}, k
                for a in reversed(axes):
                    digits[a] = r % mesh.axis_size(a)
                    r //= mesh.axis_size(a)
                if digits.get("model", m) == m:
                    keep.append((k, digits))
            wanted.append(keep)
        shapes.append(tuple(len(w) * b
                            for w, b in zip(wanted, lay.block_shape)))
        mine = []
        for combo in itertools.product(*(enumerate(w) for w in wanted)):
            block = tuple(k for _, (k, _) in combo)
            at = dict(coords)
            for _, (_, digits) in combo:
                at.update(digits)
            holder = _position(mesh, at)
            sl = tuple(slice(i * b, (i + 1) * b)
                       for (i, _), b in zip(combo, lay.block_shape))
            mine.append((block, holder, sl))
            # the first position of a batch shard that reads this block
            firsts.setdefault(block, {}).setdefault(shard[pos], pos)
        reads.append(tuple(mine))
    owners = {b: lay.holders(b)[0] for b in lay.blocks()}
    collectors = {b: tuple(by[d] for d in sorted(by))
                  for b, by in firsts.items()}
    return _GatherPlan(tuple(shapes), tuple(reads), owners, collectors)


class TPView(StationaryView):
    """A placed parameter leaf as the ``tp2d`` train step reads it, on a
    mesh whose batch shards are ``groups`` (``batch_groups``'s). Position
    ``pos`` reads the blocks whose "model" part is its "model" coordinate,
    gathered whole along the other axes (:meth:`gathered`); a leaf split
    over "model" only, or not at all, is read where it lies
    (:meth:`part`); a table is looked up where its blocks lie
    (:meth:`take_rows`). ``leaves[pos]`` is the block ``pos`` holds, a leaf
    that collects gradients, unless the view is a serving step's
    (:meth:`serving`; ``training`` False). Where the positions of a batch
    shard repeat one another's work (the same blocks read at each position
    of a "model" group, or of a group that spans more than "model"), only
    the first of
    them, the block's *collector* for that shard, reads it as a leaf that
    takes gradients; the others read it detached, so no gradient is taken
    twice."""

    def __init__(self, x: ShardedTensor, groups: Sequence[Sequence[int]],
                 transposed: bool = False, leaves=None,
                 move_rows: bool = False, training: bool = True,
                 pinned: bool = True):
        super().__init__(x, transposed, grad=leaves is None, leaves=leaves)
        self.groups = tuple(tuple(g) for g in groups)
        self.shard = {p: d for d, g in enumerate(self.groups) for p in g}
        self.move_rows, self.training = move_rows, training
        self.pinned = pinned

    @property
    def T(self) -> "TPView":
        return TPView(self.x, self.groups, not self.transposed, self.leaves,
                      self.move_rows, self.training, self.pinned)

    @classmethod
    def serving(cls, x: ShardedTensor, groups: Sequence[Sequence[int]],
                step: str, head: bool = False) -> "TPView":
        """A view that reads the shards as they are (no leaf takes
        gradients), for a serving ``step`` ("prefill" or "decode") with the
        batch split over ``groups``. As the reference's HLO splits them, a
        decode step moves the rows to every weight split over the batch
        axes on its output dimension only, and a prefill only to the
        ``head``'s, whose product takes the last rows (:meth:`gathers`);
        a decode step re-splits a weight split over the batch axes on its
        input dimension only (the router) over "model" where it lies
        (:meth:`resplits`); every other product gathers its weight. A
        decode step's lookup is not pinned to the batch's layout, as the
        reference's is not (:meth:`take_rows`)."""
        if step not in ("prefill", "decode"):
            raise ValueError(f"TPView.serving: unknown step {step!r}")
        return cls(x, groups, leaves=list(x.shards),
                   move_rows=step == "decode" or head, training=False,
                   pinned=step != "decode")

    def gathers(self) -> bool:
        """Whether a product with this (n_in, n_out) weight gathers the
        weight along the batch axes (:func:`tp_linear`) rather than moving
        the rows to its blocks (:func:`tp_rows_linear`) or re-splitting it
        over "model" (:meth:`resplits`): unless ``move_rows``, always; with
        it, where the input dimension is split over an axis other than
        "model" or no dimension is, but for a weight that
        :meth:`resplits`."""
        axes = self.x.layout.axes[::-1] if self.transposed \
            else self.x.layout.axes
        batch = [a for dim in axes for a in dim if a != "model"]
        return (not self.move_rows or not batch
                or any(a != "model" for a in axes[0])) \
            and not self.resplits()

    def resplits(self) -> bool:
        """Whether a product with this (n_in, n_out) weight re-splits it
        over "model" where it lies (:func:`tp_resplit_linear`): at a
        decode step (``move_rows``), a weight whose input dimension splits
        over the batch axes only and whose output dimension is whole — the
        router, P("data", None), as the reference's decode HLO permutes
        its blocks and sums the partials over "model"."""
        axes = self.x.layout.axes[::-1] if self.transposed \
            else self.x.layout.axes
        return (self.move_rows and len(axes) == 2 and not axes[1]
                and bool(axes[0]) and "model" not in axes[0])

    def splits_output(self) -> bool:
        """Whether a product with this (n_in, n_out) weight leaves each
        position its "model" block of the output columns: the weight
        gathered (:meth:`gathers`) and a column block (:meth:`kind`). Moved
        rows come back whole."""
        return self.gathers() and self.kind() == "column"

    @property
    def by_model(self) -> bool:
        """Whether the leaf's spec splits a dimension over "model"."""
        return any("model" in axes for axes in self.x.layout.axes)

    def kind(self) -> str:
        """As the (n_in, n_out) weight of a product: "column" when its
        output dimension splits over "model", "row" when its input
        dimension does, else "whole"."""
        axes = self.x.layout.axes[::-1] if self.transposed \
            else self.x.layout.axes
        if "model" in axes[1]:
            return "column"
        return "row" if "model" in axes[0] else "whole"

    def collects(self, pos: int) -> bool:
        """Whether ``pos`` is the first position of its batch shard's group
        (with its "model" coordinate, where the leaf splits over "model")
        and so takes the gradients of its reads."""
        mesh, by_model = self.x.mesh, self.by_model
        m = _model_of(mesh, pos)
        return pos == next(q for q in self.groups[self.shard[pos]]
                           if not by_model or _model_of(mesh, q) == m)

    def part(self, home: int) -> torch.Tensor:
        """The block ``home`` holds of a leaf split over "model" only or not
        at all (a norm weight, a bias, the experts), read where it lies;
        detached unless ``home`` collects its gradient."""
        if any(a != "model" for axes in self.x.layout.axes for a in axes):
            raise ValueError(f"{self.x!r} is split over another axis than "
                             f"'model': read it through gathered()")
        leaf = self.leaves[home]
        return leaf if self.collects(home) else leaf.detach()

    def gathered(self, dtype: torch.dtype) -> List[torch.Tensor]:
        """Per position, the blocks whose "model" part is the position's
        "model" coordinate, in ``dtype`` (each holder casts its block once:
        the cast is elementwise, so these are the cast leaf's bits), copied
        from the holders that share the position's coordinates on the axes
        the spec leaves out (``tp_zero_gather``) and joined in block order;
        transposed with the view. Only a collector's tensor is
        differentiable; the backward adds at each block's owner (its first
        holder) the block's slice of each batch shard's collector's
        gradient, in batch order and the leaf's dtype, the first as it is
        (``tp_zero_scatter``): a reduce-scatter along "data"."""
        outs = _ZeroGather.apply(self, dtype, *self.leaves)
        return [o.T if self.transposed else o for o in outs]

    def segments(self) -> List[List[Tuple[int, int]]]:
        """Per position, the entries of the view's output dimension its
        gathered tensor holds, as (first, count) runs in their order there
        (a vocab block of the head split over ("data", "model") is not one
        run)."""
        lay = self.x.layout
        dim = 0 if self.transposed else 1
        plan = self._plan()
        b = lay.block_shape[dim]
        out = []
        for reads in plan.reads:
            ks = sorted({block[dim] for block, _, _ in reads})
            runs: List[Tuple[int, int]] = []
            for k in ks:
                if runs and runs[-1][0] + runs[-1][1] == k * b:
                    runs[-1] = (runs[-1][0], runs[-1][1] + b)
                else:
                    runs.append((k * b, b))
            out.append(runs)
        return out

    def _plan(self) -> _GatherPlan:
        return _gather_plan(self.x.mesh, self.x.spec, tuple(self.x.shape),
                            self.groups)

    def take_rows(self, ids: Rows, dtype: torch.dtype = None) -> Rows:
        """``sparse.segment.take_rows`` of the (n, e) table in ``dtype``
        (default the table's) at each position's ids, formed as the
        reference's partitioner forms its lookup with the batch split
        (:func:`take_rows_two_axis`): the ids of the positions' "data"
        lines to every position (``emb_ids_permute``, ``emb_ids_gather``),
        each position's own block's rows of them, the partial rows across
        "model" (``emb_rows_model``), then each position's batch shard's
        rows of every column block along "data": pinned (the train step,
        a prefill) as the reference's all-to-all (``emb_rows_data``; the
        backward's ``emb_grad_data``), at a decode step, which the
        reference does not pin, as the port's own re-layout into the rows
        its next layer reads (``emb_rows_relayout``). Only the rows of a
        position that collects gradients (:meth:`collects`) take them."""
        lay, mesh = self.x.layout, ids.mesh
        if self.transposed or len(lay.counts) != 2:
            raise ValueError(f"take_rows of {self.x!r}: not an (n, e) table")
        if list(ids.homes) != list(range(mesh.size)):
            raise ValueError("TPView.take_rows: the ids are not Rows over "
                             "every position")
        shard = [self.shard[p] for p in range(mesh.size)]
        held = [{shard[p]: t} for p, t in enumerate(ids.parts)]
        names = ("emb_rows_data" if self.pinned else "emb_rows_relayout",
                 "emb_grad_data")
        grad_outs = [p for p in range(mesh.size)
                     if self.training and self.collects(p)]
        out = take_rows_two_axis(self.x, self.leaves, held, shard,
                                 range(mesh.size), dtype or self.x.dtype,
                                 names, grad_outs)
        return Rows(out, ids.homes, mesh)


class _ZeroGather(torch.autograd.Function):
    """:meth:`TPView.gathered` (in the leaf's own orientation); the inputs
    are every position's leaf."""

    @staticmethod
    def forward(ctx, view: TPView, dtype, *leaves):
        mesh, plan = view.x.mesh, view._plan()
        cast = {}
        outs = []
        for pos, (shape, reads) in enumerate(zip(plan.shape, plan.reads)):
            with mesh.at(pos):
                out = torch.empty(shape, dtype=dtype, device=mesh.device(pos))
            for _, holder, sl in reads:
                if holder not in cast:
                    with mesh.at(holder):
                        cast[holder] = leaves[holder].to(dtype)
                src = cast[holder]
                with span("tp_zero_gather"), mesh.at(pos), mesh.moving():
                    if holder != pos:
                        mesh.count("tp_zero_gather", _nbytes(src),
                                   frm=holder, to=pos)
                    out[sl].copy_(src)
            outs.append(out)
        del cast
        ctx.mark_non_differentiable(*(o for p, o in enumerate(outs)
                                      if not view.collects(p)))
        ctx.set_materialize_grads(False)
        ctx.view, ctx.plan = view, plan
        ctx.dtypes = [t.dtype for t in leaves]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        mesh, plan = ctx.view.x.mesh, ctx.plan
        slices = [{b: sl for b, _, sl in reads} for reads in plan.reads]
        out = [None] * mesh.size
        with span("tp_zero_scatter"):
            for block, owner in plan.owners.items():
                wdt, total = ctx.dtypes[owner], None
                for r in plan.collectors.get(block, ()):
                    if grads[r] is None:
                        continue
                    with mesh.at(owner), mesh.moving():
                        piece = grads[r][slices[r][block]].to(
                            device=mesh.device(owner), dtype=wdt)
                        if r != owner:
                            mesh.count("tp_zero_scatter", _nbytes(piece),
                                       frm=r, to=owner)
                    with mesh.at(owner):
                        total = piece if total is None else total + piece
                if total is not None:
                    out[owner] = total.contiguous()
        return (None, None, *out)


def _model_allreduce(mesh, homes: Sequence[int], parts, dtype: torch.dtype,
                     name: str = "tp_model_sum") -> list:
    """Per position of ``homes``, the sum of ``parts`` over its "model"
    group, added in ascending "model" coordinate in f32 and rounded once
    to ``dtype``: a reduce-scatter (member j adds chunk j of every member's
    flattened part, the first as it is, and rounds it) and an all-gather of
    the rounded chunks, both counted under ``name``. A group whose parts
    are ``None`` (it takes no gradient) gives ``None``."""
    at = {h: i for i, h in enumerate(homes)}
    out = list(parts)
    with span(name):
        for group in _axis_groups(mesh, "model"):
            idx = [at[p] for p in group]
            if parts[idx[0]] is None:
                continue
            shape = parts[idx[0]].shape
            if len(group) == 1:
                with mesh.at(group[0]):
                    out[idx[0]] = parts[idx[0]].to(dtype)
                continue
            M = len(group)
            flats = [parts[i].reshape(-1) for i in idx]
            n = flats[0].numel()
            if n % M:
                raise ValueError(f"{n} entries do not split into {M} chunks")
            c = n // M
            chunks = []
            for j, dst in enumerate(group):
                total = None
                for src, f in zip(group, flats):
                    with mesh.at(dst), mesh.moving():
                        piece = f.narrow(0, j * c, c)
                        if src != dst:
                            mesh.count(name, _nbytes(piece), frm=src, to=dst)
                        piece = piece.to(mesh.device(dst))
                    with mesh.at(dst):
                        piece = piece.float()
                        total = piece if total is None else total + piece
                with mesh.at(dst):
                    chunks.append(total.to(dtype))
                del total, piece
            del flats
            for dst, i in zip(group, idx):
                with mesh.at(dst), mesh.moving():
                    got = []
                    for src, ch in zip(group, chunks):
                        if src != dst:
                            mesh.count(name, _nbytes(ch), frm=src, to=dst)
                        got.append(ch.to(mesh.device(dst)))
                    out[i] = torch.cat(got).reshape(shape)
    return out


def tp_linear(x: Rows, w: TPView, dtype: torch.dtype,
              bias: TPView = None) -> Rows:
    """``x @ w.to(dtype) (+ bias.to(dtype))`` for every position's rows,
    the weight gathered along "data" (:meth:`TPView.gathered`). A column
    block ("column": the output split over "model") multiplies the whole
    rows into the position's column block, the bias's own entries added;
    a row block ("row") multiplies the position's slice of the rows into
    an f32 partial of the whole output, summed over "model" in ascending
    "model" coordinate and rounded once to ``dtype`` (``tp_model_sum``: the
    one-device product's f32 accumulation in another order); "whole"
    multiplies at each position. Backward (:class:`_TPMatmul`): a column
    block's f32 dX partials are summed over "model" the same way (the
    rows are the same at every position of the group), a row block's dX
    is the position's own product; dW is each position's product, rounded
    as autograd rounds it, for :class:`_ZeroGather`'s reduce-scatter. With
    one "model" position the products are autograd's, bit for bit."""
    ws = w.gathered(dtype)
    outs = _TPMatmul.apply(x.mesh, tuple(x.homes), w.kind(), dtype,
                           len(x.parts), *x.parts, *(ws[h] for h in x.homes))
    y = Rows(list(outs), x.homes, x.mesh)
    if bias is None:
        return y
    return each(lambda t, b: t + b.to(dtype), y, bias)


def tp_rows_linear(x: Rows, w: TPView, dtype: torch.dtype) -> Rows:
    """``x @ w.to(dtype)`` for every position's rows with the weight's
    blocks where they lie, the rows moved to them (serving only: no
    backward), as the reference's partitioner runs a decode step's row
    blocks (``wo``, ``wd``) and the head with the batch split: each
    position gathers, along the batch axes, every batch shard's rows of
    the input entries its block contracts (``tp_rows_gather``: the rows of
    the positions with its coordinates on the other axes, in batch order)
    and multiplies them by its block; where the input dimension splits
    over "model", the f32 partials are summed over "model" in ascending
    "model" coordinate and rounded once to ``dtype`` (``tp_model_sum``);
    each position then takes its own batch shard's rows of every column
    block from a position that made it (``tp_rows_scatter``: itself, else
    one on its batch line, else the first), joined in ascending column
    block. On one position it is ``x @ w.to(dtype)`` bit for bit."""
    mesh, homes = x.mesh, list(x.homes)
    at = {h: i for i, h in enumerate(homes)}
    lay = w.x.layout
    D_in, D_out = w.counts
    n_in, n_out = w.shape
    if sorted(homes) != list(range(mesh.size)):
        raise ValueError("tp_rows_linear: the rows must lie at every "
                         "position")
    if x.shape[-1] * D_in != n_in:
        raise ValueError(f"tp_rows_linear: rows of width {x.shape[-1]} for "
                         f"{D_in} input blocks of {n_in}")

    def block(pos):
        b = lay.block_of(pos)
        return tuple(b[::-1]) if w.transposed else tuple(b)

    # each position's batch line: the positions with its coordinates on the
    # axes the batch does not split, one per batch shard, in batch order
    index = {p: g.index(p) for g in w.groups for p in g}
    lines = {p: [g[index[p]] for g in w.groups] for p in homes}
    R = x.shape[0]
    ys = []
    for p in homes:
        got = []
        with span("tp_rows_gather"):
            for q in lines[p]:
                t = x.parts[at[q]]
                with mesh.at(p), mesh.moving():
                    if q != p:
                        mesh.count("tp_rows_gather", _nbytes(t), frm=q, to=p)
                    got.append(t.to(mesh.device(p)))
            with mesh.at(p):
                xa = got[0] if len(got) == 1 else torch.cat(got)
        with mesh.at(p):
            blk = w.block_at(p).to(dtype)
            if D_in > 1:     # f32 partials, summed over "model"
                y = _mm(xa.reshape(-1, xa.shape[-1]), blk, torch.float32)
                ys.append(y.reshape(*xa.shape[:-1], y.shape[-1]))
            else:
                ys.append(xa @ blk)
        del got, xa
    if D_in > 1:
        for group in _axis_groups(mesh, "model"):
            if len({block(p)[1] for p in group}) != 1:
                raise ValueError(f"tp_rows_linear: the positions {group} "
                                 f"hold different column blocks of {w.x!r}")
        ys = _model_allreduce(mesh, homes, ys, dtype)
    # after the sum every position holds its column block for all the rows
    made: Dict[int, List[int]] = {}
    for p in homes:
        made.setdefault(block(p)[1], []).append(p)
    out = []
    with span("tp_rows_scatter"):
        for p in homes:
            d = w.shard[p]
            pieces = []
            for j in range(D_out):
                srcs = made[j]
                q = (p if p in srcs else
                     next((r for r in lines[p] if r in srcs), srcs[0]))
                t = ys[at[q]][d * R:(d + 1) * R]
                with mesh.at(p), mesh.moving():
                    if q != p:
                        mesh.count("tp_rows_scatter", _nbytes(t), frm=q,
                                   to=p)
                    pieces.append(t.to(mesh.device(p)))
            with mesh.at(p):
                out.append(pieces[0] if len(pieces) == 1
                           else torch.cat(pieces, -1))
    return Rows(out, homes, mesh)


def tp_resplit_linear(x: Rows, w: TPView, dtype: torch.dtype) -> Rows:
    """``x @ w.to(dtype)`` for every position's rows with a weight split
    over the batch axes on its input dimension only (a decode step's
    router, P("data", None); serving only: no backward), as the
    reference's decode HLO runs it: the weight is re-split over "model" —
    position p takes the input entries of its "model" block (n_in / M of
    them) from the blocks that hold them, its own where it holds them,
    else from the holder whose "model" coordinate is p's batch shard index
    modulo M (``tp_resplit``: on a 2 × 2 mesh the reference's
    collective-permute between the two off-diagonal positions) — and
    multiplies its rows' entries of that block into an f32 partial of the
    whole output, summed over "model" in ascending "model" coordinate and
    rounded once to ``dtype`` (``tp_model_sum``). With one "model"
    position the weight comes whole and the product is ``x @ w`` as
    :func:`tp_linear` takes it."""
    mesh, homes = x.mesh, list(x.homes)
    lay = w.x.layout
    n_in = w.shape[0]
    D_in = w.counts[0]
    M = _model_size(mesh)
    if w.transposed or n_in % M or n_in % D_in:
        raise ValueError(f"tp_resplit_linear: {w.x!r} does not re-split "
                         f"over {M} 'model' positions")
    b_in, b_out = n_in // D_in, n_in // M
    ys = []
    with span("tp_resplit"):
        for p in homes:
            lo = _model_of(mesh, p) * b_out
            pieces = []
            for j in range(lo // b_in, (lo + b_out - 1) // b_in + 1):
                holders = lay.holders((j, 0))
                q = (p if p in holders else next(
                    (h for h in holders
                     if _model_of(mesh, h) == w.shard[p] % M), holders[0]))
                a, b = max(lo, j * b_in), min(lo + b_out, (j + 1) * b_in)
                t = w.leaves[q][a - j * b_in:b - j * b_in]
                with mesh.at(p), mesh.moving():
                    if q != p:
                        mesh.count("tp_resplit", _nbytes(t), frm=q, to=p)
                    pieces.append(t.to(mesh.device(p)))
            with mesh.at(p):
                blk = (pieces[0] if len(pieces) == 1
                       else torch.cat(pieces)).to(dtype)
                xp = x.parts[homes.index(p)]
                if M == 1:
                    ys.append(xp @ blk)
                else:
                    xf = xp.reshape(-1, n_in)[:, lo:lo + b_out]
                    y = _mm(xf, blk, torch.float32)
                    ys.append(y.reshape(*xp.shape[:-1], y.shape[-1]))
            del pieces
    if M > 1:
        ys = _model_allreduce(mesh, homes, ys, dtype)
    return Rows(ys, homes, mesh)


def _span_line(w: TPView, pos: int, shards: int) -> List[int]:
    """The positions ``pos`` reads from when a group spans ``shards`` batch
    shards: in each of its group's batch shards, in batch order, the
    position with ``pos``'s place in that shard's positions."""
    d = w.shard[pos]
    i = w.groups[d].index(pos)
    first = d - d % shards
    return [w.groups[e][i] for e in range(first, first + shards)]


def _lines(x: Rows, w, shards: int) -> Tuple[Tuple[int, ...], ...]:
    """Per position of ``x``, its line: :func:`_span_line` over ``shards``
    of ``w``'s batch shards, or, with ``w`` None, every home of ``x`` (one
    batch shard each). A line is the same at each of its positions."""
    if w is None:
        return (tuple(x.homes),) * len(x.homes)
    return tuple(tuple(_span_line(w, p, shards)) for p in x.homes)


def _line_copies(mesh, p: int, line, parts, at, name: str):
    """The tensors of ``line``'s positions, each copied to ``p`` from where
    it lies (``name``), in line order."""
    got = []
    with mesh.at(p), mesh.moving():
        for q in line:
            t = parts[at[q]]
            if q != p:
                mesh.count(name, _nbytes(t), frm=q, to=p)
            got.append(t.to(mesh.device(p)))
    return got


def span_gather(x: Rows, w: TPView, shards: int, name: str) -> Rows:
    """Per position, its line's tensors (:func:`_span_line`: one per
    batch shard of its ``shards``-shard group) joined along dim 0 in batch
    order, each copied from where it lies (``name``). Differentiable: each
    position's gradient is the sum, over its line's positions in batch
    order, of the slice of their gradient that its tensor became, each
    copied to it (``name`` + ``"_grad"``) and added from the first as it
    is (no zeros, so a −0.0 stays)."""
    return Rows(list(_SpanGather.apply(x.mesh, tuple(x.homes),
                                       _lines(x, w, shards), name,
                                       *x.parts)), x.homes, x.mesh)


class _SpanGather(torch.autograd.Function):
    """:func:`span_gather`; the inputs are every position's tensor."""

    @staticmethod
    def forward(ctx, mesh, homes, lines, name, *parts):
        at = {h: i for i, h in enumerate(homes)}
        out = []
        with span(name):
            for p, line in zip(homes, lines):
                got = _line_copies(mesh, p, line, parts, at, name)
                with mesh.at(p):
                    out.append(torch.cat(got))
        ctx.mesh, ctx.homes, ctx.lines, ctx.name = mesh, homes, lines, name
        ctx.rows = [t.shape[0] for t in parts]
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, homes, lines = ctx.mesh, ctx.homes, ctx.lines
        name = ctx.name + "_grad"
        at = {h: i for i, h in enumerate(homes)}
        out = [None] * len(homes)
        with span(name):
            for q, line in zip(homes, lines):
                n, total = ctx.rows[at[q]], None
                for p in line:        # q's line: the positions that read q
                    g = grads[at[p]]
                    if g is None:
                        continue
                    j = lines[at[p]].index(q)
                    piece = g[j * n:(j + 1) * n]
                    with mesh.at(q), mesh.moving():
                        if p != q:
                            mesh.count(name, _nbytes(piece), frm=p, to=q)
                        piece = piece.to(mesh.device(q))
                    with mesh.at(q):
                        total = piece if total is None else total + piece
                out[at[q]] = total
        return (None,) * 4 + tuple(out)


def span_select(x: Rows, owner: Rows, w: TPView, shards: int,
                name: str) -> Rows:
    """Per position, row i of the tensor its line's position number
    ``owner[i]`` holds (:func:`_span_line`; each row has one owner, so
    this is a select, not a sum of zero partials: −0.0 stays), every row
    a position reads from another copied (``name``). Differentiable for
    work in which only a row's owner reads the output it feeds (the MoE
    dispatch across shards: each position combines its own tokens, so the
    other positions' gradients of the row are zeros): each row's gradient
    is its owner's own, a select too, and nothing moves."""
    n = len(x.parts)
    return Rows(list(_SpanSelect.apply(x.mesh, tuple(x.homes),
                                       _lines(x, w, shards), name, n,
                                       *x.parts, *owner.parts)),
                x.homes, x.mesh)


class _SpanSelect(torch.autograd.Function):
    """:func:`span_select`; the inputs are every position's tensor, then
    its rows' owners."""

    @staticmethod
    def forward(ctx, mesh, homes, lines, name, n, *tensors):
        parts, owners = tensors[:n], tensors[n:]
        at = {h: i for i, h in enumerate(homes)}
        out = []
        with span(name):
            for p, line in zip(homes, lines):
                got = _line_copies(mesh, p, line, parts, at, name)
                with mesh.at(p):
                    rows = torch.arange(got[0].shape[0],
                                        device=mesh.device(p))
                    out.append(torch.stack(got)[owners[at[p]], rows])
        ctx.mesh, ctx.homes, ctx.n = mesh, homes, n
        ctx.mine = [line.index(p) for p, line in zip(homes, lines)]
        ctx.save_for_backward(*owners)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, owners = ctx.mesh, ctx.saved_tensors
        out = []
        for p, g, own, mine in zip(ctx.homes, grads, owners, ctx.mine):
            if g is None:
                out.append(None)
                continue
            with mesh.at(p):
                keep = (own == mine).view(-1, *(1,) * (g.dim() - 1))
                out.append(torch.where(keep, g, torch.zeros(
                    (), dtype=g.dtype, device=g.device)))
        return (None,) * 5 + tuple(out) + (None,) * ctx.n


def batch_sum(x: Rows, w, name: str) -> Rows:
    """Per position, the sum of its line's tensors (:func:`_lines` over
    all of ``w``'s batch shards, or over every home of ``x`` with ``w``
    None: one per shard, each copied from where it lies, ``name``), added
    in batch order from the first as it is, so the positions of a line
    hold the same bits: an all-reduce along the batch axes of per-shard
    partials of one batch (the loss's sums and counts, the MoE aux loss's
    terms). Differentiable; the backward is the identity, each position's
    gradient its own partial's, as the gradient of a sum every position
    holds whole. With one batch shard ``x`` itself."""
    if len(x.homes if w is None else w.groups) == 1:
        return x
    lines = _lines(x, w, len(w.groups) if w is not None else 1)
    return Rows(list(_BatchSum.apply(x.mesh, tuple(x.homes), lines, name,
                                     *x.parts)), x.homes, x.mesh)


def batch_mean(total: Rows, count: Rows, w) -> Rows:
    """Per position, the mean of one batch that its batch shards split
    (``w``'s, or every home of ``total`` with ``w`` None): each shard's sum
    and its count of terms added over them in batch order (:func:`batch_sum`,
    ``loss_sum``: an f32 and an int32 scalar from each other shard) and
    divided once, so every position holds the batch's mean."""
    tot = batch_sum(total, w, "loss_sum")
    cnt = batch_sum(count, w, "loss_sum")
    return each(lambda t, c: t / torch.clamp_min(c, 1), tot, cnt)


class _BatchSum(torch.autograd.Function):
    """:func:`batch_sum`; the inputs are every position's partial."""

    @staticmethod
    def forward(ctx, mesh, homes, lines, name, *parts):
        at = {h: i for i, h in enumerate(homes)}
        out = []
        with span(name):
            for p, line in zip(homes, lines):
                got = _line_copies(mesh, p, line, parts, at, name)
                with mesh.at(p):
                    total = got[0]
                    for t in got[1:]:
                        total = total + t
                out.append(total)
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * 4 + grads


class _TPMatmul(torch.autograd.Function):
    """:func:`tp_linear`'s products; the inputs are every position's rows,
    then its gathered weight."""

    @staticmethod
    def forward(ctx, mesh, homes, kind, dtype, n, *tensors):
        xs, ws = tensors[:n], tensors[n:]
        M = _model_size(mesh)
        row = kind == "row" and M > 1
        pd = torch.float32 if row else dtype
        flats, ys = [], []
        for x, w, h in zip(xs, ws, homes):
            with mesh.at(h):
                xf = x.reshape(-1, x.shape[-1])
                # x as it is where it can: a strided view of the rows (the
                # last position's) multiplies as the one-device product does
                ys.append(x @ w if pd == x.dtype else _mm(xf, w, pd))
            flats.append(xf)
        if row:
            ys = _model_allreduce(mesh, homes, ys, dtype)
        out = []
        for x, y, h in zip(xs, ys, homes):
            with mesh.at(h):
                out.append(y.reshape(*x.shape[:-1], y.shape[-1]))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*flats, *ws)
        ctx.mesh, ctx.homes, ctx.n = mesh, homes, n
        ctx.sum_dx = kind == "column" and M > 1
        ctx.x_meta = [(x.shape, x.dtype) for x in xs]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, homes, n = ctx.mesh, ctx.homes, ctx.n
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[5:]
        # a column block's dX partial counts toward every position's sum,
        # whether or not its own rows take a gradient
        any_x = ctx.sum_dx and any(need[:n])
        gxs, gws = [None] * n, [None] * n
        for i, (h, g) in enumerate(zip(homes, grads)):
            if g is None:
                continue
            xf, w = saved[i], saved[n + i]
            with mesh.at(h):
                g = g.reshape(-1, g.shape[-1])
                if need[n + i]:
                    gws[i] = _weight_grad(xf, w, g)
                if need[i] or any_x:
                    gxs[i] = _input_grad(g, w, xf, torch.float32
                                         if ctx.sum_dx else xf.dtype)
        if ctx.sum_dx:
            gxs = _model_allreduce(mesh, homes, gxs, ctx.x_meta[0][1])
        for i, (h, (shape, _)) in enumerate(zip(homes, ctx.x_meta)):
            if gxs[i] is not None:
                with mesh.at(h):
                    gxs[i] = gxs[i].reshape(shape)
        return (None,) * 5 + tuple(gxs) + tuple(gws)


class _ModelSum(torch.autograd.Function):
    """Each position's partials summed over its "model" group
    (:func:`_model_allreduce`); backward: the identity (every position's
    gradient of the replicated sum is the whole one)."""

    @staticmethod
    def forward(ctx, mesh, homes, dtype, *parts):
        ctx.dtypes = [p.dtype for p in parts]
        ctx.set_materialize_grads(False)
        return tuple(_model_allreduce(mesh, homes, parts, dtype))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *(None if g is None else g.to(dt)
                                    for g, dt in zip(grads, ctx.dtypes)))


class _ModelSumGrad(torch.autograd.Function):
    """The identity on a tensor replicated over each "model" group, whose
    positions multiply it by their own blocks; backward: the positions'
    gradients summed over the group (:func:`_model_allreduce`)."""

    @staticmethod
    def forward(ctx, mesh, homes, *parts):
        ctx.mesh, ctx.homes = mesh, homes
        ctx.dtypes = [p.dtype for p in parts]
        ctx.set_materialize_grads(False)
        return tuple(p.view_as(p) for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_model_allreduce(ctx.mesh, ctx.homes, grads,
                                              ctx.dtypes[0]))


def model_sum(x: Rows, dtype: torch.dtype) -> Rows:
    """Each position's partials (the experts' d_ff blocks' outputs) summed
    over its "model" group in f32, rounded once to ``dtype``
    (``tp_model_sum``); differentiable (the identity backward)."""
    return Rows(list(_ModelSum.apply(x.mesh, tuple(x.homes), dtype,
                                     *x.parts)), x.homes, x.mesh)


def model_sum_grad(x: Rows) -> Rows:
    """``x`` as it is; its gradient the positions' gradients summed over
    each "model" group in f32 and rounded once (``tp_model_sum``)."""
    if _model_size(x.mesh) == 1:
        return x
    return Rows(list(_ModelSumGrad.apply(x.mesh, tuple(x.homes), *x.parts)),
                x.homes, x.mesh)


class _ModelGather(torch.autograd.Function):
    """Per position, its "model" group's tensors joined along ``dim`` in
    ascending "model" coordinate (``name``), for work that every position
    of the group then repeats; backward: each position's own slice of its
    gradient (the whole gradient at every position of replicated
    work)."""

    @staticmethod
    def forward(ctx, mesh, homes, dim, name, *parts):
        at = {h: i for i, h in enumerate(homes)}
        out = [None] * len(parts)
        with span(name):
            for group in _axis_groups(mesh, "model"):
                for dst in group:
                    with mesh.at(dst), mesh.moving():
                        got = []
                        for src in group:
                            t = parts[at[src]]
                            if src != dst:
                                mesh.count(name, _nbytes(t), frm=src, to=dst)
                            got.append(t.to(mesh.device(dst)))
                        out[at[dst]] = torch.cat(got, dim)
        ctx.mesh, ctx.homes, ctx.dim = mesh, homes, dim
        ctx.width = parts[0].shape[dim]
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, w = ctx.mesh, ctx.width
        out = []
        for h, g in zip(ctx.homes, grads):
            if g is None:
                out.append(None)
                continue
            with mesh.at(h):
                out.append(g.narrow(ctx.dim, _model_of(mesh, h) * w,
                                    w).contiguous())
        return (None, None, None, None, *out)


class _ModelSlice(torch.autograd.Function):
    """Per position, its own slice along ``dim`` of a tensor that is the
    same at every position of its "model" group; backward: the slices'
    gradients gathered along "model" (``name``): the whole gradient of the
    replicated tensor at every position."""

    @staticmethod
    def forward(ctx, mesh, homes, dim, name, *parts):
        M = _model_size(mesh)
        ctx.mesh, ctx.homes, ctx.dim, ctx.name = mesh, homes, dim, name
        ctx.set_materialize_grads(False)
        out = []
        for h, t in zip(homes, parts):
            w = t.shape[dim] // M
            with mesh.at(h):
                out.append(t.narrow(dim, _model_of(mesh, h) * w,
                                    w).contiguous())
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, homes = ctx.mesh, ctx.homes
        at = {h: i for i, h in enumerate(homes)}
        out = [None] * len(grads)
        with span(ctx.name):
            for group in _axis_groups(mesh, "model"):
                if grads[at[group[0]]] is None:
                    continue
                for dst in group:
                    with mesh.at(dst), mesh.moving():
                        got = []
                        for src in group:
                            g = grads[at[src]]
                            if src != dst:
                                mesh.count(ctx.name, _nbytes(g), frm=src,
                                           to=dst)
                            got.append(g.to(mesh.device(dst)))
                        out[at[dst]] = torch.cat(got, ctx.dim)
        return (None, None, None, None, *out)


class _ModelTake(torch.autograd.Function):
    """Per position p, entries ``ranges[p]`` = [lo, hi) of the last
    dimension of its "model" group's tensors joined in ascending "model"
    coordinate, copied from the members that hold them (``name``);
    backward: each member's entries take the sum, over the positions that
    took them in ascending "model" coordinate, of their gradients, in f32
    and rounded once, the first as it is (an entry no position took gets
    0)."""

    @staticmethod
    def forward(ctx, mesh, homes, ranges, name, *parts):
        at = {h: i for i, h in enumerate(homes)}
        w = parts[0].shape[-1]
        out = [None] * len(parts)
        with span(name):
            for group in _axis_groups(mesh, "model"):
                for dst in group:
                    lo, hi = ranges[at[dst]]
                    with mesh.at(dst), mesh.moving():
                        got = []
                        for j, src in enumerate(group):
                            a, b = max(lo, j * w), min(hi, (j + 1) * w)
                            if a >= b:
                                continue
                            t = parts[at[src]][..., a - j * w:b - j * w]
                            if src != dst:
                                mesh.count(name, _nbytes(t), frm=src, to=dst)
                            got.append(t.to(mesh.device(dst)))
                        out[at[dst]] = torch.cat(got, -1)
        ctx.mesh, ctx.homes, ctx.ranges, ctx.name = mesh, homes, ranges, name
        ctx.width, ctx.dtypes = w, [p.dtype for p in parts]
        ctx.set_materialize_grads(False)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, homes, ranges, w = ctx.mesh, ctx.homes, ctx.ranges, ctx.width
        at = {h: i for i, h in enumerate(homes)}
        out = [None] * len(grads)
        with span(ctx.name):
            for group in _axis_groups(mesh, "model"):
                if grads[at[group[0]]] is None:
                    continue
                for j, dst in enumerate(group):
                    lo_j, hi_j = j * w, (j + 1) * w
                    cuts = sorted({lo_j, hi_j} | {
                        e for src in group for e in ranges[at[src]]
                        if lo_j < e < hi_j})
                    cols = []
                    for a, b in zip(cuts[:-1], cuts[1:]):
                        total = None
                        for src in group:
                            lo, hi = ranges[at[src]]
                            if not (lo <= a and b <= hi):
                                continue
                            with mesh.at(dst), mesh.moving():
                                g = grads[at[src]][..., a - lo:b - lo]
                                if src != dst:
                                    mesh.count(ctx.name, _nbytes(g),
                                               frm=src, to=dst)
                                g = g.to(mesh.device(dst))
                            with mesh.at(dst):
                                g = g.float()
                                total = g if total is None else total + g
                        with mesh.at(dst):
                            if total is None:
                                shape = grads[at[dst]].shape[:-1] + (b - a,)
                                total = torch.zeros(shape,
                                                    device=mesh.device(dst))
                            cols.append(total.to(ctx.dtypes[at[dst]]))
                    with mesh.at(dst):
                        out[at[dst]] = torch.cat(cols, -1)
        return (None, None, None, None, *out)


def model_gather(x: Rows, dim: int, name: str) -> Rows:
    """:class:`_ModelGather` over every position's tensor; ``x`` itself on
    a mesh with one "model" position."""
    if _model_size(x.mesh) == 1:
        return x
    return Rows(list(_ModelGather.apply(x.mesh, tuple(x.homes), dim, name,
                                        *x.parts)), x.homes, x.mesh)


def model_slice(x: Rows, dim: int, name: str) -> Rows:
    """:class:`_ModelSlice` over every position's tensor; ``x`` itself on
    a mesh with one "model" position."""
    if _model_size(x.mesh) == 1:
        return x
    return Rows(list(_ModelSlice.apply(x.mesh, tuple(x.homes), dim, name,
                                       *x.parts)), x.homes, x.mesh)


def model_take(x: Rows, ranges: Sequence[Tuple[int, int]],
               name: str) -> Rows:
    """:class:`_ModelTake`: each position's ``ranges[i]`` of the last
    dimension of its "model" group's tensors joined."""
    return Rows(list(_ModelTake.apply(x.mesh, tuple(x.homes), tuple(ranges),
                                      name, *x.parts)), x.homes, x.mesh)


def split_heads(q: Rows, k: Rows, v: Rows, n_heads: int, n_kv: int,
                hd: int, whole: bool = False):
    """The attention heads over "model", from the column blocks of q, k
    and v (B, S, width) each position's column products made, RoPE not
    yet applied. With H and KV both divisible by the "model" size M each
    position keeps its H / M query heads and KV / M key-value heads (GQA's
    h → h // G stays within the block). With only H divisible, q stays
    split and each position takes, from k and v gathered along "model",
    the key-value head its query heads use (``tp_heads_gather``; their
    gradients summed back over the positions that took them). Otherwise,
    or with ``whole`` (a decode step: every position attends over all
    heads, each over its slice of the cache), q, k and v are gathered along
    "model" and every position attends over all heads; ``own`` then takes
    each position's column block of the attention output for its row block
    of the output projection (the gradients gathered back along "model").
    Returns (q, k, v, own)."""
    M = _model_size(q.mesh)
    if M == 1 or q.shape[-1] == n_heads * hd:
        return q, k, v, None
    branch = kv_heads(q.mesh, 0, n_heads, n_kv, whole)[2]
    if branch == "split":
        return q, k, v, None
    if branch == "take":
        ranges = []
        for h in q.homes:
            lo, hi, _ = kv_heads(q.mesh, h, n_heads, n_kv)
            ranges.append((lo * hd, hi * hd))
        return (q, model_take(k, ranges, "tp_heads_gather"),
                model_take(v, ranges, "tp_heads_gather"), None)
    q, k, v = (model_gather(t, -1, "tp_heads_gather") for t in (q, k, v))
    return q, k, v, lambda o: model_slice(o, -1, "tp_heads_gather")


def kv_heads(mesh, pos: int, n_heads: int, n_kv: int, whole: bool = False
             ) -> Tuple[int, int, str]:
    """The key-value heads [lo, hi) that position ``pos`` attends with
    after :func:`split_heads` (whose column blocks split the heads over
    "model"), and the branch it takes: "split" (H and KV both divide over
    the M "model" positions), "take" (only H does, and each position's
    query heads share one key-value head) or "gather" (all heads)."""
    M = _model_size(mesh)
    m = _model_of(mesh, pos)
    G = n_heads // n_kv
    per = n_heads // M
    if whole or M == 1:
        return 0, n_kv, "gather"
    if n_heads % M == 0 and n_kv % M == 0:
        w = n_kv // M
        return m * w, (m + 1) * w, "split"
    if n_heads % M == 0 and G % per == 0:
        j = m * per // G
        return j, j + 1, "take"
    return 0, n_kv, "gather"


def tp_vocab_xent(hidden: Rows, head: TPView, labels: Rows) -> Rows:
    """Each position's mean cross entropy of the logits ``hidden @ head``
    over the labels ≥ 0 of the batch its batch shards split
    (``models.layers.softmax_xent_sharded``), the (d, V) head gathered
    along "data" (:meth:`TPView.gathered`): each position takes the
    statistics of its own vocab columns, and only the per-row statistics
    cross "model" (``xent_stats``, :class:`_TPXent`). Each position's sum
    over its rows and its count of labels are added over its line of the
    batch shards in batch order (:func:`batch_sum`, ``loss_sum``: a 4-byte
    f32 and a 4-byte int32 scalar from each other shard) and divided once,
    so every position holds the batch's mean; with one batch shard that is
    the one-device loss, bit for bit."""
    ws = head.gathered(hidden.dtype)
    segs = head.segments()
    n = len(hidden.parts)
    out = _TPXent.apply(hidden.mesh, tuple(hidden.homes),
                        tuple(tuple(segs[h]) for h in hidden.homes),
                        head.kind() == "column", n,
                        *hidden.parts, *labels.parts,
                        *(ws[h] for h in hidden.homes))
    return batch_mean(Rows(list(out[:n]), hidden.homes, hidden.mesh),
                      Rows(list(out[n:]), hidden.homes, hidden.mesh), head)


def _onehots(labels: torch.Tensor, runs) -> torch.Tensor:
    """The one-hot rows of ``labels`` over the vocab entries of ``runs``
    ((first, count) each, joined in order)."""
    hots = [_onehot(labels, lo, n) for lo, n in runs]
    return hots[0] if len(hots) == 1 else torch.cat(hots, -1)


class _TPXent(torch.autograd.Function):
    """:func:`tp_vocab_xent`; the inputs are every position's hidden rows,
    labels and gathered head.

    Forward at each position: its logits block in the compute dtype
    (widened, as the one-device loss widens its logits), the block's per-row
    max m_j, s_j = Σ exp(logit − m_j) and target logit t_j by the one-hot
    contraction over its vocab entries; (m, s, t) gathered over "model"
    (``xent_stats``) and folded in ascending "model" coordinate: m = max
    m_j, lse = m + log Σ_j s_j · exp(m_j − m), t = Σ_j t_j, the loss Σ_valid
    (lse − t) / max(count, 1). With one block the fold is
    ``torch.logsumexp``'s own (log s + m). A head whose vocab is not split
    over "model" (``split`` false) is whole at every position: each folds
    its own statistics only.

    Backward at each position: the sum's gradient (1 / count of the
    batch's mean) on each valid row, softmax − one-hot for its block as
    autograd takes it on one device, cast to the compute dtype; the hidden's partial
    (f32 with more than one "model" position) summed over "model"
    (``tp_model_sum``) and rounded once, where the vocab is split; the head
    block's gradient the position's own product, for :class:`_ZeroGather`'s
    reduce-scatter."""

    @staticmethod
    def forward(ctx, mesh, homes, segs, split, n, *tensors):
        hs, labels, ws = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        cd = hs[0].dtype
        stats, saved = [], []
        for h, hd, lab, w, runs in zip(homes, hs, labels, ws, segs):
            with mesh.at(h):
                xin = hd.reshape(-1, hd.shape[-1])
                # the logits rounded as one product rounds them, kept in the
                # compute dtype (widened again in the backward)
                p = _mm(xin, w, cd)
                logits = p.float().reshape(*lab.shape, w.shape[1])
                m = logits.amax(dim=-1)
                s = torch.exp(logits - m[..., None]).sum(dim=-1)
                t = torch.einsum("bsv,bsv->bs", logits,
                                 _onehots(lab, runs).float())
            stats.append((m, s, t))
            saved += [xin, w, p, lab]
            del logits, p
        at = {h: i for i, h in enumerate(homes)}
        out, counts, home_saved = [None] * n, [None] * n, [None] * n
        groups = (_axis_groups(mesh, "model") if split
                  else [[h] for h in homes])
        with span("xent_stats"):
            for group in groups:
                for dst in group:
                    with mesh.at(dst), mesh.moving():
                        got = []
                        for src in group:
                            if src != dst:
                                mesh.count("xent_stats", sum(
                                    _nbytes(t) for t in stats[at[src]]),
                                    frm=src, to=dst)
                            got.append([t.to(mesh.device(dst))
                                        for t in stats[at[src]]])
                    i = at[dst]
                    with mesh.at(dst):
                        m = got[0][0]
                        for mj, _, _ in got[1:]:
                            m = torch.maximum(m, mj)
                        tot = t = None
                        for mj, sj, tj in got:
                            a = sj * torch.exp(mj - m)
                            tot = a if tot is None else tot + a
                            t = tj if t is None else t + tj
                        lse = m + torch.log(tot)
                        valid = labels[i] >= 0
                        out[i] = torch.where(valid, lse - t, 0.0).sum()
                        counts[i] = valid.sum().to(torch.int32)
                    home_saved[i] = (lse, valid)
        ctx.save_for_backward(*saved, *(t for hs_ in home_saved
                                         for t in hs_))
        ctx.mesh, ctx.homes, ctx.segs, ctx.n, ctx.cd = mesh, homes, segs, n, cd
        ctx.split = split and _model_size(mesh) > 1
        ctx.h_meta = [(hd.shape, hd.dtype) for hd in hs]
        ctx.mark_non_differentiable(*counts)
        ctx.set_materialize_grads(False)
        return tuple(out) + tuple(counts)

    @staticmethod
    def backward(ctx, *grads):
        mesh, homes, n, cd = ctx.mesh, ctx.homes, ctx.n, ctx.cd
        tensors = ctx.saved_tensors
        gpd = torch.float32 if ctx.split else cd
        ghs, gws = [None] * n, [None] * n
        for i, (h, runs) in enumerate(zip(homes, ctx.segs)):
            if grads[i] is None:
                continue
            xin, w, p, lab = tensors[4 * i:4 * i + 4]
            lse, valid = tensors[4 * n + 2 * i:4 * n + 2 * i + 2]
            with mesh.at(h):
                # the one-device backward of Σ where(valid, lse − t, 0)
                g = torch.where(valid, grads[i], 0.0)
                logits = p.float().reshape(*lab.shape, w.shape[1])
                # logsumexp's backward, then the one-hot contraction's
                dl = g[..., None] * torch.exp(logits - lse[..., None])
                del logits
                dl = dl - _onehots(lab, runs).float() * g[..., None]
                dl = dl.to(cd).reshape(-1, w.shape[1])
                ghs[i] = _input_grad(dl, w, xin, gpd)
                gws[i] = _weight_grad(xin, w, dl)
        if ctx.split:
            ghs = _model_allreduce(mesh, homes, ghs, ctx.h_meta[0][1])
        for i, (h, (shape, _)) in enumerate(zip(homes, ctx.h_meta)):
            if ghs[i] is not None:
                with mesh.at(h):
                    ghs[i] = ghs[i].reshape(shape)
        return (None,) * 5 + tuple(ghs) + (None,) * n + tuple(gws)


# -- a graph's edge blocks (the GNNs' edge sharding) ---------------------------
#
# ``homes`` lists each edge block's home position in block order, position 0
# first (``batch_groups``); block b of an (E, …) edge table is rows
# b·E/B … (b+1)·E/B − 1. With one block every function hands its input back.

def _gather_blocks(mesh, homes, blocks, name: str) -> List[torch.Tensor]:
    """The whole table at each home: its blocks copied there and joined in
    block order."""
    out = []
    for dst in homes:
        dev = mesh.device(dst)
        with span(name), mesh.at(dst), mesh.moving():
            parts = []
            for src, b in zip(homes, blocks):
                if src != dst:
                    mesh.count(name, _nbytes(b), to=dst)
                parts.append(b.to(dev))
            out.append(torch.cat(parts, dim=0))
    return out


def _reduce_scatter(mesh, homes, wholes, name: str) -> List[torch.Tensor]:
    """Block b of the sum of ``wholes`` (one whole table per home) at
    block b's home: the tables' slices added in block order there."""
    n = wholes[0].shape[0] // len(homes)
    out = []
    for b, dst in enumerate(homes):
        dev = mesh.device(dst)
        total = None
        for src, w in zip(homes, wholes):
            part = w[b * n:(b + 1) * n]
            if src != dst:
                mesh.count(name, _nbytes(part), to=dst)
            with span(name), mesh.at(dst), mesh.moving():
                part = part.to(dev)
            with mesh.at(dst):
                total = part if total is None else total + part
        out.append(total)
    return out


class _EdgePsum(torch.autograd.Function):
    """The per-block partials added in block order at position 0; the
    backward hands the gradient to every home."""

    @staticmethod
    def forward(ctx, mesh, homes, *partials):
        ctx.mesh, ctx.homes = mesh, homes
        ctx.devices = [p.device for p in partials]
        dev0 = mesh.device(0)
        total = partials[0]
        for p in partials[1:]:
            with span("edge_psum"), mesh.at(0), mesh.moving():
                mesh.count("edge_psum", _nbytes(p), to=0)
                p = p.to(dev0)
            with mesh.at(0):
                total = total + p
        return total

    @staticmethod
    def backward(ctx, grad):
        mesh, out = ctx.mesh, []
        for h, dev in zip(ctx.homes, ctx.devices):
            if h == 0:
                out.append(grad)
                continue
            mesh.count("edge_psum", _nbytes(grad), to=h)
            with span("edge_psum"), mesh.at(h), mesh.moving():
                out.append(torch.empty(grad.shape, dtype=grad.dtype,
                                       device=dev).copy_(grad))
        return (None, None, *out)


class _EdgeGather(torch.autograd.Function):
    """An edge table's blocks → the whole table at each home; the backward
    adds the homes' gradients of each block in home order at its home."""

    @staticmethod
    def forward(ctx, mesh, homes, *blocks):
        ctx.mesh, ctx.homes = mesh, homes
        return tuple(_gather_blocks(mesh, homes, blocks, "edge_gather"))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_reduce_scatter(ctx.mesh, ctx.homes, grads,
                                             "edge_gather"))


class _EdgeScatter(torch.autograd.Function):
    """Per-home partial sums into the whole edge table → each block's slice
    of their sum, added in block order at its home; the backward hands each
    home the whole gradient."""

    @staticmethod
    def forward(ctx, mesh, homes, *partials):
        ctx.mesh, ctx.homes = mesh, homes
        return tuple(_reduce_scatter(mesh, homes, partials, "edge_scatter"))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_gather_blocks(ctx.mesh, ctx.homes, grads,
                                            "edge_scatter"))


def edge_psum(mesh, homes: Sequence[int],
              partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """One (n, …) partial sum per edge block, each at its home → their sum
    at position 0, added in block order as :func:`_psum` adds (counted
    under ``edge_psum``); differentiable. The reference's psum hands the
    sum to every device, which then runs the node-level work; here that
    work runs at position 0 and the node tables it makes go to the homes
    by :func:`send` (``node_send``): the same bytes a layer."""
    if len(partials) == 1:
        return partials[0]
    return _EdgePsum.apply(mesh, tuple(homes), *partials)


def edge_gather(mesh, homes: Sequence[int],
                blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """An edge table's blocks, each at its home → the whole table at every
    home, joined in block order (``edge_gather``); differentiable: each
    block's gradient is the sum, in home order, of its slices."""
    if len(blocks) == 1:
        return list(blocks)
    return list(_EdgeGather.apply(mesh, tuple(homes), *blocks))


def edge_scatter(mesh, homes: Sequence[int],
                 partials: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A scatter into the whole (E, …) edge table, one partial per home →
    each block's slice of their sum at its home (``edge_scatter``). Each
    slice adds the partials in block order, as folding them at position 0
    and handing each block its slice would, with one hop fewer;
    differentiable."""
    if len(partials) == 1:
        return list(partials)
    return list(_EdgeScatter.apply(mesh, tuple(homes), *partials))


# -- the reference's collectives, over per-position tensors -------------------

def _axis_groups(mesh, axis: str) -> List[List[int]]:
    """The positions of ``mesh`` grouped by every coordinate but
    ``axis``'s, each group in ascending ``axis`` coordinate."""
    groups: Dict[Tuple, List[int]] = {}
    for pos in range(mesh.size):
        c = mesh.coords(pos)
        key = tuple(v for a, v in c.items() if a != axis)
        groups.setdefault(key, []).append(pos)
    return list(groups.values())


def _psum(mesh, xs: List[torch.Tensor], axis: str,
          collective: str) -> List[torch.Tensor]:
    """``jax.lax.psum`` over ``axis``: each group's tensors summed from
    the lowest coordinate up and the sum handed to every member."""
    out = list(xs)
    for group in _axis_groups(mesh, axis):
        dst = group[0]
        total = xs[dst]
        for p in group[1:]:
            mesh.count(collective, _nbytes(xs[p]), to=dst)
            total = total + xs[p].to(mesh.device(dst))
        for p in group:
            if p != dst:
                mesh.count(collective, _nbytes(total), to=p)
            out[p] = total.to(mesh.device(p), copy=True)
    return out


def sparse_allreduce(mesh, values: Sequence[torch.Tensor],
                     indices: Sequence[torch.Tensor], size: int,
                     axis_name: str) -> List[torch.Tensor]:
    """Sum per-position sparse contributions into a dense vector.

    values/indices: one (k,) pair per mesh position. Each is densified
    by ``sparse.segment.segment_sum`` (entries at one index added in
    ascending k from zero, out-of-range indices dropped as JAX drops
    them; no atomics) and the dense
    vectors are summed over ``axis_name`` in ascending coordinate order;
    returns the (size,) sum per position."""
    dense = [segment_sum(v, i, size) for v, i in zip(values, indices)]
    return _psum(mesh, dense, axis_name, "sparse_allreduce")


def hierarchical_psum(mesh, xs: Sequence[torch.Tensor], inner_axis: str,
                      outer_axis: str) -> List[torch.Tensor]:
    """Reduce-scatter over ``inner_axis``, all-reduce over ``outer_axis``,
    all-gather over ``inner_axis``: the 2-level gradient reduction. Shard
    j of the inner reduce-scatter is the sum, from the lowest inner
    coordinate up, of every member's j-th slice (of ``n_inner`` equal
    slices of the flattened tensor)."""
    n_inner = mesh.axis_size(inner_axis)
    scattered: List[torch.Tensor] = [None] * mesh.size
    for group in _axis_groups(mesh, inner_axis):
        for j, dst in enumerate(group):
            total = None
            for p in group:
                part = xs[p].reshape(n_inner, -1)[j]
                if p != dst:
                    mesh.count("hierarchical_psum", _nbytes(part), to=dst)
                part = part.to(mesh.device(dst))
                total = part if total is None else total + part
            scattered[dst] = total
    reduced = _psum(mesh, scattered, outer_axis, "hierarchical_psum")
    out: List[torch.Tensor] = [None] * mesh.size
    for group in _axis_groups(mesh, inner_axis):
        for dst in group:
            parts = []
            for p in group:
                if p != dst:
                    mesh.count("hierarchical_psum", _nbytes(reduced[p]),
                               to=dst)
                parts.append(reduced[p].to(mesh.device(dst)))
            out[dst] = torch.stack(parts).reshape(xs[dst].shape)
    return out


def batch_groups(mesh, spec_entry) -> Tuple[List[int], List[List[int]]]:
    """For the batch axes of ``spec_entry``: each batch shard's home
    position (its first position) and its group (every position with its
    batch coordinates), batch shards in mixed-radix order, first axis
    major."""
    axes = entry_axes(spec_entry)
    n = 1
    for a in axes:
        n *= mesh.axis_size(a)
    homes, groups = [], []
    for d in range(n):
        want, r = {}, d
        for a in reversed(axes):
            want[a] = r % mesh.axis_size(a)
            r //= mesh.axis_size(a)
        group = [p for p in range(mesh.size)
                 if all(mesh.coords(p)[a] == v for a, v in want.items())]
        homes.append(group[0])
        groups.append(group)
    return homes, groups
