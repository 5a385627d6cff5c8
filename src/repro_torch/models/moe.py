"""Mixture-of-Experts block — grouped sort-based capacity dispatch
(PyTorch port of ``repro.models.moe``).

Tokens are split into groups; within each group, (token, expert) slots
are sorted by expert id, truncated to a static per-expert capacity C and
run through the grouped expert GEMM kernel over the whole (G, E, C, d)
dispatch buffer (three launches: gate, up, down), as the autograd function
``ExpertGemm``, whose backward is two more launches per product (its dX
and dW variants). The gradient reaches the router through the gates (the sorted
values of ``top_k_stable``) and the aux loss's mean probabilities.
Overflow slots beyond capacity are dropped (GShard/Switch semantics); the
Switch load-balance aux loss is returned too.

Order is kept where the JAX block fixes it: the top-k breaks ties toward
the lower expert id (a stable descending sort), the slot sort is stable,
and the combine is a gather in which each token sums its own kept slots
in ascending sorted-slot order, starting from zero — the order of the
reference's scatter-add, and free of atomics, so two runs on the card
give the same bits. The dispatch's token gather has the transpose of that
combine as its backward (:class:`DispatchGather`): autograd's own backward
for a gather is ``scatter_add_``, which adds a token's k slot gradients
with atomics on the card, in no fixed order.

The expert weights may come as
:class:`~repro_torch.distrib.collectives.Blocks` (expert parallelism, the
reference's ``models/moe.py:88-109`` under ``exp_spec``; in the serving
steps under ``tp2d`` whether or not the batch is split), E / M experts on
each "model" shard's device: the dispatch buffer stays with its batch shard,
each shard's E slice of it is sent where its experts live, the three
products run there on E / M experts, and the outputs come back and are
concatenated along E in shard order before the combine. Each expert's
products, and the backward's dX and dW, read only that expert's rows, so
the result is bitwise the unsharded one, forward and backward. Every
expert's d_ff split into blocks (``moe_shard="ffn"``, serving with the
batch whole) takes the whole buffer to each block and adds the down
products' partials at home in block order (f32, rounded once). Handed
every batch shard's tokens as ``Rows`` (serving under ``tp2d``), the block
takes the router's logits from one ``layers.linear`` over all of them and
runs the rest at each home. In the ``tp2d`` train step (the leaves as
``TPView`` s, the rows at every position) each position routes its rows
and runs its "model" block of the experts: its E / M experts
(``moe_shard="expert"``, the outputs gathered along "model") or every
expert's d_ff / M columns (``"ffn"``, the down products' partials summed
over "model").

Groups are formed as the reference forms them: ``n_groups`` counts the
groups over every batch shard's tokens together (a serving step's batch,
a train step's microbatch), and group g holds tokens [g·T/G, (g+1)·T/G)
of the whole batch in (batch, position) order. Where that puts whole
groups in each batch shard, each shard routes its own, and in a train
step the aux loss is taken over all the shards' groups
(:func:`_batch_aux`). Where one group spans several batch shards under
``tp2d`` (a serving step with the batch split over "data" and fewer
tokens than a group: every decode step with B below the group size; a
train step whose microbatch holds fewer tokens a shard than a group), it
is routed once over all its rows (:func:`_moe_across_shards`): each
position gathers the group's router probabilities along "data" and
routes the whole group (the same top-k and stable slot sort at every
position), fills the group's dispatch buffer with its own tokens, takes
each slot's row from the one batch shard that owns it
(``moe_group_dispatch``, a select), runs its experts as the split step
does, and combines its own tokens; the backward sends the probabilities'
gradients back to their shards and keeps each dispatch row's at its
owner. The ``fsdp`` train step never hands this block a group that spans
its homes: it computes such a group's shards at the first one's home
(``train.state.make_sharded_train_step``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.distrib.collectives import (Blocks, Rows, TPView,
                                             _model_of, batch_sum, each,
                                             model_gather,
                                             model_slice, model_sum,
                                             model_sum_grad, send,
                                             send_slices, span_gather,
                                             span_select)
from repro_torch.kernels.expert_gemm import ExpertGemm
from repro_torch.models.layers import linear


def moe_capacity(group_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    c = int(group_tokens * top_k * capacity_factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)  # multiple of 8, as the reference


def top_k_stable(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties toward the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One MoE block's routing: G groups of S tokens, capacity C per expert;
    N = S·k (token, expert) slots per group, in sorted order where noted."""
    G: int
    S: int
    C: int
    probs: torch.Tensor       # (G, S, E) f32 router softmax
    gate_vals: torch.Tensor   # (G, S, k) renormalised top-k probabilities
    expert_idx: torch.Tensor  # (G, S, k) top-k experts, ties to lower ids
    perm: torch.Tensor        # (G, N) stable sort of the slots by expert
    tokens: torch.Tensor      # (G, N) token of each sorted slot
    gates: torch.Tensor       # (G, N) gate of each sorted slot
    keep: torch.Tensor        # (G, N) sorted slot within capacity
    rows: torch.Tensor        # (G, N) dispatch row e·C + rank, E·C if dropped


def _groups(T: int, n_groups: int) -> Tuple[int, int]:
    """(G, S): ``n_groups`` groups of T / G tokens, one group when
    ``n_groups`` does not divide T."""
    G = n_groups if T % n_groups == 0 else 1
    return G, T // G


def batch_shards(x, router) -> int:
    """The shards of one batch whose tokens ``x`` holds, which the
    reference groups together: a ``TPView`` router's batch shards (the
    rows at every position: a serving step's batch, or a ``tp2d`` train
    step's microbatch, split over them), each home of ``Rows``, else
    one."""
    if isinstance(router, TPView):
        return len(router.groups)
    return len(x.parts) if isinstance(x, Rows) else 1


def shard_groups(tokens: int, n_groups: int, shards: int
                 ) -> Tuple[int, int, int]:
    """For ``shards`` batch shards of ``tokens`` tokens each and
    ``n_groups`` groups over all of them (:func:`_groups` of the whole
    batch): (groups in each shard, tokens a group, shards a group
    spans). A group spans more than one shard only where it holds more
    tokens than a shard."""
    G, S = _groups(tokens * shards, n_groups)
    if G % shards == 0:
        return G // shards, S, 1
    if shards % G == 0:
        return 1, S, shards // G
    raise ValueError(f"{G} MoE groups of {S} tokens neither fit into nor "
                     f"span whole batch shards of {tokens} tokens")


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
          n_groups: int, capacity_factor: float = 1.25) -> Routing:
    """Top-k routing and the per-group sort-based slot assignment of
    ``moe_block`` for x: (T, d)."""
    T, d = x.shape
    G, S = _groups(T, n_groups)
    return routing(x.reshape(G, S, d) @ router.to(x.dtype), cfg,
                   capacity_factor)


def routing(logits: torch.Tensor, cfg: MoEConfig,
            capacity_factor: float = 1.25, probs=None) -> Routing:
    """:func:`route` from the router's (G, S, E) logits, or from their
    softmax ``probs`` where given (``logits`` then unused)."""
    if probs is None:
        probs = torch.softmax(logits.float(), dim=-1)         # (G, S, E)
    G, S, _ = probs.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(S, E, k, capacity_factor)
    dev = probs.device

    gate_vals, expert_idx = top_k_stable(probs, k)            # (G, S, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                # renormalize

    N = S * k
    e_flat = expert_idx.reshape(G, N)
    tok_flat = torch.arange(S, device=dev).repeat_interleave(k) \
        .expand(G, N)
    se, perm = torch.sort(e_flat, dim=1, stable=True)
    st = tok_flat.gather(1, perm)
    sg = gate_vals.reshape(G, N).gather(1, perm)

    ar = torch.arange(N, device=dev)[None, :]
    is_start = torch.cat([torch.ones((G, 1), dtype=torch.bool, device=dev),
                          se[:, 1:] != se[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    pos = ar - run_start                                      # rank within expert
    keep = pos < C
    rows = torch.where(keep, se * C + pos, E * C)             # E*C → dropped
    return Routing(G, S, C, probs, gate_vals, expert_idx, perm, st, sg,
                   keep, rows)


def moe_block(x, params: Dict[str, torch.Tensor],
              cfg: MoEConfig, n_groups: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) → (y: (T, d), aux_loss scalar).

    params: router (d, E); wg/wu (E, d, f); wd (E, f, d), each a tensor
    or, for the experts, :class:`Blocks` of it along E (the experts where
    they live, as the reference's ``exp_spec`` places them). With x as
    ``Rows`` (and the leaves as ``StationaryView`` s; ``TPView`` s in the
    ``tp2d`` steps: :func:`_moe_over_model`; or each home's own tensors as
    Rows in the ``fsdp`` train step's microbatch over several homes, whose
    aux loss is then taken over all their groups, :func:`_batch_aux`) y
    and aux come as Rows, and ``n_groups`` counts the groups over every
    batch shard's tokens (:func:`shard_groups`).
    """
    if isinstance(params["router"], TPView):
        return _moe_over_model(x, params, cfg, n_groups, capacity_factor)
    if isinstance(x, Rows):
        G, S, shards = shard_groups(x.shape[0], n_groups, len(x.parts))
        if shards > 1:
            raise NotImplementedError(
                f"moe_block: a group of {S} tokens spans {shards} batch "
                f"shards whose weights each home reads alone")
        logits = linear(x, params["router"], x.dtype)

        def block(xd, lg, wg, wu, wd):
            r = routing(lg.reshape(G, S, -1), cfg, capacity_factor)
            return _routed(xd, r, wg, wu, wd, cfg) + (r,)
        y, aux, r = each(block, x, logits, params["wg"], params["wu"],
                         params["wd"])
        if isinstance(params["router"], Rows):  # the fsdp train step's
            aux = _batch_aux(r, None, cfg)      # homes: over all groups
        return y, aux
    r = route(x, params["router"], cfg, n_groups, capacity_factor)
    return _routed(x, r, params["wg"], params["wu"], params["wd"], cfg)


def _moe_over_model(x: Rows, params, cfg: MoEConfig, n_groups: int,
                    capacity_factor: float):
    """:func:`moe_block` in the ``tp2d`` train step, every position's rows
    (the same at each position of a "model" group) as ``Rows``: the router
    gathered along "data" and the routing, dispatch and combine repeated
    at every position, as the reference's partitioner repeats them under
    ``exp_spec = P(batch, "model", None, None)``. Experts split over
    "model" (``moe_shard="expert"``): each position takes its E / M
    experts' slice of its own dispatch buffer, runs them, and the outputs
    are gathered along "model" for the combine (``expert_gather``; the
    backward gathers the slices' input gradients the same way). Each
    expert's d_ff split over "model" (``moe_shard="ffn"``): every position
    runs all experts on its f / M columns, the down products' partials
    summed over "model" in f32 and rounded once before the combine
    (``tp_model_sum``; the dispatch buffer's gradient partials likewise).
    Experts on no "model" axis run whole at every position. In a train
    step with the batch split over D batch shards the aux loss is the
    reference's over all their groups: each position's mean router
    probabilities and slot counts per expert are added over its line of
    the shards (:func:`_batch_aux`; a serving step discards the aux loss
    and each shard keeps its own). A group that spans batch shards is
    routed once over them (:func:`_moe_across_shards`), at a serving step
    and in the train step alike."""
    view = params["router"]
    D = batch_shards(x, view)
    G, S, shards = shard_groups(x.shape[0], n_groups, D)
    if shards > 1:
        return _moe_across_shards(x, params, cfg, shards, capacity_factor)
    logits = linear(x, view, x.dtype)

    def dispatch(xd, lg):
        r = routing(lg.reshape(G, S, -1), cfg, capacity_factor)
        x_exp, aux, order = _dispatch(xd, r, cfg)
        return x_exp, aux, r, order
    x_exp, aux, r, order = each(dispatch, x, logits)
    if D > 1 and view.training:
        aux = _batch_aux(r, view, cfg)
    wg, wu, wd = params["wg"], params["wu"], params["wd"]
    E, d = cfg.n_experts, x.shape[-1]
    C = x_exp.shape[1]
    counts = wg.x.layout.counts
    if counts[0] > 1:                   # the experts over "model"
        mine = model_slice(each(torch.Tensor.view, x_exp, (G, E, C, d)), 1,
                           "expert_gather")
        y = each(lambda xm, pg, pu, pd: _experts(
            xm.view(-1, C, d), pg, pu, pd).view(G, -1, C, d),
            mine, wg, wu, wd)
        y_exp = model_gather(y, 1, "expert_gather")
    elif counts[2] > 1:                 # each expert's d_ff over "model"
        xs = model_sum_grad(x_exp)
        h = each(lambda xe, pg, pu: _gated_experts(xe, pg, pu), xs, wg, wu)
        y_exp = model_sum(each(lambda hm, pd: ExpertGemm.apply(
            hm, pd.to(hm.dtype)), h, wd), x.dtype)
    else:
        y_exp = each(_experts, x_exp, wg, wu, wd)
    y = each(lambda ye, rd, od: _combine(ye.reshape(G, E * C, d), rd, od),
             y_exp, r, order)
    return y, aux


def _moe_across_shards(x: Rows, params, cfg: MoEConfig, shards: int,
                       capacity_factor: float):
    """:func:`_moe_over_model` where each group spans ``shards`` batch
    shards (one group per position's rows), routed once as the reference
    routes it. Each position's router logits for its own rows
    (:func:`linear`: at a decode step the router re-split over "model")
    become probabilities there, which are gathered along its line of the
    group's shards in batch order (``moe_group_probs``), so every position
    routes the whole group alike. Each position fills the group's (E·C, d)
    dispatch buffer with its own tokens' kept slots, taking them in sorted
    slot order (``DispatchGather``: the backward adds each token's k slot
    gradients in that order, no atomics); the rows a position's experts
    read (its E / M experts' under ``moe_shard="expert"``, else all) are
    each taken from the one batch shard that owns the slot's token
    (``moe_group_dispatch``, a select: the one-device buffer's bits). The
    experts run as :func:`_moe_over_model` runs them (the backward makes
    each position's dispatch gradient whole again over "model": the E / M
    experts' slices gathered, ``expert_gather``, or under
    ``moe_shard="ffn"`` the d_ff blocks' partials summed), and each
    position combines its own tokens in sorted-slot order.

    The backward follows the forward's moves: each position's probability
    gradients go back to the shards whose rows they are
    (``moe_group_probs_grad``, added in batch order), and each dispatch
    row's gradient is the one its owner computed (only the owner combines
    the row's token). ``aux`` is the group's: in a train step the group's
    statistics are counted once, at its first shard, and added over
    "data" with the other groups' (:func:`_batch_aux`); at a serving step
    each position's own."""
    view = params["router"]
    E, k, d = cfg.n_experts, cfg.top_k, x.shape[-1]
    T = x.shape[0]
    probs = each(lambda lg: torch.softmax(lg.float(), dim=-1),
                 linear(x, view, x.dtype))
    probs = span_gather(probs, view, shards, "moe_group_probs")
    mesh = x.mesh
    rs, orders = [], []                 # a Routing is a tuple: no each()
    for p, pr in zip(x.homes, probs.parts):
        with mesh.at(p):
            rs.append(routing(None, cfg, capacity_factor, probs=pr[None]))
            orders.append(slot_order(rs[-1].perm, k))
    lo = {p: view.shard[p] % shards * T for p in x.homes}
    C = rs[0].C
    wg, wu, wd = params["wg"], params["wu"], params["wd"]
    counts = wg.x.layout.counts
    M = counts[0] if counts[0] > 1 else 1     # the experts over "model"

    # each position's dispatch rows (its share of the experts) filled with
    # its own tokens' kept slots, and each row's owning shard in the group
    # (its own where no token fills the row)
    bufs, owners = [], []
    for p, xd, rp, order in zip(x.homes, x.parts, rs, orders):
        keep, tok, rows = rp.keep[0], rp.tokens[0], rp.rows[0]
        m = _model_of(mesh, p) if M > 1 else 0
        a, b = m * (E // M) * C, (m + 1) * (E // M) * C
        with mesh.at(p):
            mine = keep & (tok >= lo[p]) & (tok < lo[p] + T)
            src = DispatchGather.apply(
                xd[None], torch.clamp(tok - lo[p], 0, T - 1)[None],
                order[:, lo[p]:lo[p] + T])[0]
            buf = torch.zeros((E * C + 1, d), dtype=xd.dtype,
                              device=xd.device)
            buf[torch.where(mine, rows, E * C)] = src
            owner = torch.full((E * C + 1,), lo[p] // T, dtype=torch.int64,
                               device=xd.device)
            owner[torch.where(keep, rows, E * C)] = tok // T
            bufs.append(buf[:E * C])
            owners.append(owner[a:b])
    bufs = Rows(bufs, x.homes, mesh)
    if M > 1:   # its E / M experts' rows; the backward gathers the slices'
        bufs = model_slice(bufs, 0, "expert_gather")    # gradients
    x_exp = span_select(bufs, Rows(owners, x.homes, mesh), view, shards,
                        "moe_group_dispatch")
    del bufs, owners
    if M > 1:
        y = each(lambda xm, pg, pu, pd: _experts(
            xm.view(-1, C, d), pg, pu, pd).view(1, -1, C, d),
            x_exp, wg, wu, wd)
        y_exp = model_gather(y, 1, "expert_gather")
    elif counts[2] > 1:                 # each expert's d_ff over "model"
        xs = model_sum_grad(each(lambda xe: xe.view(E, C, d), x_exp))
        h = each(lambda xe, pg, pu: _gated_experts(xe, pg, pu), xs, wg, wu)
        y_exp = model_sum(each(lambda hm, pd: ExpertGemm.apply(
            hm, pd.to(hm.dtype)), h, wd), x.dtype)
    else:
        y_exp = each(lambda xe, pg, pu, pd: _experts(
            xe.view(E, C, d), pg, pu, pd), x_exp, wg, wu, wd)
    out = []
    for p, ye, rp, order in zip(x.homes, y_exp.parts, rs, orders):
        with mesh.at(p):
            out.append(_combine(ye.reshape(1, E * C, d), rp,
                                order[:, lo[p]:lo[p] + T]))
    r = Rows(rs, x.homes, mesh)
    if view.training:
        aux = _batch_aux(r, view, cfg, shards)
    else:
        aux = each(lambda rd: _aux(rd, cfg), r)
    return Rows(out, x.homes, mesh), aux


def _slot_counts(r: Routing, E: int) -> torch.Tensor:
    """The routing's slots per expert (E,): an integer count (exact in any
    order), as a scatter-add of fixed length so meta tensors take it too."""
    idx = r.expert_idx.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _aux(r: Routing, cfg: MoEConfig) -> torch.Tensor:
    """The Switch aux loss of the routing ``r``: E · mean(fraction routed
    to e) · mean(router probability of e)."""
    E, k = cfg.n_experts, cfg.top_k
    me = r.probs.mean(dim=(0, 1))                             # (E,)
    ce = _slot_counts(r, E).float() / (r.G * r.S * k)
    return E * torch.sum(me * ce)


def _batch_aux(r: Rows, view, cfg: MoEConfig, shards: int = 1) -> Rows:
    """:func:`_aux` over the groups of every batch shard of ``view`` (or,
    with ``view`` None, of every home of ``r``: the ``fsdp`` train step's
    microbatch over several homes) at once, from each position's routing
    ``r`` (its shard's groups, the shards equal): each position's mean
    probabilities and slot counts (int32) per expert are added over its
    line of the shards (``collectives.batch_sum``, ``moe_aux_sum``), the
    means divided by the number of terms; the gradient reaches each
    shard's probabilities through its own mean. Where a group spans
    ``shards`` shards every position of it routes the whole group, so the
    group's statistics come from its first shard only and the others add
    zeros: each group is counted once."""
    E, k = cfg.n_experts, cfg.top_k
    mesh = r.mesh
    me, ce = [], []
    for p, rd in zip(r.homes, r.parts):
        with mesh.at(p):
            if view is None or view.shard[p] % shards == 0:
                me.append(rd.probs.mean(dim=(0, 1)))
                ce.append(_slot_counts(rd, E).to(torch.int32))
            else:
                me.append(torch.zeros((E,), device=rd.probs.device))
                ce.append(torch.zeros((E,), dtype=torch.int32,
                                      device=rd.probs.device))
    me = batch_sum(Rows(me, r.homes, mesh), view, "moe_aux_sum")
    ce = batch_sum(Rows(ce, r.homes, mesh), view, "moe_aux_sum")
    D = (len(r.homes) if view is None else len(view.groups)) // shards
    n = D * r.parts[0].G * r.parts[0].S * k

    def aux(m, c):
        return (E * torch.sum(m / D * (c.float() / n))).float()
    return each(aux, me, ce)


def _dispatch(x: torch.Tensor, r: Routing, cfg: MoEConfig):
    """The Switch aux loss and the (G·E, C, d) dispatch buffer of
    ``moe_block`` after the routing ``r``, and each token's slot order."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G, S, C = r.G, r.S, r.C
    N = S * k
    dev = x.device
    aux = _aux(r, cfg)

    # each token's k sorted positions, ascending: the order in which the
    # combine adds a token's slots, and the dispatch gather's backward
    # adds their gradients
    order = slot_order(r.perm, k)
    # dispatch: kept slots land in a flat (G·E·C, d) buffer; dropped ones in
    # one extra row past its end, cut off before the products
    g_base = (torch.arange(G, device=dev) * (E * C))[:, None]
    dst = torch.where(r.keep, g_base + r.rows, G * E * C)
    buf = torch.zeros((G * E * C + 1, d), dtype=x.dtype, device=dev)
    src = DispatchGather.apply(x.reshape(G, S, d), r.tokens, order)
    buf[dst.reshape(-1)] = src.reshape(G * N, d)
    return buf[:G * E * C].view(G * E, C, d), aux.float(), order


def _combine(y_exp: torch.Tensor, r: Routing, order: torch.Tensor
             ) -> torch.Tensor:
    """The (T, d) output from the (G, E·C, d) expert outputs: sorted slot i
    feeds token r.tokens[i]; each token gathers its k slots and adds them
    in ascending sorted position, starting from 0. ``order`` may hold a
    run of each group's tokens only, whose outputs come alone."""
    G, EC, d = y_exp.shape
    N = r.rows.shape[1]
    picked = y_exp.gather(
        1, torch.clamp_max(r.rows, EC - 1)[..., None].expand(G, N, d))
    picked = picked * (r.gates * r.keep).to(y_exp.dtype)[..., None]
    return sum_slots(picked, order).reshape(G * order.shape[1], d)


def _routed(x: torch.Tensor, r: Routing, wg, wu, wd, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_block` after the routing ``r``."""
    x_exp, aux, order = _dispatch(x, r, cfg)
    G, E, C, d = r.G, cfg.n_experts, r.C, x.shape[1]
    if isinstance(wg, Blocks) and wg.dim != 0:
        y_exp = _ffn_where_they_live(x_exp, wg, wu, wd)
    elif isinstance(wg, Blocks):
        y_exp = _experts_where_they_live(x_exp.view(G, E, C, d), wg, wu, wd)
    else:
        y_exp = _experts(x_exp, wg, wu, wd)
    return _combine(y_exp.view(G, E * C, d), r, order), aux


def _gated_experts(x_exp: torch.Tensor, wg, wu) -> torch.Tensor:
    """silu(x·wg) · (x·wu) over a (G·E, C, d) dispatch buffer."""
    gemm = ExpertGemm.apply
    dt = x_exp.dtype
    return F.silu(gemm(x_exp, wg.to(dt))) * gemm(x_exp, wu.to(dt))


def _experts(x_exp: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The three expert products over a (G·E, C, d) dispatch buffer."""
    h = _gated_experts(x_exp, wg, wu)
    return ExpertGemm.apply(h, wd.to(x_exp.dtype))


def _experts_where_they_live(x4: torch.Tensor, wg: Blocks, wu: Blocks,
                             wd: Blocks) -> torch.Tensor:
    """(G, E, C, d) dispatch buffer at its batch shard's position → the
    (G, E, C, d) expert outputs there: each expert shard's E slice is sent
    to the shard's device, multiplied there by its E / M experts, and sent
    back; the slices are concatenated along E in shard order."""
    G, E, C, d = x4.shape
    mesh, home = wg.mesh, wg.home
    if len(wg.parts) == 1 and wg.positions[0] == home:
        return _experts(x4.reshape(G * E, C, d), wg.parts[0], wu.parts[0],
                        wd.parts[0]).view(G, E, C, d)
    sizes = [pg.shape[0] for pg in wg.parts]
    xs = send_slices(x4, mesh, home, wg.positions, sizes)
    outs = []
    for xm, pg, pu, pd, pos in zip(xs, wg.parts, wu.parts, wd.parts,
                                   wg.positions):
        Em = pg.shape[0]
        with mesh.at(pos):
            ym = _experts(xm.view(G * Em, C, d), pg, pu, pd) \
                .view(G, Em, C, d)
        outs.append(send(ym, mesh, pos, home))
    return torch.cat(outs, dim=1)


def _ffn_where_they_live(x_exp: torch.Tensor, wg: Blocks, wu: Blocks,
                         wd: Blocks) -> torch.Tensor:
    """(G·E, C, d) dispatch buffer at its batch shard's position → the
    expert outputs there, every expert's d_ff split into blocks where they
    live (``moe_shard="ffn"``): the buffer is sent to each block's position,
    which runs all experts on its d_ff columns, and the down products'
    partials come back and are added in block order in f32, rounded once
    (as the ``tp2d`` train step's ``model_sum``). One block at the home is
    :func:`_experts` itself."""
    mesh, home = wg.mesh, wg.home
    if len(wg.parts) == 1 and wg.positions[0] == home:
        return _experts(x_exp, wg.parts[0], wu.parts[0], wd.parts[0])
    total = None
    for pg, pu, pd, pos in zip(wg.parts, wu.parts, wd.parts, wg.positions):
        xm = send(x_exp, mesh, home, pos)
        with mesh.at(pos):
            ym = _experts(xm, pg, pu, pd)
        ym = send(ym, mesh, pos, home)
        with mesh.at(home):
            total = ym.float() if total is None else total + ym.float()
    with mesh.at(home):
        return total.to(x_exp.dtype)


def slot_order(perm: torch.Tensor, k: int) -> torch.Tensor:
    """(G, S, k) sorted positions of each token's k slots, ascending, from
    the (G, N) slot sort ``perm`` (slot t·k + j is token t's j-th)."""
    G, N = perm.shape
    inv = torch.empty_like(perm)                              # slot → sorted pos
    inv.scatter_(1, perm, torch.arange(N, device=perm.device).expand(G, N))
    return torch.sort(inv.view(G, N // k, k), dim=-1).values


def sum_slots(v: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(G, N, d) rows in sorted-slot order → (G, S, d): each token's k rows
    (``order``, ascending) added from zero in that order, no atomics."""
    G, S, k = order.shape
    d = v.shape[-1]
    mine = v.gather(1, order.reshape(G, S * k)[..., None].expand(G, S * k, d)) \
        .view(G, S, k, d)
    y = torch.zeros((G, S, d), dtype=v.dtype, device=v.device)
    for j in range(k):
        y = y + mine[:, :, j]
    return y


class DispatchGather(torch.autograd.Function):
    """``x.gather(1, tokens)`` over (G, S, d) → (G, N, d) rows in
    sorted-slot order, with a backward that sums each token's k slot
    gradients from zero in ascending sorted-slot order (``sum_slots``, the
    combine's order) instead of autograd's ``scatter_add_``, whose atomics
    make the sum's order, and so its bits, vary from run to run on the
    card."""

    @staticmethod
    def forward(ctx, x, tokens, order):
        ctx.save_for_backward(order)
        G, N = tokens.shape
        return x.gather(1, tokens[..., None].expand(G, N, x.shape[-1]))

    @staticmethod
    def backward(ctx, grad):
        order, = ctx.saved_tensors
        return sum_slots(grad, order), None, None


def init_moe_params(gen: torch.Generator, cfg: MoEConfig, d_model: int,
                    dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Router and expert weights on ``device`` (default: the generator's;
    ``"meta"`` draws nothing), drawn in f32 and stored in ``dtype``."""
    E, f = cfg.n_experts, cfg.d_ff_expert
    s_in = (2.0 / (d_model + f)) ** 0.5
    dev = gen.device if device is None else device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    return {
        "router": normal((d_model, E), 0.02),
        "wg": normal((E, d_model, f), s_in),
        "wu": normal((E, d_model, f), s_in),
        "wd": normal((E, f, d_model), s_in),
    }
