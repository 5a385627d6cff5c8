"""TrainState + generic train-step builder (forward + backward + AdamW)
with optional gradient-accumulation microbatching (PyTorch port of
``repro.train.state``).

The step differentiates ``loss_fn`` with autograd: the parameters are
leaves that require grad, each microbatch's ``backward`` accumulates into
their ``.grad`` (f32 for the f32 masters training keeps; another dtype is
gathered into an f32 sum), and ``adamw_update`` then updates the state in
place. ``stack_layers`` / ``load_stacked`` convert the state to and from
the reference's layout (``params["layers"]`` stacked on a leading axis),
in which checkpoints are written.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _host_array
from repro_torch.config.base import TrainConfig
from repro_torch.distrib.collectives import (HomeViews, Rows, ShardView,
                                             TPView, batch_groups, local,
                                             span)
from repro_torch.distrib.sharding import (P, ShardedTensor, assemble,
                                          device_put, map_with_specs,
                                          sharded_zeros)
from repro_torch.models.gnn.common import EdgeHomes
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_leaf,
                                     adamw_update, reference_ndims,
                                     tree_leaves, tree_map)
from repro_torch.optim.schedules import warmup_cosine


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def new_train_state(params) -> TrainState:
    return TrainState(params, adamw_init(params))


def make_train_step(loss_fn: Callable, tcfg: TrainConfig,
                    microbatches: int = 1) -> Callable:
    """loss_fn(params, *batch) → scalar. Batch tensors (or named tuples,
    tuples, lists and dicts of them, ``None`` fields passed through) have a
    leading global-batch axis; with microbatches > 1 every tensor is split
    as the reference's ``jax.tree.map`` splits it
    (``reshape((microbatches, -1) + rest)``), the
    gradients summed in f32 in microbatch order and divided, and the loss
    sum divided too. ``step(state, *batch) → (state, metrics)`` with
    metrics ``loss``, ``grad_norm`` and ``lr`` (scalar tensors)."""

    def step(state: TrainState, *batch) -> Tuple[TrainState, dict]:
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if microbatches > 1:
            split = tree_map(lambda x: x.reshape(
                (microbatches, -1) + tuple(x.shape[1:])), batch)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            acc = [None] * len(leaves)  # f32 sums of non-f32 leaves' grads
            for i in range(microbatches):
                mb_loss = loss_fn(state.params,
                                  *tree_map(lambda x: x[i], split))
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                for j, p in enumerate(leaves):
                    if p.grad is not None and p.grad.dtype != torch.float32:
                        g = p.grad.float()
                        acc[j] = g if acc[j] is None else acc[j] + g
                        p.grad = None
            loss = loss / microbatches
            grads = [(a if a is not None else _grad(p)) / microbatches
                     for p, a in zip(leaves, acc)]
        else:
            loss = loss_fn(state.params, *batch)
            loss.backward()
            loss = loss.detach()
            grads = [_grad(p) for p in leaves]
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)

        lr = warmup_cosine(state.opt.step, tcfg.learning_rate,
                           tcfg.warmup_steps, tcfg.total_steps)
        params, opt, gnorm = adamw_update(
            grads, state.opt, state.params, lr,
            b1=tcfg.b1, b2=tcfg.b2, eps=tcfg.eps,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        return TrainState(params, opt), {"loss": loss, "grad_norm": gnorm,
                                         "lr": lr}

    return step


def new_sharded_train_state(params, mesh, state_specs) -> TrainState:
    """``new_train_state(params)`` placed on ``mesh`` by ``state_specs``
    (``distrib.sharding.state_specs_like``): the parameters split by their
    specs, the moments zeros allocated shard by shard, the step a
    replicated int32 zero."""
    specs = state_specs.opt
    return TrainState(
        map_with_specs(lambda x, s: device_put(x, mesh, s), params,
                       state_specs.params),
        AdamWState(
            sharded_zeros(mesh, P(), (), torch.int32),
            map_with_specs(lambda x, s: sharded_zeros(mesh, s, x.shape),
                           params, specs.m),
            map_with_specs(lambda x, s: sharded_zeros(mesh, s, x.shape),
                           params, specs.v)))


def _add_grads(mesh, views, sums) -> None:
    """Add one batch shard's (or edge home's) gradients, block by block, to
    ``sums`` at each block's owner (its first holder), after what is there:
    called in ascending shard order, it adds the shards in that order. A
    block the shard's loss did not reach adds nothing (as autograd's
    accumulation over microbatches adds nothing: no zeros, so a −0.0
    stays); :func:`_zeros_where_unreached` fills a block no shard
    reached."""
    with span("grad_psum"):
        for j, view in enumerate(tree_leaves(views)):
            x = view.x
            for block, src, g in view.grads():
                if g is None:
                    continue
                owner = x.layout.holders(block)[0]
                if src != owner:
                    mesh.count("grad_psum", g.numel() * g.element_size(),
                               frm=src, to=owner)
                with mesh.at(owner):
                    with mesh.moving():
                        g = g.to(mesh.device(owner))
                    prev = sums[j].get(block)
                    sums[j][block] = g if prev is None else prev + g


def _zeros_where_unreached(mesh, leaves, sums) -> None:
    """Zeros, at its owner, for each block no shard's loss reached."""
    for x, blocks in zip(leaves, sums):
        for block in x.layout.blocks():
            if block not in blocks:
                owner = x.layout.holders(block)[0]
                with mesh.at(owner):
                    blocks[block] = torch.zeros_like(x.shards[owner])


def _sharded_update(state: TrainState, sums, loss, tcfg: TrainConfig,
                    mesh) -> Tuple[TrainState, dict]:
    """The sharded steps' tail, from each leaf's summed gradient blocks
    (``sums``, at their owners): the clip's global norm, gathered one leaf
    at a time and summed in ``global_norm``'s leaf order (so it keeps that
    function's bits), the clip scale and lr at position 0, AdamW on every
    position's shards with the weight decay of each whole leaf's reference
    ndim, and the step counter; the state is updated in place."""
    leaves = tree_leaves(state.params)
    dev0 = mesh.device(0)
    # position 0's own work: the global norm, the clip scale, lr
    with mesh.at(0):
        # the global norm in global_norm's order: whole leaves, in order
        total = 0
        for x, blocks in zip(leaves, sums):
            parts = {}
            for block, g in blocks.items():
                if 0 not in x.layout.holders(block):
                    mesh.count("norm_gather", g.numel() * g.element_size(),
                               frm=x.layout.holders(block)[0], to=0)
                parts[block] = g
            with span("norm_gather"), mesh.moving():
                whole = assemble(x.layout, parts, dev0, g.dtype)
            total = total + torch.sum(torch.square(whole.float()))
            del whole, parts
        gnorm = torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
        lr, consts0 = _update_consts(state.opt.step.shards[0], gnorm, tcfg)
    on = {}  # device → (lr, bc1, bc2, scale) there

    def consts(pos):
        dev = mesh.device(pos)
        if dev not in on:
            on[dev] = tuple(None if c is None else c.to(dev)
                            for c in consts0)
        return on[dev]

    return _adamw_blocks(state, sums, tcfg, mesh, consts), \
        {"loss": loss, "grad_norm": gnorm, "lr": lr}


def _update_consts(step, gnorm, tcfg: TrainConfig):
    """lr at ``step`` (the schedule's value, as the metrics report it) and
    the update's constants on its device: lr, the bias corrections, the
    clip scale (``None`` without a clip)."""
    scale = None
    if tcfg.grad_clip > 0:
        scale = torch.clamp(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            max=1.0)
    lr = warmup_cosine(step, tcfg.learning_rate, tcfg.warmup_steps,
                       tcfg.total_steps)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - tcfg.b1 ** t
    bc2 = 1.0 - tcfg.b2 ** t
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    return lr, (lr_t, bc1, bc2, scale)


def _adamw_blocks(state: TrainState, sums, tcfg: TrainConfig, mesh,
                  consts) -> TrainState:
    """AdamW on every position's shards from each leaf's gradient blocks
    at their owners (``sums``), with the weight decay of each whole leaf's
    reference ndim: each block scaled by the clip at its owner and sent to
    its other holders (``grad_send``), ``consts(pos)`` the update's
    constants (lr, bias corrections, clip scale) on ``pos``'s device; then
    the step counter. The state is updated in place."""
    leaves = tree_leaves(state.params)
    opt = state.opt
    with span("adamw"):
        for j, (p, ndim, m, v) in enumerate(zip(
                leaves, reference_ndims(state.params),
                tree_leaves(opt.m), tree_leaves(opt.v))):
            wd = tcfg.weight_decay if ndim >= 2 else 0.0
            for block, g in sums[j].items():
                holders = p.layout.holders(block)
                with mesh.at(holders[0]):
                    scale = consts(holders[0])[3]
                    if scale is not None:
                        g = g * scale.to(g.dtype)
                for pos in holders:
                    dev = mesh.device(pos)
                    if pos != holders[0]:
                        mesh.count("grad_send",
                                   g.numel() * g.element_size(),
                                   frm=holders[0], to=pos)
                    with mesh.at(pos):
                        c_lr, c_bc1, c_bc2, _ = consts(pos)
                        with mesh.moving():
                            g_pos = g.to(dev)
                        adamw_leaf(p.shards[pos], g_pos, m.shards[pos],
                                   v.shards[pos], c_lr, c_bc1, c_bc2,
                                   tcfg.b1, tcfg.b2, tcfg.eps, wd)
            sums[j] = None
    step_shards = []
    for pos, s in enumerate(opt.step.shards):
        with mesh.at(pos):
            step_shards.append(s + 1)
    new_step = ShardedTensor(opt.step.layout, opt.step.dtype,
                             step_shards)
    return TrainState(state.params, AdamWState(new_step, opt.m, opt.v))


def _tp2d_update(state: TrainState, sums, loss, tcfg: TrainConfig,
                 mesh) -> Tuple[TrainState, dict]:
    """The ``tp2d`` step's tail, from each leaf's summed gradient blocks
    (``sums``, at their owners): each position folds the squares of the
    blocks it owns (a replicated block once, at its first holder) into
    one f32 scalar, leaves in ``global_norm``'s order and each leaf's
    blocks in block order; the scalars are added over all the positions in
    ascending order at each of them (``norm_sum``: an all-reduce of 4-byte
    scalars), so every position holds the same norm; each position takes
    the clip scale, lr and the bias corrections from its own copy and its
    own step counter; then AdamW as :func:`_sharded_update`'s. On one
    position the norm is ``global_norm``'s, bit for bit."""
    leaves = tree_leaves(state.params)
    folds = [0] * mesh.size
    for x, blocks in zip(leaves, sums):
        for block in x.layout.blocks():
            owner = x.layout.holders(block)[0]
            with mesh.at(owner):
                folds[owner] = folds[owner] + torch.sum(
                    torch.square(blocks[block].float()))
    for pos in range(mesh.size):
        with mesh.at(pos):
            folds[pos] = torch.as_tensor(folds[pos], dtype=torch.float32,
                                         device=mesh.device(pos))
    per = []                    # (norm, lr, constants) at each position
    with span("norm_sum"):
        for pos in range(mesh.size):
            dev = mesh.device(pos)
            with mesh.at(pos), mesh.moving():
                got = []
                for q, f in enumerate(folds):
                    if q != pos:
                        mesh.count("norm_sum", 4, frm=q, to=pos)
                    got.append(f.to(dev))
            with mesh.at(pos):
                total = got[0]
                for f in got[1:]:
                    total = total + f
                gnorm = torch.sqrt(total)
                per.append((gnorm,) + _update_consts(
                    state.opt.step.shards[pos], gnorm, tcfg))
    new = _adamw_blocks(state, sums, tcfg, mesh, lambda pos: per[pos][2])
    return new, {"loss": loss, "grad_norm": per[0][0], "lr": per[0][1]}


def make_sharded_train_step(loss_fn: Callable, tcfg: TrainConfig, mesh,
                            state_specs, batch_spec,
                            microbatches: int = 1,
                            moe_span: Optional[Callable] = None) -> Callable:
    """The train step over ``mesh``: the counterpart of
    ``jax.jit(make_train_step(loss_fn, tcfg, microbatches=M),
    in_shardings=…)`` on a cell. ``step(state, *batch) → (state,
    metrics)`` takes a state placed by ``state_specs``
    (:func:`new_sharded_train_state`, or ``distrib.fault.reshard``) and
    whole batch tensors, and returns the state updated in place with
    ``loss``, ``grad_norm`` and ``lr`` on position 0's device.

    The batch splits as ``make_train_step`` splits it: microbatch i is rows
    i·B/M … (i+1)·B/M − 1. The axes of ``batch_spec[0]`` make D batch
    shards, and batch shard d holds rows d·B/D … (d+1)·B/D − 1 at its home
    position's device; M must divide by D or D by M. Each batch shard sees
    the parameters through :class:`~repro_torch.distrib.collectives.
    ShardView` s, which the model gathers layer by layer where it uses them
    (ZeRO-3: only the state is stored sharded).

    Where D divides M, each batch shard runs its M/D whole microbatches in
    order, autograd adding their gradients into its views. Where M divides
    D, microbatch i lies on the D/M consecutive shards that hold its rows
    (M = 1 is the reference cell's step), and they run it together: one
    forward over their homes, each on its own rows through its own views
    (``collectives.HomeViews``), the loss the microbatch's mean (each
    home's cross entropy sum and count, and the MoE aux loss's statistics,
    added over the homes: ``loss_sum``, ``moe_aux_sum``), and one backward
    from every home's loss, each seeded with 1 (the sums' backward is the
    identity, so the gradients are the mean's). Where a MoE group spans
    batch shards (``moe_span(B/M, S, D/M)``: the model's ``moe_span``, for
    a batch whose first tensor is (B, S)), each run of the shards it spans
    is computed at the run's first home over all the run's rows, which go
    there (``train_span``); a microbatch that is one such run is the model's
    plain loss at that home.

    Gradients are summed per block at each block's owner, over the batch
    shards in ascending order (``grad_psum``), and divided by M, as
    ``make_train_step`` divides; the losses are added at position 0 in
    microbatch order and divided by M. The clip's global norm gathers one
    leaf's gradient at a time and sums its squares in ``global_norm``'s
    leaf order, so it keeps that function's bits; AdamW then updates every
    position's shards, with the weight decay of each whole leaf's
    reference ndim.

    When M / D = 1 or D = 1, or a microbatch's shards are one run, the step
    is ``make_train_step(loss_fn, tcfg, microbatches=M)`` bit for bit (loss,
    grad norm, every gathered leaf): the sums run in the same order.
    Otherwise the sums run in another order, so the loss and gradients
    differ by rounding. The reference's ``act_spec`` splits each of M > 1
    microbatches over all of "data"; this step keeps whole microbatches
    per shard where D divides M (the same values, another rounding and
    per-shard peak)."""
    homes, groups = batch_groups(mesh, batch_spec[0] if len(batch_spec)
                                 else None)
    D, M = len(homes), microbatches
    if M % D and D % M:
        raise ValueError(f"{M} microbatches do not split over {D} batch "
                         f"shards, nor {D} batch shards into {M} "
                         f"microbatches")
    dev0 = mesh.device(0)

    def views_at(params, d):
        return tree_map(lambda x: ShardView(x, homes[d], groups[d]), params)

    def whole(state, split, sums):
        """Each batch shard's M/D microbatches: the shards' loss sums."""
        per, loss = M // D, None
        for d in range(D):
            home = mesh.device(homes[d])
            views = views_at(state.params, d)
            losses = []
            for i in range(d * per, (d + 1) * per):
                with mesh.at(homes[d]):
                    mb_loss = loss_fn(views, *tree_map(
                        lambda x: x[i].to(home), split))
                    # a send's backward moves the working position on
                    mb_loss.backward()
                losses.append(mb_loss.detach())
            with mesh.at(homes[d]):
                loss_d = losses[0]
                for mb_loss in losses[1:]:
                    loss_d = loss_d + mb_loss
            with mesh.at(0):
                loss_d = loss_d.to(dev0)
                loss = loss_d if loss is None else loss + loss_d
            _add_grads(mesh, views, sums)
            del views
        return loss

    def spread(state, mb, i, sums):
        """Microbatch ``mb`` over the D/M shards from i·D/M: its loss."""
        per = D // M
        first = i * per
        lead = tree_leaves(mb)[0]
        run = 1 if moe_span is None else moe_span(
            lead.shape[0], lead.shape[1], per)
        b = lead.shape[0] // per         # a shard's rows
        runs = list(range(first, first + per, run))
        views = [views_at(state.params, d) for d in runs]

        def rows(x, d):
            """The rows of the run from shard ``d`` at its home; the other
            shards' rows go there."""
            lo = (d - first) * b
            part = x[lo:lo + run * b]
            with span("train_span"), mesh.at(homes[d]), mesh.moving():
                for e in range(d + 1, d + run):
                    mesh.count("train_span", part[:b].numel()
                               * part.element_size(), frm=homes[e],
                               to=homes[d])
                return part.to(mesh.device(homes[d]))
        if len(runs) == 1:
            d = runs[0]
            with mesh.at(homes[d]):
                mb_loss = loss_fn(views[0], *tree_map(
                    lambda x: rows(x, d), mb))
                mb_loss.backward()
            loss = mb_loss.detach()
        else:
            at = [homes[d] for d in runs]
            params = tree_map(lambda *vs: HomeViews(vs, at, mesh), *views)
            args = [Rows([tree_map(lambda x: rows(x, d), a) for d in runs],
                         at, mesh) for a in mb]
            with mesh.at(at[0]):
                with mesh.charge_backward():
                    out = loss_fn(params, *args)
                torch.autograd.backward(out.parts)
            loss = out.parts[0].detach()
            del out, args, params
        for v in views:
            _add_grads(mesh, v, sums)
        with mesh.at(0):
            return loss.to(dev0)

    def step(state: TrainState, *batch) -> Tuple[TrainState, dict]:
        leaves = tree_leaves(state.params)
        for x in leaves:
            if not isinstance(x, ShardedTensor) or x.mesh is not mesh:
                raise ValueError("make_sharded_train_step: the state is "
                                 "not placed on the step's mesh")
        split = tree_map(lambda x: x.reshape(
            (microbatches, -1) + tuple(x.shape[1:])), batch)
        sums = [dict() for _ in leaves]  # block → summed gradient
        if M % D == 0:
            loss = whole(state, split, sums)
        else:
            loss = None
            for i in range(M):
                mb_loss = spread(state, tree_map(lambda x: x[i], split), i,
                                 sums)
                with mesh.at(0):
                    loss = mb_loss if loss is None else loss + mb_loss
        _zeros_where_unreached(mesh, leaves, sums)
        with mesh.at(0):
            loss = loss / microbatches
        for x, blocks in zip(leaves, sums):
            for block in blocks:
                with mesh.at(x.layout.holders(block)[0]):
                    blocks[block] = blocks[block] / microbatches
        return _sharded_update(state, sums, loss, tcfg, mesh)

    return step


def make_tp2d_train_step(loss_fn: Callable, tcfg: TrainConfig, mesh,
                         state_specs, batch_spec,
                         microbatches: int = 1) -> Callable:
    """The LM train step over ``mesh`` under the ``tp2d`` rules, split as the
    reference's partitioner splits ``jax.jit(make_train_step(model.loss,
    tcfg, microbatches=M), in_shardings=…)`` on a ``tp2d`` cell: Megatron
    over "model" × ZeRO over "data". ``step(state, tokens, labels) →
    (state, metrics)`` as :func:`make_sharded_train_step`'s.

    The batch splits as ``make_train_step`` splits it, into M microbatches
    along its leading axis (microbatch i: rows i·B/M … (i+1)·B/M − 1), and
    the step runs one round per microbatch, in order. In round i each of
    the D batch shards (``batch_spec[0]``'s axes) takes B/(M·D) of the
    microbatch's rows in batch order, at every position of its group
    (``act_spec``: the rows whole and the same at each position of a
    "model" group); B/M must divide by D. ``loss_fn`` gets a
    ``collectives.TPView`` of every leaf and the tokens and labels as
    ``Rows`` over all the positions, and returns the microbatch's loss at
    every position as Rows (``TransformerLM.loss``): each weight is
    gathered along "data" into the position's "model" block and multiplied
    there (``collectives.tp_linear``; so once a microbatch), the heads and
    the experts split over "model", a row block's partials and a column
    block's dX partials summed over "model"; the table is looked up where
    its blocks lie and the cross entropy taken per vocab block, each
    shard's token sums and counts added over "data" and divided once
    (``collectives.tp_vocab_xent``); the MoE groups are formed over the
    whole microbatch and its aux loss taken over all of them
    (``models/moe.py``; a group that spans batch shards is routed once over
    them, its backward through the same moves). The
    backward runs at once from the losses of the positions that collect
    gradients (the first of each batch shard's positions with a "model"
    coordinate), each seeded with 1 as ``make_train_step`` seeds each
    microbatch's: the loss's sums over "data" pass each position's
    gradient to its own partial, so the gradients are the microbatch
    mean's. A gathered block's gradient is reduce-scattered along "data"
    to its owner, a block read where it lies (norm weights, biases,
    experts) takes the gradient of each batch shard's collector, added at
    the block's owner in batch order (``grad_psum``); a leaf's gradients
    accumulate over the rounds. The sums are divided by M, the losses
    added at position 0 in microbatch order and divided by M, and the
    norm, clip and AdamW are :func:`_tp2d_update`'s: one scalar all-reduce
    for the norm, no gradient moved for it.

    On a mesh of one position the step is ``make_train_step(loss_fn,
    tcfg, microbatches=M)`` bit for bit (the model with ``act_spec``, so that the one-device loss is the
    vocab-parallel form). With more than one batch shard or "model"
    position the sums add in another order, so the loss and gradients
    differ by rounding."""
    homes, groups = batch_groups(mesh, batch_spec[0] if len(batch_spec)
                                 else None)
    D = len(homes)
    shard = {p: d for d, g in enumerate(groups) for p in g}
    positions = list(range(mesh.size))
    # the positions whose work collects gradients: the first of each batch
    # shard's positions with a "model" coordinate (the others repeat it)
    model = [mesh.coords(p).get("model", 0) for p in positions]
    seeds = [p for p in positions
             if p == next(q for q in groups[shard[p]] if model[q] == model[p])]

    def step(state: TrainState, *batch) -> Tuple[TrainState, dict]:
        leaves = tree_leaves(state.params)
        for x in leaves:
            if not isinstance(x, ShardedTensor) or x.mesh is not mesh:
                raise ValueError("make_tp2d_train_step: the state is not "
                                 "placed on the step's mesh")
        B = batch[0].shape[0]
        if B % microbatches or B // microbatches % D:
            raise ValueError(
                f"make_tp2d_train_step: a batch of {B} rows in "
                f"{microbatches} microbatches does not split over {D} "
                f"batch shards (B/M must divide by D)")
        b = B // microbatches // D           # a batch shard's rows a round
        split = [x.reshape((microbatches, -1) + tuple(x.shape[1:]))
                 for x in batch]
        views = tree_map(lambda x: TPView(x, groups), state.params)
        losses = []
        for i in range(microbatches):
            args = []
            for x in split:
                parts = []
                for p in positions:
                    lo = shard[p] * b
                    with mesh.at(p):
                        parts.append(x[i][lo:lo + b].to(mesh.device(p)))
                args.append(Rows(parts, positions, mesh))
            with mesh.at(0):
                with mesh.charge_backward():
                    out = loss_fn(views, *args)
                # each position's backward runs at the position
                torch.autograd.backward([out.parts[p] for p in seeds])
            # every position holds the microbatch's loss; position 0's
            losses.append(out.parts[0].detach())
            del out, args
        with mesh.at(0):
            loss = losses[0]
            for mb_loss in losses[1:]:
                loss = loss + mb_loss
            loss = loss / microbatches
        sums = _view_grads(mesh, tree_leaves(views))
        del views
        _zeros_where_unreached(mesh, leaves, sums)
        for x, blocks in zip(leaves, sums):
            for block in blocks:
                with mesh.at(x.layout.holders(block)[0]):
                    blocks[block] = blocks[block] / microbatches
        return _tp2d_update(state, sums, loss, tcfg, mesh)

    return step


def _view_grads(mesh, views):
    """Each leaf's gradient blocks at their owners (the first holder) from
    the ``TPView`` leaves of every holder: a gathered block's gradient is
    its owner's already; a block read where it lies has one term per batch
    shard, at that shard's collector, added at the owner in batch order,
    the first as it is (no zeros, so a −0.0 stays); a block no term
    reached is left out (:func:`_zeros_where_unreached`)."""
    sums = []
    with span("grad_psum"):
        for view in views:
            lay = view.x.layout
            blocks = {}
            for block in lay.blocks():
                holders = lay.holders(block)
                owner = holders[0]
                terms = sorted((view.shard[h], h) for h in holders
                               if view.leaves[h].grad is not None)
                total = None
                for _, h in terms:
                    g = view.leaves[h].grad
                    view.leaves[h].grad = None
                    if h != owner:
                        mesh.count("grad_psum",
                                   g.numel() * g.element_size(), frm=h,
                                   to=owner)
                    with mesh.at(owner):
                        with mesh.moving():
                            g = g.to(mesh.device(owner))
                        total = g if total is None else total + g
                if total is not None:
                    blocks[block] = total
            sums.append(blocks)
    return sums


def make_edge_sharded_train_step(loss_fn: Callable, tcfg: TrainConfig,
                                 mesh, state_specs, input_specs) -> Callable:
    """The train step of one graph whose edge arrays are split into blocks
    over ``mesh`` (the GNN cells): the counterpart of ``jax.jit(
    make_train_step(loss_fn, tcfg), in_shardings=(state_specs,
    input_specs))``. ``step(state, inputs) → (state, metrics)`` takes a
    state placed by ``state_specs`` (replicated parameters,
    :func:`new_sharded_train_state`) and inputs placed by ``input_specs``:
    the edge arrays split along their first axis over the batch axes of
    the first spec that splits one, one block per batch shard.

    A graph has one loss, so there are no microbatches: one forward and
    one backward run over every block's home. ``loss_fn`` gets a
    ``models.gnn.common.EdgeHomes`` — the homes and each home's own
    replica of the parameters, read through a ``ShardView`` of its group —
    and runs each block's edge work at its home and the node-level work and
    the loss at position 0 (``models/gnn/common.py``). The gradients of the
    homes' replicas are added in ascending home order at each leaf's owner;
    the norm, clip and AdamW are the tail of
    :func:`make_sharded_train_step`.

    With one edge block the step is ``make_train_step(loss_fn, tcfg)`` bit
    for bit (loss, grad norm, every leaf): the same ops in the same order.
    With more, the blocks' partial sums are added in block order (the
    reference's psum), not in one serial sum, so the loss and gradients
    differ by rounding."""
    axes = next((spec[0] for spec in input_specs
                 if spec is not None and len(spec) and spec[0] is not None),
                None)
    homes, groups = batch_groups(mesh, axes)

    def step(state: TrainState, inputs) -> Tuple[TrainState, dict]:
        leaves = tree_leaves(state.params)
        for x in leaves:
            if not isinstance(x, ShardedTensor) or x.mesh is not mesh:
                raise ValueError("make_edge_sharded_train_step: the state "
                                 "is not placed on the step's mesh")
        views = [tree_map(lambda x: ShardView(x, h, g), state.params)
                 for h, g in zip(homes, groups)]
        params = EdgeHomes(mesh, tuple(homes),
                           tuple(tree_map(local, v) for v in views))
        with mesh.at(0):
            with mesh.charge_backward():
                loss = loss_fn(params, inputs)
            loss.backward()
            loss = loss.detach()
        del params
        sums = [dict() for _ in leaves]  # block → summed gradient
        for v in views:
            _add_grads(mesh, v, sums)
        del views
        _zeros_where_unreached(mesh, leaves, sums)
        return _sharded_update(state, sums, loss, tcfg, mesh)

    return step


def _grad(p: torch.Tensor) -> torch.Tensor:
    """A leaf's gradient, zeros where the loss did not reach it."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


# -- the reference's layout (checkpoints) --------------------------------------

def _stored_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype a checkpoint stores ``t`` in (its own, or f32 where
    ``arrays.npz`` cannot hold it)."""
    return _host_array(t.detach().reshape(-1)[:0]).dtype


def _stack(layers: list, values: bool):
    """A list of per-layer trees as one tree of arrays stacked on a leading
    layer axis (zero-size arrays of the stored dtype when not ``values``)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers], values) for k in first}
    dtype = _stored_dtype(first)
    if not values:
        return np.empty((0,), dtype=dtype)
    out = np.empty((len(layers),) + tuple(first.shape), dtype=dtype)
    for i, t in enumerate(layers):
        out[i] = _host_array(t)
    return out


def stack_layers(tree, values: bool = True):
    """``tree`` (dicts, lists, named tuples of tensors) with numpy leaves,
    every ``"layers"`` list of per-layer dicts stacked on a leading axis:
    the reference's layout. With ``values=False`` the leaves are zero-size
    arrays of the stored dtype, a cheap ``like`` for
    ``Checkpointer.restore``."""
    if isinstance(tree, dict):
        return {k: (_stack(v, values) if k == "layers" and isinstance(v, list)
                    else stack_layers(v, values)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(stack_layers(x, values) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_layers(x, values) for x in tree)
    if not values:
        return np.empty((0,), dtype=_stored_dtype(tree))
    return _host_array(tree)


def load_stacked(state, tree) -> None:
    """Copy ``tree`` (the reference's layout, numpy or tensor leaves) into
    the tensors of ``state`` (the port's layout) in place, cast to each
    tensor's dtype."""
    with torch.no_grad():
        _load(state, tree, None)


def _load(node, src, layer) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "layers" and isinstance(v, list):
                for i, lay in enumerate(v):
                    _load(lay, src[k], i)
            else:
                _load(v, src[k], layer)
    elif isinstance(node, (list, tuple)):
        for x, s in zip(node, src):
            _load(x, s, layer)
    else:
        a = torch.as_tensor(np.asarray(src) if layer is None
                            else np.asarray(src)[layer])
        node.copy_(a.to(node.dtype).reshape(node.shape))
