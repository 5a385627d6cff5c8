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

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _host_array
from repro_torch.config.base import TrainConfig
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
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
