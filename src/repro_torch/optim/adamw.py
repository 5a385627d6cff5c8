"""AdamW with global-norm clipping (PyTorch port of ``repro.optim.adamw``).

Moments are f32 whatever the parameter dtype; decoupled weight decay
applies to matrices only (``p.ndim >= 2``), counted in the reference's
layout: there the per-layer leaves are stacked on a leading layer axis, so
a layer's norm weight or bias, (d,) here, is (L, d) there and decays (the
reference's exclusion by ndim spares only the final norm); the update is
computed in f32 and written back in the parameter's dtype. A tree is
nested dicts, lists and named tuples with tensors at the leaves, taken in
the reference's ``jax.tree.leaves`` order (dict keys sorted).

The reference's train step donates its state to ``jit``, so XLA updates it
in place; here ``adamw_update`` writes the new parameters, m and v into the
given tensors (no second copy of the state on the card) and returns them.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, sequences and
    named tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]


def reference_ndims(tree, extra: int = 0) -> List[int]:
    """Each leaf's ndim in the reference's layout, in ``tree_leaves``
    order: leaves under a ``"layers"`` list carry the stacked layer axis."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in reference_ndims(
            tree[k], extra + (k == "layers" and isinstance(tree[k], list)))]
    if isinstance(tree, (list, tuple)):
        return [n for node in tree for n in reference_ndims(node, extra)]
    return [tree.dim() + extra]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), keeping the structure; ``None`` stays ``None``, as
    an empty subtree does under ``jax.tree.map``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    """Step 0 (int32 on the parameters' device) and zero f32 moments."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves, in leaf order, of each leaf's sum of
    squares in f32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[Any, AdamWState,
                                                  torch.Tensor]:
    """One AdamW step, the reference's arithmetic in the reference's order;
    ``params``, ``state.m`` and ``state.v`` are updated in place and
    returned with the new step and the gradients' global norm (before
    clipping)."""
    if grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    for p, ndim, g, m, v in zip(tree_leaves(params), reference_ndims(params),
                                tree_leaves(grads), tree_leaves(state.m),
                                tree_leaves(state.v)):
        # decoupled weight decay on matrices only (norms/bias by ndim, in
        # the reference's stacked layout)
        adamw_leaf(p, g, m, v, lr, bc1, bc2, b1, b2, eps,
                   weight_decay if ndim >= 2 else 0.0)
    return params, AdamWState(step, state.m, state.v), gnorm


@torch.no_grad()
def adamw_leaf(p, g, m, v, lr, bc1, bc2, b1: float, b2: float, eps: float,
               wd: float) -> None:
    """One leaf's AdamW update in place (``lr``, ``bc1``, ``bc2``: f32
    tensors on the leaf's device); elementwise, so a shard of a leaf
    updates to the bits of its slice of the whole leaf."""
    g = g.float()
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * torch.square(g))
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    pf = p.float()
    p.copy_((pf - lr * (u + wd * pf)).to(p.dtype))
