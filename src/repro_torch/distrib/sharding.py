"""Sharding rules per model family, and tensors placed on a mesh by them
(PyTorch port of ``repro.distrib.sharding``).

The rules are the reference's (its docstring has the posture):
  LM     — under ``tp2d`` every big matrix shards over both "data" (ZeRO)
           and "model" (Megatron TP); under ``fsdp`` (the train cell's
           default) the dense blocks shard over ("data", "model") on one
           dimension. Activations shard the batch over ("pod", "data").
  MoE    — expert weights shard the expert axis over "model" (EP) or the
           d_ff axis (TP) per ``MoEConfig.moe_shard``; EP under ``fsdp``.
  GNN    — parameters replicated.
  BST    — the item table row-shards over "model" for training and is
           replicated for serving.

A :class:`PartitionSpec` (``P``) is a tuple with one entry per leading
dimension: ``None``, an axis name, or a tuple of axis names (a one-name
tuple is that name, as JAX normalises it). The reference writes the LM
rules for its stacked layout (``layers/wq`` with a leading layer axis);
the port keeps one dict per layer, so each rule here gives the
reference's spec without its leading ``None``. The rules read only
``leaf.shape``: meta tensors (``device="meta"``, the counterpart of
``jax.eval_shape``) size a FULL config without allocating it.

Placement — the counterpart of ``jax.device_put(x, NamedSharding(mesh,
spec))`` — is :func:`device_put`: a :class:`ShardedTensor` keeps, for every
mesh position, the block of the tensor that position holds, on that
position's device. Dimension i with entry (a₁, a₂, …) splits into
|a₁|·|a₂|·… blocks, the first axis major; a position holds a copy
wherever the spec leaves an axis out. :func:`gather` is the inverse: the
blocks assembled in shard order, no arithmetic.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import BSTConfig, TransformerConfig


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per leading dimension ``None``, an
    axis name or a tuple of axis names; dimensions past its end are
    replicated."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else e[0] if len(e) == 1 else e
            norm.append(e)
        return super().__new__(cls, norm)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


P = PartitionSpec

# production mesh axis sizes (launch.mesh.make_production_mesh)
AXIS_SIZE = {"pod": 2, "data": 16, "model": 16}


def batch_axes(multi_pod: bool):
    """Mesh axes the global batch shards over."""
    return ("pod", "data") if multi_pod else ("data",)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _axes_size(entry) -> int:
    return math.prod(AXIS_SIZE[a] for a in entry_axes(entry))


def fit_spec(shape: Tuple[int, ...], spec: P) -> P:
    """Degrade a PartitionSpec until every dim divides its shard count.

    Published model dims are not all 256-divisible (e.g. qwen3 vocab
    151936, qwen2 d_ff 29568, smollm kv width 192): per dim, try the
    requested axes, then each single axis, then replicate."""
    fitted = []
    for i, entry in enumerate(spec):
        if entry is None or shape[i] % _axes_size(entry) == 0:
            fitted.append(entry)
            continue
        # prefer the largest single axis that divides (a stable sort: ties
        # keep the spec's order)
        candidates = sorted(entry_axes(entry), key=AXIS_SIZE.get,
                            reverse=True)
        for c in candidates:
            if shape[i] % AXIS_SIZE[c] == 0:
                fitted.append(c)
                break
        else:
            fitted.append(None)
    return P(*fitted)


def _map_named(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over a parameter tree, keeping its structure. The
    path joins dict keys with "/" and leaves out the index of a
    ``"layers"`` list, so every layer's leaf is named as the reference
    names its stacked leaf (``layers/moe/wg``)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, prefix) for v in tree]
    return fn(prefix, tree)


def _replicated(leaf) -> P:
    return P(*([None] * len(leaf.shape)))


# -- LM ------------------------------------------------------------------------

def lm_param_specs(params_shape: Any, cfg: TransformerConfig,
                   policy: str = "tp2d") -> Any:
    """PartitionSpec tree matching ``TransformerLM.init``'s structure.

    policy="tp2d": Megatron TP over "model" × ZeRO over "data" (decode and
    the reference's prefill default). policy="fsdp": pure ZeRO-3 — every
    large matrix shards over both axes on one dimension and is gathered
    per layer (the train cell's default); experts stay EP over "model".
    """
    if policy == "fsdp":
        rule = _lm_rule_fsdp
    else:
        moe_shard = cfg.moe.moe_shard if cfg.moe else "ffn"
        rule = lambda name, leaf: _lm_rule_tp2d(name, leaf, moe_shard)  # noqa: E731
    return _map_named(lambda name, leaf: fit_spec(tuple(leaf.shape),
                                                  rule(name, leaf)),
                      params_shape)


def _lm_rule_tp2d(name: str, leaf, moe_shard: str) -> P:
    if name == "embed":               # (V, d)
        return P("model", "data")
    if name == "head":                # (d, V): vocab-parallel loss head
        return P(None, ("data", "model"))
    if name == "ln_f":
        return P(None)
    if re.search(r"layers/(wq|wk|wv|wg|wu)$", name):   # (d, f*)
        return P("data", "model")
    if re.search(r"layers/(wo|wd)$", name):            # (f*, d)
        return P("model", "data")
    if re.search(r"layers/(bq|bk|bv)$", name):         # (H*hd,)
        return P("model")
    if re.search(r"layers/ln\d$", name):
        return P(None)
    if name.endswith("moe/router"):                    # (d, E)
        return P("data", None)
    if re.search(r"moe/(wg|wu)$", name):               # (E, d, f)
        if moe_shard == "expert":
            return P("model", None, None)
        return P(None, None, "model")
    if name.endswith("moe/wd"):                        # (E, f, d)
        if moe_shard == "expert":
            return P("model", None, None)
        return P(None, "model", None)
    if re.search(r"layers/(sg|su)$", name):            # shared experts
        return P("data", "model")
    if name.endswith("layers/sd"):
        return P("model", "data")
    return _replicated(leaf)


def _lm_rule_fsdp(name: str, leaf) -> P:
    both = ("data", "model")
    if name == "embed":                                # (V, d)
        return P(both, None)
    if name == "head":                                 # (d, V)
        return P(None, both)
    if re.search(r"layers/(wq|wk|wv|wg|wu|sg|su)$", name):  # (d, f)
        return P(None, both)
    if re.search(r"layers/(wo|wd|sd)$", name):         # (f, d)
        return P(both, None)
    if re.search(r"layers/(bq|bk|bv)$", name):         # (f,)
        return P(both)
    if name.endswith("moe/router"):                    # (d, E)
        return P(None, None)
    if re.search(r"moe/(wg|wu|wd)$", name):            # (E, ·, ·)
        return P("model", None, None)
    return _replicated(leaf)


def lm_cache_specs(multi_pod: bool, batch: int) -> P:
    """KV cache (L, B, S, KV, hd): shard B over the batch axes when it can
    be divided, otherwise shard the sequence axis; 'model' always takes a
    slice of S (flash-decoding layout)."""
    ba = batch_axes(multi_pod)
    n_batch_shards = 32 if multi_pod else 16
    if batch >= n_batch_shards:
        return P(None, ba, "model", None, None)
    return P(None, None, (*ba, "model"), None, None)


# -- GNN -----------------------------------------------------------------------

def gnn_param_specs(params_shape: Any) -> Any:
    return _map_named(lambda name, leaf: _replicated(leaf), params_shape)


# -- BST -----------------------------------------------------------------------

def bst_param_specs(params_shape: Any, cfg: BSTConfig,
                    serve: bool = False) -> Any:
    """Serving replicates the item table (lookups gather-local, no
    collective in the scoring dot); training row-shards it 16-way over
    "model" (a replicated table would all-reduce its gradient)."""
    def rule(name, leaf):
        if name == "item_emb":            # (n_items, e)
            return P(None, None) if serve else P("model", None)
        if name == "user_emb":            # (F, V, e)
            return P(None, "model", None)
        if name == "mlp_w0":              # widest MLP matrix
            return P(None, "model")
        return _replicated(leaf)

    return _map_named(lambda name, leaf: fit_spec(tuple(leaf.shape),
                                                  rule(name, leaf)),
                      params_shape)


# -- generic -------------------------------------------------------------------

def state_specs_like(param_specs: Any) -> Any:
    """TrainState(params, AdamWState(step, m, v)) spec tree."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.state import TrainState
    return TrainState(params=param_specs,
                      opt=AdamWState(step=P(), m=param_specs, v=param_specs))


def map_with_specs(fn: Callable[[Any, P], Any], tree, spec_tree):
    """``fn(leaf, spec)`` over a tree and its spec tree (same structure,
    a PartitionSpec at each leaf), keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, tree[k], spec_tree[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_specs(fn, t, s)
                            for t, s in zip(tree, spec_tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_specs(fn, t, s)
                          for t, s in zip(tree, spec_tree))
    return fn(tree, spec_tree)


# -- placement -----------------------------------------------------------------

class Layout:
    """Where each block of a ``shape`` tensor lies on ``mesh`` under
    ``spec``: per dimension the axes it splits over and the block count;
    per position the block index it holds."""

    def __init__(self, mesh, spec: P, shape: Sequence[int]):
        shape = tuple(int(n) for n in shape)
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec!r} has more entries than the "
                             f"{len(shape)} dims of {shape}")
        entries = tuple(spec) + (None,) * (len(shape) - len(spec))
        used = [a for e in entries for a in entry_axes(e)]
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec!r} uses a mesh axis twice")
        self.mesh, self.spec, self.shape = mesh, P(*entries), shape
        self.axes = [entry_axes(e) for e in entries]
        self.counts = [math.prod(mesh.axis_size(a) for a in axes)
                       for axes in self.axes]
        for n, c in zip(shape, self.counts):
            if n % c:
                raise ValueError(f"dim {n} of {shape} does not split into "
                                 f"{c} shards ({spec!r} on {mesh!r})")
        self.block_shape = tuple(n // c for n, c in zip(shape, self.counts))
        self._holders: Optional[Dict[Tuple[int, ...], List[int]]] = None

    def _by_block(self) -> Dict[Tuple[int, ...], List[int]]:
        """Block → its holders, ascending, in row-major block order (made
        once: a layout does not change)."""
        if self._holders is None:
            by: Dict[Tuple[int, ...], List[int]] = {}
            for pos in range(self.mesh.size):
                by.setdefault(self.block_of(pos), []).append(pos)
            self._holders = dict(sorted(by.items()))
        return self._holders

    def block_of(self, pos: int) -> Tuple[int, ...]:
        """The block position ``pos`` holds: per dimension the mixed-radix
        index of its coordinates on the dimension's axes, first major."""
        coords = self.mesh.coords(pos)
        out = []
        for axes in self.axes:
            i = 0
            for a in axes:
                i = i * self.mesh.axis_size(a) + coords[a]
            out.append(i)
        return tuple(out)

    def blocks(self) -> List[Tuple[int, ...]]:
        """Every block once, in row-major block order."""
        return list(self._by_block())

    def holders(self, block: Tuple[int, ...]) -> List[int]:
        """The positions that hold ``block``, ascending."""
        return list(self._by_block().get(tuple(block), ()))

    def slices(self, block: Tuple[int, ...]) -> Tuple[slice, ...]:
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(block, self.block_shape))


class ShardedTensor:
    """A tensor laid out over a mesh: ``shards[pos]`` is the block that
    position ``pos`` holds, on its device (replicas are separate copies,
    as each device of a JAX array holds its own)."""

    def __init__(self, layout: Layout, dtype: torch.dtype,
                 shards: List[torch.Tensor]):
        self.layout, self.dtype, self.shards = layout, dtype, shards

    @property
    def mesh(self):
        return self.layout.mesh

    @property
    def spec(self) -> P:
        return self.layout.spec

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.layout.shape)

    def dim(self) -> int:
        return len(self.layout.shape)

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.spec!r}, blocks {self.layout.block_shape})")


def device_put(x: torch.Tensor, mesh, spec: P) -> ShardedTensor:
    """``x`` split onto ``mesh`` by ``spec``: each position gets its own
    copy of its block, on its device."""
    lay = Layout(mesh, spec, x.shape)
    shards = []
    for pos in range(mesh.size):
        part = x[lay.slices(lay.block_of(pos))]
        shards.append(torch.empty(part.shape, dtype=x.dtype,
                                  device=mesh.device(pos)).copy_(part))
    return ShardedTensor(lay, x.dtype, shards)


def assemble(layout: Layout, parts: Dict[Tuple[int, ...], torch.Tensor],
             device, dtype) -> torch.Tensor:
    """The whole tensor from one tensor per block, on ``device``: each
    block copied into its slice, in shard order (on meta tensors, which
    hold no values, only the result is made)."""
    out = torch.empty(layout.shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for block in layout.blocks():
        out[layout.slices(block)].copy_(parts[block])
    return out


def gather(x: ShardedTensor, pos: int = 0,
           collective: Optional[str] = None) -> torch.Tensor:
    """The whole tensor on position ``pos``'s device, each block taken
    from the first position holding it; with ``collective``, the bytes of
    blocks that position does not hold are counted under that name."""
    lay = x.layout
    parts = {}
    for block in lay.blocks():
        holders = lay.holders(block)
        src = pos if pos in holders else holders[0]
        parts[block] = x.shards[src]
        if collective is not None and src != pos:
            x.mesh.count(collective, parts[block].numel()
                         * parts[block].element_size(), to=pos)
    return assemble(lay, parts, x.mesh.device(pos), x.dtype)


def sharded_zeros(mesh, spec: P, shape, dtype=torch.float32) -> ShardedTensor:
    """Zeros laid out by ``spec``, allocated shard by shard."""
    lay = Layout(mesh, spec, shape)
    return ShardedTensor(lay, dtype, [
        torch.zeros(lay.block_shape, dtype=dtype, device=mesh.device(p))
        for p in range(mesh.size)])


def position_bytes(tree) -> List[int]:
    """Bytes each mesh position holds of the ShardedTensor leaves of a
    tree."""
    from repro_torch.optim.adamw import tree_leaves
    leaves = [x for x in tree_leaves(tree) if isinstance(x, ShardedTensor)]
    if not leaves:
        return []
    out = [0] * leaves[0].mesh.size
    for x in leaves:
        for pos, s in enumerate(x.shards):
            out[pos] += s.numel() * s.element_size()
    return out
