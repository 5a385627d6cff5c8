"""Cells: one (architecture × input shape) pair → a step function
and its arguments (PyTorch port of the JAX package's
``repro.launch.cells``).

A :class:`Cell` bundles the model, ``step_fn(*args)`` (a train step for
the train shapes; prefill, decode, sigmoid or retrieval scores for the
serve shapes), ``args``, and for an LM cell ``in_shardings``: the spec
tree of the arguments under the reference's policies. Inputs are drawn by
:class:`ArgFactory` from ``numpy.random.default_rng(0)`` in the
reference's order, so a cell's inputs equal the reference's concrete
cell's bit for bit; weights come from ``torch.Generator(device)`` seeded
0 (random draws do not cross frameworks). ``smoke=True`` takes the
reference's reduced dims; ``smoke=False`` the shape's published dims, with
edge counts and ``retrieval_cand``'s candidates padded to a multiple of
512 as the reference pads them.

With ``concrete=False`` the arguments are meta tensors (the reference's
``ShapeDtypeStruct`` stand-ins: shapes and dtypes, nothing allocated),
which :func:`input_specs` returns. With a ``mesh`` every cell carries its
spec tree (``in_shardings``, the reference cell's); concrete arguments, or
meta ones on a meta mesh (``["meta"] * 256``, the dry run's), are placed
on it by those specs and the step is the sharded one: the LM and BST
train steps ``train.state.make_sharded_train_step`` (the LM's under
``REPRO_LM_POLICY=tp2d``: ``make_tp2d_train_step``), the GNN train step
``make_edge_sharded_train_step`` (the edge arrays split over the batch
axes), prefill and decode ``distrib.serving``'s, BST serving per batch
shard (retrieval per candidate block), the IGPM refresh
``core.rwr.label_rwr`` over the graph's arc blocks.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import (ArchConfig, BSTConfig, GNNConfig,
                                     IGPMConfig, TrainConfig,
                                     TransformerConfig)
from repro_torch.core.graph import DynamicGraph
from repro_torch.core.rwr import label_rwr
from repro_torch.distrib.serving import (make_sharded_click,
                                         make_sharded_decode,
                                         make_sharded_prefill,
                                         make_sharded_retrieval,
                                         place_params)
from repro_torch.distrib.sharding import (P, ShardedTensor, batch_axes,
                                          bst_param_specs, device_put,
                                          gnn_param_specs, lm_cache_specs,
                                          lm_param_specs, map_with_specs,
                                          state_specs_like)
from repro_torch.models.gnn.common import GraphInputs, make_model
from repro_torch.models.gnn.graphcast import mesh_sizes
from repro_torch.models.recsys.bst import BST, BSTInputs
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.adamw import tree_map
from repro_torch.sparse.ell import build_ell, ell_row_capacity
from repro_torch.train.state import (make_edge_sharded_train_step,
                                     make_sharded_train_step,
                                     make_tp2d_train_step,
                                     make_train_step, new_sharded_train_state,
                                     new_train_state)


class Cell(NamedTuple):
    arch_id: str
    shape_name: str
    kind: str
    model: Any
    step_fn: Callable
    args: Tuple[Any, ...]
    meta: dict
    in_shardings: Optional[Tuple[Any, ...]] = None


TCFG = TrainConfig()


class ArgFactory:
    """Concrete inputs drawn as the reference's ``_ArgFactory`` draws them:
    integers uniform in ``[0, max(high, 1))``, floats standard normal, in
    call order from one ``default_rng(seed)``; returned as tensors on
    ``device``."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape, dtype, high: int = 2) -> torch.Tensor:
        dtype = np.dtype(dtype)
        if np.issubdtype(dtype, np.integer):
            a = self.rng.integers(0, max(high, 1), size=shape).astype(dtype)
        else:
            a = self.rng.standard_normal(shape).astype(dtype)
        return torch.from_numpy(a).to(self.device)


def _factory(device, concrete: bool):
    """``fac(shape, dtype, high)``: an :class:`ArgFactory` on ``device``,
    or, with ``concrete=False``, meta tensors of that shape and dtype."""
    if concrete:
        return ArgFactory(device)

    def fac(shape, dtype, high: int = 2) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.from_numpy(
            np.zeros((), dtype)).dtype, device="meta")
    return fac


def _placed(mesh, concrete: bool) -> bool:
    """Whether a cell places its arguments on ``mesh`` and runs the sharded
    step: concrete arguments, or meta ones on a meta mesh (meta stand-ins
    on a mesh of real devices only carry the specs)."""
    return mesh is not None and (concrete or all(
        d.type == "meta" for d in mesh.devices))


def _generator(device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(0)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LM_SMOKE_DIMS = {
    "train_4k": {"seq_len": 32, "global_batch": 2},
    "prefill_32k": {"seq_len": 64, "global_batch": 1},
    "decode_32k": {"seq_len": 64, "global_batch": 2},
    "long_500k": {"seq_len": 128, "global_batch": 1},
}


def lm_cell(arch: ArchConfig, shape_name: str, device="cuda", mesh=None,
            multi_pod: bool = False, concrete: bool = True,
            smoke: bool = False) -> Cell:
    """An LM cell. Train: ``step_fn(state, tokens, labels)``; prefill:
    ``model.prefill(params, tokens)``; decode: ``model.decode_step(params,
    token, cache, cache_len)``. The batch shards over the batch axes when
    B ≥ their production shard count (16, 32 with ``multi_pod``), and only
    then does the model take ``act_spec``; train shards the parameters
    under ``REPRO_LM_POLICY`` and, placed on a mesh, runs the reference
    cell's one microbatch, its rows split over the batch shards (default
    ``fsdp``: ``make_sharded_train_step``, each layer gathered at each
    batch shard's home, the loss's sums and the MoE aux loss's statistics
    added over the homes, a MoE group that spans shards computed at its
    first shard's home; ``tp2d``: ``make_tp2d_train_step``, Megatron over
    "model" × ZeRO over "data"), prefill under
    ``REPRO_LM_PREFILL_POLICY`` (default ``fsdp``), decode under
    ``tp2d``, as the reference's cells do. Placed on a mesh, prefill and
    decode are ``distrib.serving``'s steps (the cache placed by
    ``lm_cache_specs``): under ``tp2d`` with the batch split (decode_32k,
    prefill_32k) as the reference's partitioner splits them (the column
    weights' "model" blocks gathered along "data", the rows moved to the
    row blocks and the head, the sums over "model"), with it whole
    (long_500k) every product where its weight blocks lie and no
    parameter moved; under ``fsdp`` each layer is gathered at each batch
    shard's home; decode takes ``cache_len`` as a Python int, its
    build-time value S // 2 where the tensor is a meta stand-in."""
    cfg: TransformerConfig = arch.model
    shape = arch.shape(shape_name)
    dims = LM_SMOKE_DIMS[shape.name] if smoke else shape.dims
    B, S = dims["global_batch"], dims["seq_len"]
    ba = batch_axes(multi_pod)
    n_batch_shards = (2 * 16) if multi_pod else 16
    wide = B >= n_batch_shards
    bspec = P(ba, None) if (wide or mesh is None) else P(None, None)
    act_spec = P(ba, None, None) if (mesh is not None and wide) else None
    model = TransformerLM(cfg, moe_group_size=min(4096, max(64, B * S // 8)),
                          act_spec=act_spec)
    dev = torch.device(device) if concrete else torch.device("meta")
    fac = ArgFactory(dev)
    gen = torch.Generator().manual_seed(0) if not concrete \
        else _generator(dev)

    def ints(shape_, high):
        if concrete:
            return fac(shape_, np.int32, high)
        return torch.empty(shape_, dtype=torch.int32, device=dev)

    if shape.kind == "train":
        params = model.init(gen, dtype=torch.float32, device=dev)
        tokens = ints((B, S), cfg.vocab_size)
        labels = ints((B, S), cfg.vocab_size)
        policy = os.environ.get("REPRO_LM_POLICY", "fsdp")
        specs = state_specs_like(lm_param_specs(params, cfg, policy))
        in_sh = None if mesh is None else (specs, bspec, bspec)
        meta = {"tokens_per_step": B * S}
        if _placed(mesh, concrete):
            # the reference cell's step: one microbatch, its rows split over
            # the batch shards
            if policy == "tp2d":
                step = make_tp2d_train_step(model.loss, TCFG, mesh, specs,
                                            bspec, microbatches=1)
            else:
                step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                               bspec, microbatches=1,
                                               moe_span=model.moe_span)
            meta["microbatches"] = 1
            state = new_sharded_train_state(params, mesh, specs)
        else:
            step = make_train_step(model.loss, TCFG)
            state = new_train_state(params)
        return Cell(arch.arch_id, shape.name, "train", model, step,
                    (state, tokens, labels), meta, in_sh)

    params = model.init(gen, dtype=torch.bfloat16, device=dev)
    if shape.kind == "prefill":
        tokens = ints((B, S), cfg.vocab_size)
        policy = os.environ.get("REPRO_LM_PREFILL_POLICY", "fsdp")
        pspec = lm_param_specs(params, cfg, policy=policy)
        in_sh = None if mesh is None else (pspec, bspec)
        step = model.prefill
        if _placed(mesh, concrete):
            params = place_params(params, mesh, pspec)
            step = make_sharded_prefill(model, mesh, bspec,
                                        lm_cache_specs(multi_pod, B),
                                        policy=policy)
        return Cell(arch.arch_id, shape.name, "prefill", model,
                    step, (params, tokens),
                    {"tokens_per_step": B * S}, in_sh)

    # decode (decode_32k / long_500k): one token against an S-long cache
    token = ints((B, 1), cfg.vocab_size)
    cache_shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    if concrete:   # standard-normal draws, rounded to the cache's bf16
        cache = tuple(fac(cache_shape, np.float32).to(torch.bfloat16)
                      for _ in range(2))
    else:
        cache = tuple(torch.empty(cache_shape, dtype=torch.bfloat16,
                                  device=dev) for _ in range(2))
    cache_len = torch.tensor(S // 2, dtype=torch.int32, device=dev)
    pspec = lm_param_specs(params, cfg)
    cspec = lm_cache_specs(multi_pod, B if mesh is not None else 0)
    in_sh = None if mesh is None else (pspec, bspec, (cspec, cspec), P())
    step = model.decode_step
    if _placed(mesh, concrete):
        params = place_params(params, mesh, pspec)
        cache = tuple(device_put(c, mesh, cspec) for c in cache)
        decode = make_sharded_decode(model, mesh, bspec)
        n = S // 2   # the length as a Python int: a meta tensor has no value

        def step(params, token, cache, cache_len):
            return decode(params, token, cache,
                          n if cache_len.is_meta else int(cache_len))
    return Cell(arch.arch_id, shape.name, "decode", model,
                step, (params, token, cache, cache_len),
                {"tokens_per_step": B, "kv_tokens": B * S}, in_sh)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_SMOKE_DIMS = {
    "full_graph_sm": {"n_nodes": 64, "n_edges": 256, "d_feat": 32},
    "minibatch_lg": {"n_nodes": 80, "n_edges": 72, "batch_nodes": 8,
                     "fanout1": 3, "fanout2": 2, "d_feat": 16},
    "ogb_products": {"n_nodes": 128, "n_edges": 512, "d_feat": 16},
    "molecule": {"n_nodes": 8, "n_edges": 12, "batch": 4, "d_feat": 8},
}


def pad512(x: int) -> int:
    """Round up to a multiple of 512 (= 2×16×16 mesh shards), as the
    reference pads sharded index arrays; pad entries would carry the
    out-of-range id n, whose gathers clamp and whose scatters
    ``segment_sum`` drops."""
    return -(-x // 512) * 512


def gnn_cell_sizes(shape_name: str, dims: dict,
                   padded: bool = False) -> Tuple[int, int]:
    """(N, E) of the tensor program for one GNN shape (block vs full graph)."""
    if shape_name == "minibatch_lg":
        b, f1, f2 = dims["batch_nodes"], dims["fanout1"], dims["fanout2"]
        n = b * (1 + f1 + f1 * f2)
        e = b * f1 + b * f1 * f2
    elif shape_name == "molecule":
        b = dims["batch"]
        n, e = b * dims["n_nodes"], 2 * b * dims["n_edges"]
    else:
        n, e = dims["n_nodes"], dims["n_edges"]
    return n, (pad512(e) if padded else e)


def gnn_cell(arch: ArchConfig, shape_name: str, device="cuda", mesh=None,
             multi_pod: bool = False, concrete: bool = True,
             smoke: bool = False) -> Cell:
    """A GNN train cell: ``step_fn(state, inputs)``. The parameters are
    replicated; with a mesh the senders and receivers (DimeNet's triplets
    too, GraphCast's mesh arcs but not its grid↔mesh maps) split over the
    batch axes, ``P(ba)``, and the node tables are replicated, as the
    reference's cell lays them out. Placed, the step is
    ``make_edge_sharded_train_step``; otherwise ``make_train_step(
    model.loss, TrainConfig())``."""
    cfg: GNNConfig = arch.model
    shape = arch.shape(shape_name)
    dims = GNN_SMOKE_DIMS[shape.name] if smoke else shape.dims
    N, E = gnn_cell_sizes(shape.name, dims, padded=not smoke)
    d_feat = dims["d_feat"]
    ba = batch_axes(multi_pod)
    fac = _factory(device, concrete)
    model = make_model(cfg)

    fields = {
        "node_feat": (fac((N, d_feat), np.float32), P(None, None)),
        "senders": (fac((E,), np.int32, N), P(ba)),
        "receivers": (fac((E,), np.int32, N), P(ba)),
        "targets": (fac((N, cfg.d_out), np.float32), P(None, None)),
    }
    if cfg.kind in ("schnet", "dimenet"):
        fields["positions"] = (fac((N, 3), np.float32), P(None, None))
    if cfg.kind == "dimenet":
        T = E * cfg.triplets_per_edge
        fields["trip_kj"] = (fac((T,), np.int32, E), P(ba))
        fields["trip_ji"] = (fac((T,), np.int32, E), P(ba))
    if cfg.kind == "graphcast":
        msz = mesh_sizes(cfg.mesh_refinement)
        # mesh arcs replace the data-graph arcs as senders/receivers; the
        # grid↔mesh maps are as long as the grid → replicated
        ma, mn = msz["mesh_arcs"], msz["mesh_nodes"]
        fields["senders"] = (fac((ma,), np.int32, mn), P(ba))
        fields["receivers"] = (fac((ma,), np.int32, mn), P(ba))
        fields["trip_kj"] = (fac((N * model.G2M,), np.int32, mn), P(None))
        fields["trip_ji"] = (fac((N * model.M2G,), np.int32, mn), P(None))
    inputs = GraphInputs(**{k: v[0] for k, v in fields.items()})
    ispecs = GraphInputs(**{k: v[1] for k, v in fields.items()})

    dev = torch.device(device) if concrete else torch.device("meta")
    gen = _generator(dev) if concrete else torch.Generator().manual_seed(0)
    params = model.init(gen, d_feat=d_feat, device=dev)
    specs = state_specs_like(gnn_param_specs(params))
    in_sh = None if mesh is None else (specs, ispecs)
    if _placed(mesh, concrete):
        inputs = tree_map(lambda x, s: device_put(x, mesh, s), inputs,
                          ispecs)
        state = new_sharded_train_state(params, mesh, specs)
        step = make_edge_sharded_train_step(model.loss, TCFG, mesh, specs,
                                            ispecs)
    else:
        state = new_train_state(params)
        step = make_train_step(model.loss, TCFG)
    return Cell(arch.arch_id, shape.name, "train", model, step,
                (state, inputs), {"n_nodes": N, "n_edges": E}, in_sh)


# ---------------------------------------------------------------------------
# BST (recsys) cells
# ---------------------------------------------------------------------------

BST_SMOKE_DIMS = {
    "train_batch": {"batch": 8},
    "serve_p99": {"batch": 4},
    "serve_bulk": {"batch": 16},
    "retrieval_cand": {"batch": 1, "n_candidates": 128},
}


def bst_cell(arch: ArchConfig, shape_name: str, device="cuda", mesh=None,
             multi_pod: bool = False, concrete: bool = True,
             smoke: bool = False) -> Cell:
    """A BST cell: ``train_batch`` → ``step_fn(state, inputs)``, the train
    step; ``retrieval_cand`` → ``step_fn(params, inputs, cand_items,
    cand_cates)``, the (B, C) scores; the other serve shapes →
    ``step_fn(params, inputs)``, the click probabilities. The labels are
    standard-normal draws, as the reference's (``fac((B,), f32)``).

    The specs are the reference's: training row-shards the item table over
    "model" (``bst_param_specs``), serving replicates it; the batch splits
    over the batch axes when B ≥ their production shard count (16, 32 with
    ``multi_pod``), and ``retrieval_cand``'s candidates always do. Placed,
    ``train_batch`` is ``make_sharded_train_step`` at the reference cell's
    one microbatch, its rows split over the batch shards (each home's loss
    sum and count added over the homes); a serve shape runs the forward per batch shard at its
    home and joins the probabilities at position 0; ``retrieval_cand``
    computes the user at position 0, sends it to each candidate block's
    home, which scores its block, and joins the scores at position 0."""
    cfg: BSTConfig = arch.model
    shape = arch.shape(shape_name)
    dims = BST_SMOKE_DIMS[shape.name] if smoke else shape.dims
    B = dims["batch"]
    ba = batch_axes(multi_pod)
    n_batch_shards = (2 * 16) if multi_pod else 16
    wide = B >= n_batch_shards or mesh is None
    b1 = P(ba) if wide else P(None)
    b2 = P(ba, None) if wide else P(None, None)
    fac = _factory(device, concrete)
    model = BST(cfg)

    inputs = BSTInputs(
        item_hist=fac((B, cfg.seq_len), np.int32, cfg.n_items),
        cate_hist=fac((B, cfg.seq_len), np.int32, cfg.n_cates),
        target_item=fac((B,), np.int32, cfg.n_items),
        target_cate=fac((B,), np.int32, cfg.n_cates),
        user_feats=fac((B, cfg.n_user_feats), np.int32, cfg.user_feat_vocab),
        labels=fac((B,), np.float32))
    ispecs = BSTInputs(b2, b2, b1, b1, b2, b1)

    dev = torch.device(device) if concrete else torch.device("meta")
    gen = _generator(dev) if concrete else torch.Generator().manual_seed(0)
    params = model.init(gen, device=dev)
    placed = _placed(mesh, concrete)
    if shape.name == "train_batch":
        specs = state_specs_like(bst_param_specs(params, cfg))
        in_sh = None if mesh is None else (specs, ispecs)
        meta = {"batch": B}
        if placed:
            # the reference cell's one microbatch, its rows split over the
            # batch shards, as the LM train cell
            step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                           b2, microbatches=1)
            state = new_sharded_train_state(params, mesh, specs)
            meta["microbatches"] = 1
        else:
            step = make_train_step(model.loss, TCFG)
            state = new_train_state(params)
        return Cell(arch.arch_id, shape.name, "train", model, step,
                    (state, inputs), meta, in_sh)

    pspec = bst_param_specs(params, cfg, serve=True)
    if placed:
        params = place_params(params, mesh, pspec)
    if shape.name == "retrieval_cand":
        C = dims["n_candidates"] if smoke else pad512(dims["n_candidates"])
        cand_i = fac((C,), np.int32, cfg.n_items)
        cand_c = fac((C,), np.int32, cfg.n_cates)
        cspec = P(ba) if mesh is not None else P(None)
        in_sh = None if mesh is None else (pspec, ispecs, cspec, cspec)
        step = model.retrieval_scores
        if placed:
            step = make_sharded_retrieval(model, mesh, cspec)
        return Cell(arch.arch_id, shape.name, "serve", model, step,
                    (params, inputs, cand_i, cand_c),
                    {"batch": B, "candidates": C}, in_sh)

    def serve(params, inputs):
        return torch.sigmoid(model.forward(params, inputs))

    in_sh = None if mesh is None else (pspec, ispecs)
    if placed:
        serve = make_sharded_click(model, mesh, b1)
    return Cell(arch.arch_id, shape.name, "serve", model, serve,
                (params, inputs), {"batch": B}, in_sh)


# ---------------------------------------------------------------------------
# IGPM (the paper's own system) — the label-RWR refresh at Table III sizes
# ---------------------------------------------------------------------------

IGPM_SMOKE_DIMS = {"n_vertices": 64, "n_edges": 256}


class IgpmRefresh:
    """The IGPM cell's step, ``step(graph, r0) → r_lab`` (n, L): the
    incremental label-RWR refresh, ``cfg.rwr_iters_incremental`` sweeps
    warm-started from ``r0`` (the reference's ``rwr_refresh``).

    Without a mesh: on the CPU and on meta tensors the COO sweep
    (``index_add_``); on the card ``index_add_`` adds with float atomics,
    which the port's deterministic sums forbid, so the sweep goes through
    an ELL mirror of the arcs (``ell_width`` wide) and the ELL kernel.
    With a mesh (the graph placed by the cell's specs) the sweeps run over
    the arc blocks (``core.rwr``), on the card with one mirror per block.
    A mirror is built on the host at the first refresh of a graph and
    kept while the graph's arc tensors are the same objects with the same
    version counters (an edit in place bumps them, and the next refresh
    builds anew); :meth:`mirrors` builds it ahead, and times apart."""

    def __init__(self, cfg: IGPMConfig):
        self.cfg = cfg
        self._arcs = ()
        self._versions = ()
        self._mirrors = None

    def mirrors(self, g: DynamicGraph):
        """The ELL mirror (one per arc block on a mesh) of ``g``'s live
        arcs, on the card; ``None`` off the card."""
        sharded = isinstance(g.senders, ShardedTensor)
        arcs = (g.senders, g.receivers, g.edge_mask)
        if sharded:
            arcs = tuple(s for t in arcs for s in t.shards)
        if arcs[0].device.type != "cuda":
            return None
        versions = tuple(t._version for t in arcs)
        if (len(arcs) != len(self._arcs) or versions != self._versions
                or any(a is not b for a, b in zip(arcs, self._arcs))):
            k = self.cfg.ell_width
            if sharded:
                lay = g.senders.layout
                homes = [lay.holders(b)[0] for b in lay.blocks()]
                self._mirrors = [self._mirror(
                    g.senders.shards[h], g.receivers.shards[h],
                    g.edge_mask.shards[h], g.n_max, k) for h in homes]
            else:
                self._mirrors = self._mirror(g.senders, g.receivers,
                                             g.edge_mask, g.n_max, k)
            self._arcs, self._versions = arcs, versions
        return self._mirrors

    @staticmethod
    def _mirror(senders, receivers, edge_mask, n: int, k: int):
        em = edge_mask.cpu().numpy()
        s = senders.cpu().numpy()[em]
        r = receivers.cpu().numpy()[em]
        # rows owned by receivers, columns the senders: the sweep's gather
        return build_ell(r, s, n, k=k,
                         r_cap=ell_row_capacity(n, int(em.size), k),
                         device=senders.device)

    def __call__(self, g: DynamicGraph, r0: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if isinstance(r0, ShardedTensor):
            r0 = r0.shards[0]    # replicated: position 0, block 0's home
        return label_rwr(g, cfg.n_labels, iters=cfg.rwr_iters_incremental,
                         c=cfg.restart_prob, r0=r0, ell=self.mirrors(g))


def igpm_cell(arch: ArchConfig, shape_name: str, device="cuda", mesh=None,
              multi_pod: bool = False, concrete: bool = True,
              smoke: bool = False) -> Cell:
    """The label-RWR refresh — IGPM's data-plane hot loop — at the
    published Table III sizes: n vertices and e = pad512(2 · edges) arcs
    (``smoke``: 64 and 512), drawn as the reference draws them (senders,
    receivers, labels, a standard-normal ``degree``, ``n_edges``, ``r0``;
    every arc and vertex live). With a mesh the arcs split over the batch
    axes, ``P(ba)``, and the vertex arrays and ``r0`` are replicated."""
    cfg: IGPMConfig = arch.model
    shape = arch.shape(shape_name)
    dims = IGPM_SMOKE_DIMS if smoke else shape.dims
    n = dims["n_vertices"]
    e = 2 * dims["n_edges"]
    e = e if smoke else pad512(e)
    L = cfg.n_labels
    dev = torch.device(device) if concrete else torch.device("meta")
    fac = _factory(dev, concrete)

    senders = fac((e,), np.int32, n)
    receivers = fac((e,), np.int32, n)
    edge_mask = torch.ones((e,), dtype=torch.bool, device=dev)
    labels = fac((n,), np.int32, L)
    node_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    degree = fac((n,), np.float32)
    n_edges = fac((), np.int32)
    graph = DynamicGraph(senders, receivers, edge_mask, labels, node_mask,
                         degree, n_edges)
    r0 = fac((n, L), np.float32)

    ba = batch_axes(multi_pod)
    gspec = DynamicGraph(P(ba), P(ba), P(ba), P(None), P(None), P(None), P())
    rspec = P(None, None)
    in_sh = None if mesh is None else (gspec, rspec)
    if _placed(mesh, concrete):
        graph = map_with_specs(lambda x, s: device_put(x, mesh, s), graph,
                               gspec)
        r0 = device_put(r0, mesh, rspec)
    return Cell(arch.arch_id, shape.name, "stream", None, IgpmRefresh(cfg),
                (graph, r0), {"n_nodes": n, "n_edges": e,
                              "rwr_iters": cfg.rwr_iters_incremental,
                              "n_labels": L}, in_sh)


def build_cell(arch: ArchConfig, shape_name: str, device="cuda",
               smoke: bool = False, mesh=None, multi_pod: bool = False,
               concrete: bool = True) -> Cell:
    cells = {"lm": lm_cell, "igpm": igpm_cell, "gnn": gnn_cell,
             "recsys": bst_cell}
    if arch.family not in cells:
        raise ValueError(f"no cells here for family {arch.family!r}")
    return cells[arch.family](arch, shape_name, device, mesh, multi_pod,
                              concrete, smoke)


def input_specs(arch: ArchConfig, shape_name: str, mesh=None,
                multi_pod: bool = False) -> Tuple[Any, ...]:
    """Meta-tensor stand-ins for every model input of a cell (the
    reference's ``ShapeDtypeStruct`` dry-run contract; placed on ``mesh``
    when one is given)."""
    return build_cell(arch, shape_name, mesh=mesh, multi_pod=multi_pod,
                      concrete=False).args
