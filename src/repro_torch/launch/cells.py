"""Cell builder for the GNN and BST archs: one (architecture × input
shape) pair → a step function and its concrete arguments on one device
(the concrete part of the JAX package's ``repro.launch.cells``).

A :class:`Cell` bundles the model, ``step_fn(*args)`` (a train step for
the train shapes; sigmoid scores or retrieval scores for BST's serve
shapes) and ``args``, tensors on the requested device. Inputs are drawn
by :class:`ArgFactory` from ``numpy.random.default_rng(0)`` in the
reference's order, so a cell's inputs equal the reference's concrete
cell's bit for bit; weights come from ``torch.Generator(device)`` seeded
0 (random draws do not cross frameworks). ``smoke=True`` takes the
reference's reduced dims; ``smoke=False`` the shape's published dims, with
edge counts and ``retrieval_cand``'s candidates padded to a multiple of
512 as the reference pads them.

The reference's shardings (``in_shardings`` over the production mesh),
its ``ShapeDtypeStruct`` stand-ins and the dry-run that lowers them wait
for ROADMAP item 13.5 (the distributed layers); the LM train cell lives in
``repro_torch.launch.train`` (``lm_train_cell``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.config.base import (ArchConfig, BSTConfig, GNNConfig,
                                     TrainConfig)
from repro_torch.models.gnn.common import GraphInputs, make_model
from repro_torch.models.gnn.graphcast import mesh_sizes
from repro_torch.models.recsys.bst import BST, BSTInputs
from repro_torch.train.state import make_train_step, new_train_state


class Cell(NamedTuple):
    arch_id: str
    shape_name: str
    kind: str
    model: Any
    step_fn: Callable
    args: Tuple[Any, ...]
    meta: dict


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


def _generator(device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(0)


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


def gnn_cell(arch: ArchConfig, shape_name: str, device="cuda",
             smoke: bool = False) -> Cell:
    """A GNN train cell: ``step_fn(state, inputs)`` is
    ``make_train_step(model.loss, TrainConfig())``."""
    cfg: GNNConfig = arch.model
    shape = arch.shape(shape_name)
    dims = GNN_SMOKE_DIMS[shape.name] if smoke else shape.dims
    N, E = gnn_cell_sizes(shape.name, dims, padded=not smoke)
    d_feat = dims["d_feat"]
    fac = ArgFactory(device)
    model = make_model(cfg)

    fields = {
        "node_feat": fac((N, d_feat), np.float32),
        "senders": fac((E,), np.int32, N),
        "receivers": fac((E,), np.int32, N),
        "targets": fac((N, cfg.d_out), np.float32),
    }
    if cfg.kind in ("schnet", "dimenet"):
        fields["positions"] = fac((N, 3), np.float32)
    if cfg.kind == "dimenet":
        T = E * cfg.triplets_per_edge
        fields["trip_kj"] = fac((T,), np.int32, E)
        fields["trip_ji"] = fac((T,), np.int32, E)
    if cfg.kind == "graphcast":
        msz = mesh_sizes(cfg.mesh_refinement)
        # mesh arcs replace the data-graph arcs as senders/receivers
        ma, mn = msz["mesh_arcs"], msz["mesh_nodes"]
        fields["senders"] = fac((ma,), np.int32, mn)
        fields["receivers"] = fac((ma,), np.int32, mn)
        fields["trip_kj"] = fac((N * model.G2M,), np.int32, mn)
        fields["trip_ji"] = fac((N * model.M2G,), np.int32, mn)
    inputs = GraphInputs(**fields)

    state = new_train_state(model.init(_generator(device), d_feat=d_feat))
    step = make_train_step(model.loss, TCFG)
    return Cell(arch.arch_id, shape.name, "train", model, step,
                (state, inputs), {"n_nodes": N, "n_edges": E})


# ---------------------------------------------------------------------------
# BST (recsys) cells
# ---------------------------------------------------------------------------

BST_SMOKE_DIMS = {
    "train_batch": {"batch": 8},
    "serve_p99": {"batch": 4},
    "serve_bulk": {"batch": 16},
    "retrieval_cand": {"batch": 1, "n_candidates": 128},
}


def bst_cell(arch: ArchConfig, shape_name: str, device="cuda",
             smoke: bool = False) -> Cell:
    """A BST cell: ``train_batch`` → ``step_fn(state, inputs)``, the train
    step; ``retrieval_cand`` → ``step_fn(params, inputs, cand_items,
    cand_cates)``, the (B, C) scores; the other serve shapes →
    ``step_fn(params, inputs)``, the click probabilities. The labels are
    standard-normal draws, as the reference's (``fac((B,), f32)``)."""
    cfg: BSTConfig = arch.model
    shape = arch.shape(shape_name)
    dims = BST_SMOKE_DIMS[shape.name] if smoke else shape.dims
    B = dims["batch"]
    fac = ArgFactory(device)
    model = BST(cfg)

    inputs = BSTInputs(
        item_hist=fac((B, cfg.seq_len), np.int32, cfg.n_items),
        cate_hist=fac((B, cfg.seq_len), np.int32, cfg.n_cates),
        target_item=fac((B,), np.int32, cfg.n_items),
        target_cate=fac((B,), np.int32, cfg.n_cates),
        user_feats=fac((B, cfg.n_user_feats), np.int32, cfg.user_feat_vocab),
        labels=fac((B,), np.float32))

    params = model.init(_generator(device))
    if shape.name == "train_batch":
        step = make_train_step(model.loss, TCFG)
        return Cell(arch.arch_id, shape.name, "train", model, step,
                    (new_train_state(params), inputs), {"batch": B})

    if shape.name == "retrieval_cand":
        C = dims["n_candidates"] if smoke else pad512(dims["n_candidates"])
        cand_i = fac((C,), np.int32, cfg.n_items)
        cand_c = fac((C,), np.int32, cfg.n_cates)
        return Cell(arch.arch_id, shape.name, "serve", model,
                    model.retrieval_scores, (params, inputs, cand_i, cand_c),
                    {"batch": B, "candidates": C})

    def serve(params, inputs):
        return torch.sigmoid(model.forward(params, inputs))

    return Cell(arch.arch_id, shape.name, "serve", model, serve,
                (params, inputs), {"batch": B})


def build_cell(arch: ArchConfig, shape_name: str, device="cuda",
               smoke: bool = False) -> Cell:
    if arch.family == "gnn":
        return gnn_cell(arch, shape_name, device, smoke)
    if arch.family == "recsys":
        return bst_cell(arch, shape_name, device, smoke)
    raise ValueError(f"no cells here for family {arch.family!r}")
