"""BST — Behavior Sequence Transformer (Chen et al., arXiv:1905.06874);
PyTorch port of ``repro.models.recsys.bst``.

Assigned config: embed_dim=32, seq_len=20, 1 transformer block, 8 heads,
MLP 1024-512-256, leaky-ReLU. The user behavior sequence (item + category
embeddings + learned position) and the target item run through the
transformer block (``models/layers.py:dense_attention``, not causal, as in
the reference); the output concatenates with user-profile feature
embeddings into the scoring MLP. ``retrieval_scores`` is the
retrieval_cand path: one user embedding dotted against 10⁶ candidate
embeddings (one ``torch.matmul``, as the reference's XLA product).

The lookups are advanced indexing with ``jnp.take``'s semantics
(:func:`take_rows`, :func:`take_along_fields`), whose backward is an
accumulating ``index_put_`` that CUDA runs sorted — not ``index_select``
or ``torch.gather``, whose CUDA backwards add with atomics — so two
backward passes on the card give the same bits. Parameters are f32; keep
TF32 off (PyTorch's default for matmuls) so that the card and the CPU
agree in f32.

On a mesh the parameters come as ``ShardView`` s (the sharded train and
serving steps). Every lookup goes through :func:`lookup_rows` /
:func:`lookup_fields`: on a view of a table split along its rows (the
trained item table) or its vocab axis (the user tables) the rows are
looked up where they lie (``ShardView.take_rows`` /
``take_along_fields``), so the item table is never gathered whole; in
the train step ``mlp_w0``, split by columns, stays where its blocks lie
with the product of ``mlp_w1`` after it
(``distrib.collectives.column_row_product``); every other leaf is read
whole at the batch shard's home (``distrib.collectives.local``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.config.base import BSTConfig
from repro_torch.distrib.collectives import (Rows, ShardView, batch_mean,
                                             column_row_product, each_home,
                                             local)
from repro_torch.models import layers as L
from repro_torch.optim.adamw import tree_map
from repro_torch.sparse.segment import take_along_fields, take_rows


class BSTInputs(NamedTuple):
    item_hist: torch.Tensor   # int32 (B, S)
    cate_hist: torch.Tensor   # int32 (B, S)
    target_item: torch.Tensor  # int32 (B,)
    target_cate: torch.Tensor  # int32 (B,)
    user_feats: torch.Tensor  # int32 (B, F)
    labels: torch.Tensor      # f32 (B,) click labels


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: x where x ≥ 0 (so its gradient at 0 is 1)."""
    return torch.where(x >= 0, x, slope * x)


def splits_columns(w) -> bool:
    """Whether ``w`` is a train step's view of a 2-D weight split by
    columns only (BST's ``mlp_w0`` on a mesh, P(None, "model")): its
    blocks then stay where they lie (``collectives.column_row_product``).
    The serving steps' views (no gradient) read it whole, as before."""
    return (isinstance(w, ShardView) and w.grad
            and len(w.x.layout.counts) == 2
            and w.x.layout.counts[0] == 1 and w.x.layout.counts[1] > 1)


def lookup_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """``take_rows`` of a table, or of a ``ShardView`` where its rows lie."""
    if isinstance(table, ShardView):
        return table.take_rows(ids)
    return take_rows(table, ids)


def lookup_fields(tables, ids: torch.Tensor) -> torch.Tensor:
    """``take_along_fields`` of (F, V, e) tables, or of a ``ShardView``
    where their rows lie."""
    if isinstance(tables, ShardView):
        return tables.take_along_fields(ids)
    return take_along_fields(tables, ids)


class BST:
    def __init__(self, cfg: BSTConfig):
        self.cfg = cfg
        self.d_model = 2 * cfg.embed_dim  # item ⊕ category per position

    def init(self, gen: torch.Generator, device=None) -> Dict[str, Any]:
        """f32 weights on ``device`` (default: the generator's; ``"meta"``
        draws nothing), with the reference's shapes and scales (the draws
        themselves are torch's)."""
        cfg = self.cfg
        d = self.d_model
        e = cfg.embed_dim
        dev = gen.device if device is None else device

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev) * 0.02

        def linear(a, b):
            return L.init_linear(gen, a, b, device=dev)

        p: Dict[str, Any] = {
            "item_emb": normal(cfg.n_items, e),
            "cate_emb": normal(cfg.n_cates, e),
            "pos_emb": normal(cfg.seq_len + 1, d),
            "user_emb": normal(cfg.n_user_feats, cfg.user_feat_vocab, e),
            "ln1": torch.ones((d,), device=dev),
            "ln2": torch.ones((d,), device=dev),
        }
        for i in range(cfg.n_blocks):
            p[f"blk{i}"] = {
                "wq": linear(d, d),
                "wk": linear(d, d),
                "wv": linear(d, d),
                "wo": linear(d, d),
                "w1": linear(d, 4 * d),
                "w2": linear(4 * d, d),
            }
        mlp_in = (cfg.seq_len + 1) * d + cfg.n_user_feats * e
        dims = (mlp_in,) + tuple(cfg.mlp_dims) + (1,)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            p[f"mlp_w{i}"] = linear(a, b)
            p[f"mlp_b{i}"] = torch.zeros((b,), device=dev)
        return p

    # -- backbone -------------------------------------------------------------

    def _seq_repr(self, params, item_hist, cate_hist, target_item,
                  target_cate) -> torch.Tensor:
        """(B, S+1, d) transformer output over [history ; target]."""
        cfg = self.cfg
        it = torch.cat([item_hist, target_item[:, None]], dim=1)
        ct = torch.cat([cate_hist, target_cate[:, None]], dim=1)
        x = torch.cat([lookup_rows(params["item_emb"], it),
                       lookup_rows(params["cate_emb"], ct)], dim=-1)
        x = x + local(params["pos_emb"])[None]
        B, S1, d = x.shape
        H = cfg.n_heads
        hd = d // H
        for i in range(cfg.n_blocks):
            bp = tree_map(local, params[f"blk{i}"])
            h = L.rms_norm(x, local(params["ln1"]))
            q = (h @ bp["wq"]).reshape(B, S1, H, hd)
            k = (h @ bp["wk"]).reshape(B, S1, H, hd)
            v = (h @ bp["wv"]).reshape(B, S1, H, hd)
            o = L.dense_attention(q, k, v, causal=False)
            x = x + o.reshape(B, S1, d) @ bp["wo"]
            h = L.rms_norm(x, local(params["ln2"]))
            x = x + leaky_relu(h @ bp["w1"], cfg.leaky_slope) @ bp["w2"]
        return x

    def _user_feat_emb(self, params, user_feats) -> torch.Tensor:
        """(B, F) ids → (B, F·e): per-field embedding tables."""
        gathered = lookup_fields(params["user_emb"], user_feats)
        return gathered.reshape(user_feats.shape[0], -1)

    def forward(self, params, inputs: BSTInputs) -> torch.Tensor:
        """Click logits (B,)."""
        seq = self._seq_repr(params, inputs.item_hist, inputs.cate_hist,
                             inputs.target_item, inputs.target_cate)
        B = seq.shape[0]
        x = torch.cat([seq.reshape(B, -1),
                       self._user_feat_emb(params, inputs.user_feats)],
                      dim=-1)
        n_mlp = len(self.cfg.mlp_dims) + 1
        act = lambda h: leaky_relu(h, self.cfg.leaky_slope)  # noqa: E731
        i = 0
        w0 = params["mlp_w0"]
        if n_mlp > 1 and splits_columns(w0):
            # mlp_w0's column blocks where they lie, the partial products
            # of mlp_w1 added over them, as the reference's partitioner
            x = (column_row_product(x, w0, params["mlp_b0"],
                                    params["mlp_w1"], act)
                 + local(params["mlp_b1"]))
            i = 2
            if i < n_mlp:
                x = act(x)
        for i in range(i, n_mlp):
            x = (x @ local(params[f"mlp_w{i}"])
                 + local(params[f"mlp_b{i}"]))
            if i < n_mlp - 1:
                x = act(x)
        return x[:, 0]

    def loss(self, params, inputs: BSTInputs) -> torch.Tensor:
        """The mean binary cross entropy of the click logits. With the
        inputs as ``Rows`` over several homes and the leaves as
        ``HomeViews`` (the ``fsdp`` train step's microbatch over several
        batch shards): each home's sum and count of terms added over the
        homes and divided once, the microbatch's mean at every home."""
        if isinstance(inputs, Rows):
            return batch_mean(*each_home(
                lambda p, x: (self._terms(p, x).sum(),
                              torch.tensor(x.labels.shape[0],
                                           dtype=torch.int32,
                                           device=x.labels.device)),
                params, inputs), None)
        return torch.mean(self._terms(params, inputs))

    def _terms(self, params, inputs: BSTInputs) -> torch.Tensor:
        """Each row's binary cross entropy (B,)."""
        logits = self.forward(params, inputs)
        y = inputs.labels.float()
        # jnp.maximum: a tie at 0 sends half the gradient each way
        return (torch.maximum(logits, torch.zeros_like(logits))
                - logits * y + torch.log1p(torch.exp(-torch.abs(logits))))

    # -- retrieval (retrieval_cand shape) --------------------------------------

    def retrieval_scores(self, params, inputs: BSTInputs,
                         cand_items: torch.Tensor,
                         cand_cates: torch.Tensor) -> torch.Tensor:
        """Score 10⁶ candidates against one user: (B, C) batched dot."""
        return self.candidate_scores(params, self.user_repr(params, inputs),
                                     cand_items, cand_cates)

    def user_repr(self, params, inputs: BSTInputs) -> torch.Tensor:
        """(B, d): the mean of the transformer's outputs."""
        seq = self._seq_repr(params, inputs.item_hist,
                             inputs.cate_hist, inputs.target_item,
                             inputs.target_cate)
        return seq.mean(dim=1)

    def candidate_scores(self, params, user: torch.Tensor,
                         cand_items: torch.Tensor,
                         cand_cates: torch.Tensor) -> torch.Tensor:
        """(B, C): ``user`` dotted with each candidate's item ⊕ category
        embedding."""
        cand = torch.cat([lookup_rows(params["item_emb"], cand_items),
                          lookup_rows(params["cate_emb"], cand_cates)],
                         dim=-1)
        return user @ cand.T


def bst_params_from_jax(cfg: BSTConfig, tree, device="cuda"
                        ) -> Dict[str, Any]:
    """The JAX package's ``BST.init`` tree (leaves as numpy or JAX arrays)
    as this port's f32 parameters on ``device``; ``cfg`` is checked
    against the tree's shapes."""
    if np.shape(tree["item_emb"]) != (cfg.n_items, cfg.embed_dim):
        raise ValueError(f"item_emb {np.shape(tree['item_emb'])} is not "
                         f"({cfg.n_items}, {cfg.embed_dim})")
    return tree_map(lambda a: torch.as_tensor(
        np.array(a, dtype=np.float32)).to(device), tree)
