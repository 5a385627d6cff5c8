"""Decoder-only transformer LM, dense and MoE, for serving and training
(PyTorch port of ``repro.models.transformer``).

GQA (+ optional QKV bias), RoPE, RMSNorm, SwiGLU or a routed MoE MLP.
Parameters are a plain dictionary with one dictionary per layer in
``params["layers"]`` (the JAX package stacks them on a leading axis for its
``lax.scan``; :func:`params_from_jax` unstacks). Serving stores weights in
the compute dtype: every use in the reference casts to it first, so that
is exact and keeps the card's weights at 2 bytes each in bf16. Training
keeps f32 masters, as the reference does (``init(..., dtype=float32)``),
and casts at each use; ``cfg.remat == "full"`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint``. ``cfg.remat == "dots"`` is the reference's
``checkpoint_dots_with_no_batch_dims`` policy as a selective checkpoint
(:func:`dots_policy`): the outputs of the products with a 2-D weight
(``aten.mm``/``aten.addmm``: the QKV and output projections, the dense
SwiGLU's three products, the router) are saved, everything else in the
layer is recomputed — attention and the expert GEMMs (batched products in
the reference, so its policy saves neither), norms, RoPE, activations.
The flash and expert-GEMM kernels launch from Python through the
extension, not as dispatched ops, so the policy never sees them: they run
again in the recompute, as the reference recomputes those products.

Entry points:
  init(generator, dtype)                 → params
  forward(params, tokens)                → (hidden, aux)
  loss(params, tokens, labels)           → scalar
  logits(params, hidden)                 → logits
  prefill(params, tokens)                → (logits_last, kv_cache)
  decode_step(params, token, cache, cache_len[, attend]) → (logits, cache)
  make_cache(batch, seq_len)             → zero kv_cache

With ``act_spec`` (a PartitionSpec such as ``P("data", None, None)``)
the loss takes the vocab-parallel cross entropy
(``layers.softmax_xent_sharded``) and, when ``moe_shard == "expert"``,
the MoE layers keep the expert weights where they live, as the
reference's model does under ``exp_spec = P(batch_axes, "model", None,
None)``. The port has no GSPMD to
pin activations to. The sharded train step (``train.state.
make_sharded_train_step``) and the serving steps under ``fsdp`` run each
batch shard's activations on its own device and hand the model its
parameters as per-batch-shard views (``distrib.collectives.ShardView``)
that each layer gathers where it uses them (and, under ``remat="full"``,
again in the recompute); with ``exp_spec`` the expert weights stay where
they live, and the table, split along its rows, is looked up where its rows
lie (``ShardView.take_rows``: the reference's lookup); on that route the
head, or a tied table read as its transpose, stays where its vocab blocks
lie (:meth:`TransformerLM.head_in_place`, ``collectives.LyingHead``: the
hidden rows go to the blocks, the loss's per-row statistics and dX
partials are reduced over them, a prefill's logits are formed there),
where the chunked route gathers it whole at each home. Where one
microbatch lies on several batch shards (the reference cell's one
microbatch) the train step hands the model every
home's views at once (``collectives.HomeViews``) and the tokens and labels
as ``Rows``: the homes' tokens are looked up at once
(``HomeViews.take_rows``), each home runs its own rows with its own
gathered leaves, and the cross entropy's sums and counts and the MoE aux
statistics are added over the homes (``collectives.batch_mean``,
``moe._batch_aux``). The serving steps under ``tp2d`` with the batch whole
(``distrib.serving``) move no parameter: they hand the model
``StationaryView`` s of every leaf and the batch's tokens as ``Rows``.
Each product then runs on the positions that hold the weight's blocks
(``layers.linear``), the table is looked up where its rows lie, the
experts stay where they live, and the norms, RoPE, attention and the
residual stream run at the home (``collectives.each``, which calls the
function as it is when no argument is ``Rows``). With the batch split
they hand the model ``TPView`` s and the tokens of every position, as the
train step below does, and ``decode_step`` attends with every head at
each position (``_qkv(..., whole=True)``), over its slice of the cache.
The train step under ``tp2d``
(``train.state.make_tp2d_train_step``) hands ``loss`` a ``TPView`` of
every leaf and, one microbatch at a time, the tokens and labels of every
position as ``Rows`` (the microbatch's rows split over the batch shards),
the reference's split: each product multiplies the position's rows by the
weight's "model" block gathered along "data" (``layers.linear``), the
heads split over "model" (``collectives.split_heads``: by heads where H
and KV divide, q split and the key-value heads taken where only H does,
else q, k and v gathered and each position's part of the output taken
for ``wo``), the experts over "model" (``moe.moe_block``: the groups and
the aux loss over the whole microbatch), the cross entropy per vocab
block, its sums and counts added over "data"
(``layers.softmax_xent_sharded``); every position's loss, the
microbatch's, comes back as Rows. Under ``remat`` the layer's checkpoint
repeats the forward's gathers and sums in the recompute; under ``"dots"``
the positions' products are the saved ops, as the one-device products
are.

The KV cache is (L, B, S, KV, hd) ×2 in bf16, as in the reference, even for
f32 configs. ``decode_step`` writes the new token's keys and values into
the cache in place (the reference returns an updated copy) and returns it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.base import TransformerConfig
from repro_torch.distrib.collectives import (HomeViews, LyingHead, Rows,
                                             ShardView, StationaryView,
                                             TPView, batch_mean, each,
                                             head_form, local, model_gather,
                                             split_heads)
from repro_torch.distrib.sharding import P
from repro_torch.models import layers as L
from repro_torch.models.moe import (batch_shards, init_moe_params,
                                    moe_block, shard_groups)

Params = Dict[str, Any]
Cache = Tuple[torch.Tensor, torch.Tensor]

# the products of a 2-D weight: what checkpoint_dots_with_no_batch_dims saves
# (``mm.dtype``: a block product's f32 partial under ``tp2d``, on the card)
_SAVED_PRODUCTS = tuple(
    op for op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  getattr(torch.ops.aten.mm, "dtype", None))
    if op is not None)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the outputs of products without a batch
    dimension, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXTS = functools.partial(create_selective_checkpoint_contexts,
                                   dots_policy)


class TransformerLM:
    def __init__(self, cfg: TransformerConfig, moe_group_size: int = 4096,
                 act_spec=None):
        self.cfg = cfg
        self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                              else torch.float32)
        self.moe_group_size = moe_group_size
        self.act_spec = act_spec
        # the dispatch buffer's spec under expert parallelism
        self.exp_spec = None
        if (act_spec is not None and cfg.moe is not None
                and cfg.moe.moe_shard == "expert"):
            self.exp_spec = P(act_spec[0], "model", None, None)

    def looks_up_in_place(self, emb) -> bool:
        """Whether the table ``emb`` is looked up where its rows lie: a
        view of a table split along its rows only; a tied one only where
        the head stays where it lies too (:meth:`head_in_place`: else it
        is gathered whole for the head, and looked up there)."""
        return (isinstance(emb, (ShardView, HomeViews)) and emb.splits_rows
                and (not self.cfg.tie_embeddings
                     or self.head_in_place(emb)))

    def head_in_place(self, w) -> bool:
        """Whether the head ``w`` (``params["head"]``, or the tied table
        read as its transpose) is read where its blocks lie
        (``collectives.LyingHead``): on the vocab-parallel route
        (``act_spec``), a view of a head whose layout the reference's
        partitioner forms in place (``collectives.head_form``: one vocab
        block a position, or the fallback over "data" alone on a square
        mesh). Otherwise the head is gathered whole at each home, as on
        the chunked route."""
        if self.act_spec is None or not isinstance(w, (ShardView,
                                                       HomeViews)):
            return False
        view = w.views[0] if isinstance(w, HomeViews) else w
        return (isinstance(view, ShardView)
                and head_form(view.x, self.cfg.tie_embeddings) is not None)

    def _local(self, params: Params) -> Params:
        """The top-level leaves (embed, head, ln_f) of ``params`` as this
        batch shard's tensors (``distrib.collectives.local``), but a view
        of a table that :meth:`_embed` looks up where its rows lie
        (:meth:`looks_up_in_place`) or of a head read where its blocks lie
        (:meth:`head_in_place`)."""
        return {k: (v if k == "layers" or (
            k == "embed" and self.looks_up_in_place(v)) or (
            k == "head" and self.head_in_place(v)) else local(v))
            for k, v in params.items()}

    def _local_layer(self, p: Params) -> Params:
        """One layer's leaves as this batch shard's tensors, the expert
        weights left where they live under ``exp_spec``."""
        out = {k: local(v) for k, v in p.items() if k != "moe"}
        if "moe" in p:
            ep = self.exp_spec is not None
            out["moe"] = {k: local(v, experts=ep and k != "router")
                          for k, v in p["moe"].items()}
        return out

    # -- init -----------------------------------------------------------------

    def init_layer(self, gen: torch.Generator,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Params:
        cfg = self.cfg
        cd = self.compute_dtype if dtype is None else dtype
        d, hd = cfg.d_model, cfg.head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        dev = gen.device if device is None else torch.device(device)
        lin = functools.partial(L.init_linear, gen, dtype=cd, device=dev)
        p: Params = {
            "ln1": torch.ones((d,), dtype=cd, device=dev),
            "ln2": torch.ones((d,), dtype=cd, device=dev),
            "wq": lin(d, H * hd),
            "wk": lin(d, KV * hd),
            "wv": lin(d, KV * hd),
            "wo": lin(H * hd, d),
        }
        if cfg.qkv_bias:
            p["bq"] = torch.zeros((H * hd,), dtype=cd, device=dev)
            p["bk"] = torch.zeros((KV * hd,), dtype=cd, device=dev)
            p["bv"] = torch.zeros((KV * hd,), dtype=cd, device=dev)
        if cfg.moe is None:
            p["wg"] = lin(d, cfg.d_ff)
            p["wu"] = lin(d, cfg.d_ff)
            p["wd"] = lin(cfg.d_ff, d)
        else:
            p["moe"] = init_moe_params(gen, cfg.moe, d, cd, device=dev)
            if cfg.moe.n_shared_experts:
                f = cfg.moe.n_shared_experts * cfg.moe.d_ff_expert
                p["sg"] = lin(d, f)
                p["su"] = lin(d, f)
                p["sd"] = lin(f, d)
        return p

    def init(self, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None, device=None) -> Params:
        """Random weights on the generator's device, drawn from it in f32
        and stored in ``dtype`` (default: the compute dtype, for serving;
        training passes ``torch.float32`` for f32 masters). ``device="meta"``
        gives the shapes and dtypes only, with nothing allocated and no
        draw taken (the counterpart of ``jax.eval_shape``)."""
        cfg = self.cfg
        cd = self.compute_dtype if dtype is None else dtype
        dev = generator.device if device is None else torch.device(device)
        params: Params = {
            "embed": (torch.randn((cfg.vocab_size, cfg.d_model),
                                  generator=generator, device=dev)
                      * 0.02).to(cd),
            "ln_f": torch.ones((cfg.d_model,), dtype=cd, device=dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = L.init_linear(generator, cfg.d_model,
                                           cfg.vocab_size, cd, device=dev)
        params["layers"] = [self.init_layer(generator, cd, dev)
                            for _ in range(cfg.n_layers)]
        return params

    # -- layer body -------------------------------------------------------------

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return L.rms_norm(x, w.to(self.compute_dtype), self.cfg.rms_eps)

    def _qkv(self, p: Params, x, positions, whole: bool = False):
        """The layer's queries (B, S, H, hd) and keys and values
        (B, S, KV, hd), RoPE applied; over ``TPView`` s each position's
        heads (``collectives.split_heads``; with ``whole``, all of them, as
        a decode step attends) and the function that takes its part of the
        attention output for ``wo``."""
        cfg, cd = self.cfg, self.compute_dtype
        h = each(self._norm, x, p["ln1"])
        q, k, v = (L.linear(h, p[w], cd, p.get(b))
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        own = None
        if isinstance(p["wq"], TPView):
            q, k, v, own = split_heads(q, k, v, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim, whole)
        q, k, v = each(self._rope, q, k, v, positions)
        return q, k, v, own

    def _rope(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              positions: torch.Tensor):
        """q (B, S, H·hd), k and v (B, S, KV·hd) as heads, RoPE applied
        (the head counts read from the widths: a position's heads in the
        ``tp2d`` train step)."""
        cfg = self.cfg
        B, S = q.shape[:2]
        hd = cfg.head_dim
        q = q.reshape(B, S, q.shape[-1] // hd, hd)
        k = k.reshape(B, S, k.shape[-1] // hd, hd)
        v = v.reshape(B, S, v.shape[-1] // hd, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attn_out(self, p: Params, x, o, own=None):
        """The residual stream after the output projection of attention
        output ``o`` (B, S, H, hd), ``own`` taking each position's part of
        it first where every position attended over all heads."""
        o = each(torch.flatten, o, 2)
        if own is not None:
            o = own(o)
        o = L.linear(o, p["wo"], self.compute_dtype)
        return each(torch.add, x, o)

    def _attn(self, p: Params, x, positions):
        """Causal attention over the whole sequence: the residual stream
        after it, and the layer's (k, v)."""
        q, k, v, own = self._qkv(p, x, positions)
        o = each(L.blockwise_attention, q, k, v)
        return self._attn_out(p, x, o, own), (k, v)

    def _cache_attend(self, i: int, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, cache: Cache, cache_len: int
                      ) -> torch.Tensor:
        """Decode attention of layer ``i``: the new token's k, v written in
        place into ``cache`` at ``cache_len``, then q against the cache's
        first ``cache_len + 1`` positions."""
        B, S = q.shape[:2]
        cd = self.compute_dtype
        k_cache, v_cache = cache[0][i], cache[1][i]
        k_cache[:, cache_len:cache_len + S] = k.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + S] = v.to(v_cache.dtype)
        return L.decode_attention(
            q, k_cache.to(cd), v_cache.to(cd),
            cache_len=torch.full((B,), cache_len + 1, dtype=torch.int32,
                                 device=q.device))

    def _mlp(self, p: Params, x):
        cfg = self.cfg
        h = each(self._norm, x, p["ln2"])
        if cfg.moe is None:
            y = L.swiglu(h, p["wg"], p["wu"], p["wd"])
            aux = each(_no_aux, x)
        else:
            # the reference's groups: over every batch shard's tokens (a
            # serving step's batch, a tp2d train step's microbatch)
            B, S, d = h.shape
            T = B * S * batch_shards(h, p["moe"]["router"])
            n_groups = max(1, T // self.moe_group_size)
            y, aux = moe_block(each(torch.reshape, h, (B * S, d)), p["moe"],
                               cfg.moe, n_groups)
            y = each(torch.reshape, y, (B, S, d))
            if cfg.moe.n_shared_experts:
                y = each(torch.add, y,
                         L.swiglu(h, p["sg"], p["su"], p["sd"]))
        return each(torch.add, x, y), aux

    def moe_span(self, batch: int, seq: int, shards: int) -> int:
        """How many of ``shards`` equal batch shards of a (batch, seq)
        batch one MoE group spans: 1 without MoE layers or where the
        reference's groups lie inside the shards (raises where the groups
        neither fit into nor span whole shards)."""
        if self.cfg.moe is None:
            return 1
        T = batch * seq
        return shard_groups(T // shards, max(1, T // self.moe_group_size),
                            shards)[2]

    def _layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self._local_layer(p)
        x, _ = self._attn(p, x, positions)
        return self._mlp(p, x)

    # -- forward ---------------------------------------------------------------

    def _embed(self, params: Params, tokens):
        emb = params["embed"]
        if isinstance(emb, (StationaryView, ShardView, HomeViews)):
            return emb.take_rows(tokens, self.compute_dtype)
        return each(lambda e, t: e.to(self.compute_dtype)[t.long()], emb,
                    tokens)

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if positions is None:
            positions = each(_prompt_positions, tokens)
        if cfg.remat not in ("full", "dots", "none"):
            raise ValueError(f"TransformerLM: unknown remat {cfg.remat!r}")
        params = self._local(params)
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        kw = {"context_fn": _DOTS_CONTEXTS} if cfg.remat == "dots" else {}
        x = self._embed(params, tokens)
        aux = each(_no_aux, tokens)
        for lp in params["layers"]:
            if remat:
                x, a = checkpoint(self._layer, lp, x, positions,
                                  use_reentrant=False, **kw)
            else:
                x, a = self._layer(lp, x, positions)
            aux = each(torch.add, aux, a)
        return each(self._norm, x, params["ln_f"]), aux

    def _head_w(self, params: Params) -> torch.Tensor:
        """The head of :meth:`_local`'s leaves: a view left there is read
        where its blocks lie (``collectives.LyingHead``)."""
        if self.cfg.tie_embeddings:
            emb = params["embed"]
            if isinstance(emb, (ShardView, HomeViews)):
                return LyingHead(emb, transposed=True)
            return each(torch.t, emb) if isinstance(emb, Rows) else emb.T
        head = params["head"]
        if isinstance(head, (ShardView, HomeViews)):
            return LyingHead(head)
        return head

    def logits(self, params: Params, hidden):
        """``hidden @ head``; over a ``TPView`` head gathered along "data"
        (the tied head under ``tp2d``) each position's vocab block, joined
        over "model" (``tp_logits_gather``)."""
        w = self._head_w(params)
        if isinstance(w, LyingHead):   # at position 0
            home = w.views[0].home
            return w.logits(Rows([hidden], [home], w.mesh))[0]
        y = L.linear(hidden, w, hidden.dtype)
        if isinstance(w, TPView) and w.splits_output():
            y = model_gather(y, -1, "tp_logits_gather")
        return y

    def loss(self, params: Params, tokens, labels,
             aux_coef: float = 0.01):
        """Mean next-token cross entropy over the labels ≥ 0 (chunks of 512
        positions; with ``act_spec`` the vocab-parallel form over all
        logits at once) + ``aux_coef`` · the MoE aux loss / n_layers. With
        the tokens and labels of every position as ``Rows`` and the
        leaves as ``TPView`` s (the ``tp2d`` train step) the loss of the
        batch the batch shards split, at every position as Rows: the cross
        entropy the vocab-parallel form over each position's vocab block,
        its sums and counts added over "data"; the aux loss over all the
        shards' groups. With them as Rows over several homes and the leaves
        as ``HomeViews`` (the ``fsdp`` train step's microbatch over several
        batch shards) likewise: each home's cross entropy sum and count
        added over the homes and divided once, the aux loss over all their
        groups. On the vocab-parallel route a head (or tied table) that
        stays where its blocks lie (:meth:`head_in_place`) takes the loss
        over those blocks, every home's rows at once
        (``collectives.LyingHead``)."""
        params = self._local(params)
        hidden, aux = self.forward(params, tokens)
        w = self._head_w(params)
        sharded = self.act_spec is not None

        def xent(h, wd, lab, sums=False):
            if sharded:
                return L.softmax_xent_sharded(h, wd, lab, sums)
            return L.softmax_xent_chunked(lambda xc: xc @ wd.to(xc.dtype),
                                          h, lab, sums=sums)
        if isinstance(w, (LyingHead, TPView)):
            xent = L.softmax_xent_sharded(hidden, w, labels)
        elif isinstance(w, Rows):  # each home's sums, the microbatch's mean
            xent = batch_mean(*each(lambda h, wd, lab: xent(h, wd, lab, True),
                                    hidden, w, labels), None)
        else:
            xent = xent(hidden, w, labels)
        n = max(self.cfg.n_layers, 1)
        return each(lambda xe, a: xe + aux_coef * a / n, xent, aux)

    # -- serving ----------------------------------------------------------------

    def prefill(self, params: Params, tokens, rows=None, last=False
                ) -> Tuple[torch.Tensor, Cache]:
        """Full-sequence forward returning last-position logits + KV cache;
        ``rows``, where given, are the tokens' rows of the table, looked up
        already (``distrib.serving`` looks every batch shard's up at once);
        with ``last`` the last position's hidden rows in place of the
        logits (``distrib.serving`` multiplies every batch shard's by a head
        that stays where it lies at once).

        Cache layout: (L, B, S, KV, hd) ×2, bf16.
        """
        positions = each(_prompt_positions, tokens)
        params = self._local(params)
        x = self._embed(params, tokens) if rows is None else rows
        for i, lp in enumerate(params["layers"]):
            lp = self._local_layer(lp)
            x, (k, v) = self._attn(lp, x, positions)
            x, _ = self._mlp(lp, x)
            if i == 0:   # each position's heads under ``tp2d``
                ks, vs = each(self._empty_cache, k)
            each(_store_kv, ks, vs, k, v, i)
        x = each(self._norm, x, params["ln_f"])
        if last:
            return each(_last, x), (ks, vs)
        return self.logits(params, each(_last, x)), (ks, vs)

    def _empty_cache(self, k: torch.Tensor) -> Cache:
        """The (L, B, S, KV, hd) cache of the keys ``k`` (B, S, KV, hd) of
        every layer."""
        shape = (self.cfg.n_layers,) + tuple(k.shape)
        return (torch.empty(shape, dtype=torch.bfloat16, device=k.device),
                torch.empty(shape, dtype=torch.bfloat16, device=k.device))

    def decode_step(self, params: Params, token, cache: Cache,
                    cache_len: int, attend: Optional[Callable] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """One-token decode. token: (B, 1); cache: (L, B, S, KV, hd) ×2,
        written in place at position ``cache_len``. ``attend(i, q, k, v,
        cache, cache_len) → o`` replaces layer ``i``'s cache attention
        (default :meth:`_cache_attend`): a cache laid out over a mesh
        brings its own (``distrib.serving``)."""
        cache_len = int(cache_len)
        attend = attend or self._cache_attend
        positions = each(_decode_positions, token, cache_len)
        params = self._local(params)
        x = self._embed(params, token)
        for i, lp in enumerate(params["layers"]):
            lp = self._local_layer(lp)
            q, k, v, own = self._qkv(lp, x, positions, whole=True)
            x = self._attn_out(lp, x, attend(i, q, k, v, cache, cache_len),
                               own)
            x, _ = self._mlp(lp, x)
        x = each(self._norm, x, params["ln_f"])
        return self.logits(params, x), cache

    def make_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Cache:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _prompt_positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def _decode_positions(token: torch.Tensor, n: int) -> torch.Tensor:
    return torch.full((token.shape[0], 1), n, device=token.device)


def _store_kv(ks: torch.Tensor, vs: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, i: int) -> None:
    ks[i] = k.to(torch.bfloat16)
    vs[i] = v.to(torch.bfloat16)


def _last(x: torch.Tensor) -> torch.Tensor:
    return x[:, -1:]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def params_from_jax(cfg: TransformerConfig, tree: Params, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's ``TransformerLM.init`` tree (leaves as numpy
    arrays) as this port's parameters: the leading layer axis of
    ``tree["layers"]`` unstacked into one dictionary per layer, every
    tensor cast to ``dtype`` (default: the compute dtype, for serving;
    ``torch.float32`` for training's masters) and placed on ``device``."""
    cd = dtype
    if cd is None:
        cd = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        return _to_tensor(node).to(device=device, dtype=cd)

    out = {key: conv(val) for key, val in tree.items() if key != "layers"}
    stacked = tree["layers"]

    def layer(node, i):
        if isinstance(node, dict):
            return {key: layer(val, i) for key, val in node.items()}
        return np.asarray(node)[i]

    layers: List[Params] = [conv(layer(stacked, i))
                            for i in range(cfg.n_layers)]
    out["layers"] = layers
    return out


def train_state_from_jax(cfg: TransformerConfig, tree, device="cuda"):
    """The JAX package's LM ``TrainState(params, AdamWState(step, m, v))``
    (leaves as numpy arrays, layers stacked) as this port's train state:
    params, m and v unstacked per layer in f32 on ``device``, step an int32
    scalar tensor there."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.state import TrainState
    f32 = torch.float32
    opt = tree.opt
    return TrainState(
        params_from_jax(cfg, tree.params, device, dtype=f32),
        AdamWState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                                device=device),
                   params_from_jax(cfg, opt.m, device, dtype=f32),
                   params_from_jax(cfg, opt.v, device, dtype=f32)))


def train_state_to_jax(state):
    """This port's train state in the JAX package's layout: the same
    ``TrainState(params, AdamWState(step, m, v))`` with numpy leaves and
    each ``layers`` list stacked on a leading axis (the layout of the
    reference's checkpoints)."""
    from repro_torch.train.state import stack_layers
    return stack_layers(state)
