"""The LM's serving steps over a device mesh: prefill under the ``fsdp``
rules (the prefill cell's default) or ``tp2d``, decode under ``tp2d``, the
KV cache placed by ``lm_cache_specs``.

The reference's prefill and decode cells are ``jax.jit`` over
``model.prefill`` / ``model.decode_step`` with ``in_shardings`` from the
same rules; XLA's SPMD partitioner then runs each product where the weight
blocks lie and moves activations (Megatron's split under ``tp2d``, which
the reference keeps for decode because per-token parameter gathers would
destroy latency). The single-controller mesh has no partitioner, so these
steps say where each piece of work runs. The batch splits over the batch
axes of ``batch_spec`` (one batch shard when the spec leaves it whole);
batch shard d's activations live on its home position.

* Under ``tp2d`` no parameter moves: the model gets a
  ``collectives.StationaryView`` of every placed leaf and the tokens of
  every batch shard as ``collectives.Rows``. Each product runs on the
  positions that hold the weight's blocks, on the rows of every batch
  shard at once (``collectives.block_matmul``: the activations go to the
  holders as ``tp_act``, the partial products come back as
  ``tp_partial``), ``embed`` is looked up where its blocks lie
  (``emb_ids``, ``emb_rows``; the tied head multiplies by its transposed
  blocks), and the experts stay where they live whether or not the batch
  is split (``expert_send``). The norms, RoPE, attention and the residual
  stream run at each home.
* Under ``fsdp`` (prefill) each batch shard runs ``model.prefill`` at its
  home over parameters *stored* by their specs and gathered layer by layer
  there (``ShardView`` / ``local``, read-only here; ``all_gather``), the
  ZeRO-style choice of the sharded train step; with ``act_spec`` and
  expert-sharded MoE the experts stay where they live.

The KV cache is a pair of ``ShardedTensor`` s (L, B, S, KV, hd) placed by
``lm_cache_specs``: ``P(None, ba, "model", None, None)`` for B ≥ the
production batch shards, else ``P(None, None, (*ba, "model"), None,
None)``, the flash-decoding layout. The cache is never gathered whole:
the prefill sends each block of its cache to the position that holds it
(``cache_scatter``); a decode step writes the new token's keys and values
in place into the one slice that holds position ``cache_len``
(``kv_write``), sends the query to every slice of its batch shard
(``q_send``), where ``layers.decode_attention_partial`` gives the
slice's unnormalised (m, l, o), and adds the partials back at the home
(``attn_partial``) in ascending slice order with the log-sum-exp rescale
(``layers.combine_attention_partials``). Every move is counted in
``mesh.bytes`` under the name in parentheses; the logits come to position
0 (``logits_gather``). The split attention and the block products sum in
another order than one device, so decode logits (and ``tp2d`` prefill
logits) differ from one device's by rounding; under ``fsdp`` with one
batch shard the prefill is one device's bit for bit.

BST's serve cells (:func:`make_sharded_click`, :func:`make_sharded_retrieval`)
take the per-batch-shard shape of ``fsdp``: the forward per batch shard at
its home, or the candidates per block at theirs, the outputs joined at
position 0.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.distrib.collectives import (Rows, ShardView, StationaryView,
                                             batch_groups, send)
from repro_torch.distrib.sharding import (Layout, ShardedTensor, device_put,
                                          map_with_specs)
from repro_torch.models import layers as L
from repro_torch.optim.adamw import tree_map

Cache = Tuple[ShardedTensor, ShardedTensor]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def place_params(params: Any, mesh, specs: Any) -> Any:
    """``params`` placed on ``mesh`` by ``specs`` (the serving weights
    stay in their dtype)."""
    return map_with_specs(lambda x, s: device_put(x, mesh, s), params, specs)


def _views(params, home: int, group) -> Any:
    return tree_map(lambda x: ShardView(x, home, group, grad=False)
                    if isinstance(x, ShardedTensor) else x, params)


def _stationary(params) -> Any:
    return tree_map(lambda x: StationaryView(x)
                    if isinstance(x, ShardedTensor) else x, params)


def _rows(mesh, t: torch.Tensor, homes: List[int]) -> Rows:
    """``t``'s rows cut into one equal batch shard per home, each copied
    there."""
    Bd = t.shape[0] // len(homes)
    parts = []
    for d, home in enumerate(homes):
        with mesh.at(home):
            parts.append(t[d * Bd:(d + 1) * Bd].to(mesh.device(home)))
    return Rows(parts, homes, mesh)


def _to_position_0(mesh, parts: List[torch.Tensor], homes: List[int]
                   ) -> torch.Tensor:
    """The batch shards' rows, concatenated in order on position 0."""
    dev0 = mesh.device(0)
    with mesh.at(0), mesh.moving():
        out = []
        for t, h in zip(parts, homes):
            if h != 0:
                mesh.count("logits_gather", _nbytes(t), to=0)
            out.append(t.to(dev0))
        return torch.cat(out, dim=0)


def place_cache(mesh, spec, parts: List[Tuple[torch.Tensor, torch.Tensor]],
                homes: List[int], capacity: int) -> Cache:
    """The batch shards' prefill caches (each (L, B/D, S, KV, hd) at its
    home, in batch order) as a cache of ``capacity`` ≥ S positions laid out
    by ``spec``: each position's block allocated there, zeros past S,
    the prompt's part copied from the home that computed it."""
    k0 = parts[0][0]
    Lyr, Bd, S, KV, hd = k0.shape
    shape = (Lyr, Bd * len(parts), capacity, KV, hd)
    lay = Layout(mesh, spec, shape)
    Bb, Sb = lay.block_shape[1], lay.block_shape[2]
    out = ([], [])
    for pos in range(mesh.size):
        block = lay.block_of(pos)
        b0, s0 = block[1] * Bb, block[2] * Sb
        d = b0 // Bd
        if (b0 + Bb - 1) // Bd != d:
            raise ValueError(f"cache block rows {b0}..{b0 + Bb - 1} span "
                             f"two batch shards of {Bd} rows")
        r0, s1 = b0 - d * Bd, min(s0 + Sb, S)
        for which in (0, 1):
            with mesh.at(pos), mesh.moving():
                blk = torch.zeros(lay.block_shape, dtype=k0.dtype,
                                  device=mesh.device(pos))
                if s1 > s0:
                    src = parts[d][which][:, r0:r0 + Bb, s0:s1]
                    if pos != homes[d]:
                        mesh.count("cache_scatter", _nbytes(src), to=pos)
                    blk[:, :, :s1 - s0].copy_(src)
            out[which].append(blk)
    return (ShardedTensor(lay, k0.dtype, out[0]),
            ShardedTensor(lay, k0.dtype, out[1]))


def make_sharded_prefill(model, mesh, batch_spec, cache_spec,
                         capacity: Optional[int] = None,
                         policy: str = "fsdp") -> Callable:
    """``prefill(params, tokens) → (logits, (k_cache, v_cache))``:
    ``model.prefill`` over ``params`` placed by the ``policy`` rules
    (:func:`place_params`) — under ``tp2d`` over every batch shard at once
    with the weights where they lie, under ``fsdp`` once per batch shard at
    its home with each layer gathered there — the logits (B, 1, V) on
    position 0 and the cache placed by ``cache_spec`` with room for
    ``capacity`` positions (default: the prompt's)."""
    if policy not in ("fsdp", "tp2d"):
        raise ValueError(f"make_sharded_prefill: unknown policy {policy!r}")
    homes, groups = batch_groups(mesh, batch_spec[0] if len(batch_spec)
                                 else None)
    D = len(homes)

    def prefill(params, tokens: torch.Tensor):
        B, S = tokens.shape
        if B % D:
            raise ValueError(f"batch {B} does not split over {D} shards")
        Bd = B // D
        with torch.no_grad():
            if policy == "tp2d":
                lg, (ks, vs) = model.prefill(_stationary(params),
                                             _rows(mesh, tokens, homes))
                logits, caches = lg.parts, list(zip(ks.parts, vs.parts))
                del ks, vs
            else:
                logits, caches = [], []
                for d in range(D):
                    home = homes[d]
                    with mesh.at(home):
                        views = _views(params, home, groups[d])
                        tok = tokens[d * Bd:(d + 1) * Bd].to(
                            mesh.device(home))
                        lg, kv = model.prefill(views, tok)
                    logits.append(lg)
                    caches.append(kv)
            cache = place_cache(mesh, cache_spec, caches, homes,
                                S if capacity is None else capacity)
            del caches
            return _to_position_0(mesh, logits, homes), cache

    return prefill


def make_sharded_decode(model, mesh, batch_spec) -> Callable:
    """``decode(params, token, cache, cache_len) → (logits, cache)``: one
    token per sequence (B, 1) at position ``cache_len`` (a Python int)
    against ``cache`` placed by ``lm_cache_specs`` (written in place),
    over ``params`` placed by their specs; the logits (B, 1, V) on
    position 0. ``model.decode_step`` runs over every batch shard at once
    with the weights where they lie, each batch shard's attention split
    over its cache slices."""
    homes, _ = batch_groups(mesh, batch_spec[0] if len(batch_spec)
                            else None)
    D = len(homes)
    cd = model.compute_dtype

    def attend(i, q, k, v, cache, n, *, home, r0, slices):
        """Layer ``i``'s attention for batch shard rows r0:r0+Bd of the
        cache blocks in ``slices`` ((S block, holder), ascending)."""
        ks, vs = cache
        Bd, Sb = q.shape[0], ks.layout.block_shape[2]
        j_new = n // Sb
        for (j, h) in slices:
            if j != j_new:
                continue
            for src, kv in ((k, ks), (v, vs)):
                src = src.to(kv.dtype)
                if h != home:
                    mesh.count("kv_write", _nbytes(src), to=h)
                with mesh.moving():
                    off = n - j * Sb
                    kv.shards[h][i, r0:r0 + Bd, off:off + 1].copy_(src)
        parts = []
        for (j, h) in slices:
            if h != home:
                mesh.count("q_send", _nbytes(q), to=h)
            with mesh.moving():
                qh = q.to(mesh.device(h))
            with mesh.at(h):
                valid = min(max(n + 1 - j * Sb, 0), Sb)
                kc = ks.shards[h][i, r0:r0 + Bd].to(cd)
                vc = vs.shards[h][i, r0:r0 + Bd].to(cd)
                part = L.decode_attention_partial(qh, kc, vc, valid)
            if h != home:
                mesh.count("attn_partial", sum(_nbytes(t) for t in part),
                           to=home)
            with mesh.moving():
                parts.append(tuple(t.to(mesh.device(home)) for t in part))
        return L.combine_attention_partials(parts, q.dtype)

    def decode(params, token: torch.Tensor, cache: Cache, cache_len: int):
        lay = cache[0].layout
        n = int(cache_len)
        B = token.shape[0]
        if B % D:
            raise ValueError(f"batch {B} does not split over {D} shards")
        Bd = B // D
        Bb = lay.block_shape[1]
        plans = []
        for d in range(D):
            b = d * Bd // Bb
            plans.append(dict(home=homes[d], r0=d * Bd - b * Bb, slices=sorted(
                (blk[2], lay.holders(blk)[0])
                for blk in lay.blocks() if blk[1] == b)))

        def attend_rows(i, q, k, v, cache, n):
            out = []
            for d, plan in enumerate(plans):
                with mesh.at(plan["home"]):
                    out.append(attend(i, q.parts[d], k.parts[d], v.parts[d],
                                      cache, n, **plan))
            return Rows(out, homes, mesh)

        with torch.no_grad():
            lg, _ = model.decode_step(_stationary(params),
                                      _rows(mesh, token, homes), cache, n,
                                      attend=attend_rows)
            return _to_position_0(mesh, lg.parts, homes), cache

    return decode


def make_sharded_click(model, mesh, batch_spec) -> Callable:
    """BST's ``serve(params, inputs)`` over ``mesh`` (``models.recsys.bst``):
    batch shard d's rows through ``model.forward`` at its home, the
    parameters read through ``ShardView`` s (the replicated item table
    where it is, the user tables' rows where they lie, ``mlp_w0``
    gathered), the sigmoid there, the probabilities joined in batch order
    at position 0."""
    homes, groups = batch_groups(mesh, batch_spec[0])
    D = len(homes)

    def serve(params, inputs):
        parts = []
        with torch.no_grad():
            for d, (h, grp) in enumerate(zip(homes, groups)):
                with mesh.at(h):
                    mine = tree_map(lambda x: x.reshape(
                        (D, -1) + tuple(x.shape[1:]))[d].to(
                            mesh.device(h)), inputs)
                    parts.append(torch.sigmoid(model.forward(
                        _views(params, h, grp), mine)))
            return _to_position_0(mesh, parts, homes)

    return serve


def make_sharded_retrieval(model, mesh, cand_spec) -> Callable:
    """BST's ``retrieval(params, inputs, cand_items, cand_cates)`` over
    ``mesh``: the user representation (B = 1) at position 0, sent to each
    candidate block's home (``user_send``), which scores its block of
    candidates; the (B, C) scores joined in block order at position 0."""
    homes, groups = batch_groups(mesh, cand_spec[0])
    D = len(homes)

    def retrieval(params, inputs, cand_items, cand_cates):
        parts = []
        with torch.no_grad():
            with mesh.at(0):
                user = model.user_repr(_views(params, 0, groups[0]),
                                       tree_map(lambda x: x.to(
                                           mesh.device(0)), inputs))
            for d, (h, grp) in enumerate(zip(homes, groups)):
                with mesh.at(h):
                    u = send(user, mesh, 0, h, "user_send")
                    ci, cc = (c.reshape(D, -1)[d].to(mesh.device(h))
                              for c in (cand_items, cand_cates))
                    parts.append(model.candidate_scores(
                        _views(params, h, grp), u, ci, cc))
            # the scores (B, C/D) joined along the candidates
            return _to_position_0(mesh, [p.T for p in parts], homes).T

    return retrieval
