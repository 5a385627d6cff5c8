"""The LM's serving steps over a device mesh: prefill under the ``fsdp``
rules (the prefill cell's default) or ``tp2d``, decode under ``tp2d``, the
KV cache placed by ``lm_cache_specs``.

The reference's prefill and decode cells are ``jax.jit`` over
``model.prefill`` / ``model.decode_step`` with ``in_shardings`` from the
same rules; XLA's SPMD partitioner then decides what moves. Its compiled
HLO (read by ``tests/test_torch_tp_serve.py::
test_tp2d_serving_splits_as_the_reference_jitted_steps``) splits a
``tp2d`` step by the batch's layout, and so do these steps. The
single-controller mesh has no partitioner, so they say where each piece
of work runs.

* The batch split over the batch axes of ``batch_spec`` (decode_32k,
  prefill_32k): Megatron over "model" × ZeRO over "data", the ``tp2d``
  train step's split at serving time. Every position holds its batch
  shard's rows (``Rows`` over all the positions) and the model gets a
  ``collectives.TPView`` of every leaf (no gradients). A product gathers
  its weight's "model" block along "data" (``tp_zero_gather``) and
  multiplies there; a row block's f32 partials are summed over "model"
  (``tp_model_sum``). Where the weight splits over "data" on its output
  dimension only — a decode step's ``wo`` and ``wd`` and the untied head,
  in a prefill the head alone (its last rows) — the rows move instead, as
  the HLO shows: each position gathers the batch's rows along "data"
  (``tp_rows_gather``), multiplies them by its block where it lies, sums
  over "model" and takes its batch shard's rows of the other column
  blocks (``tp_rows_scatter``). ``embed`` is looked up as the
  reference's HLO forms the lookup (``TPView.take_rows``): the ids
  permuted and gathered along "model" (``emb_ids_permute``,
  ``emb_ids_gather``), each position's block's rows of its "data" line's
  batch, the partial rows across "model" (``emb_rows_model``), then each
  batch shard's rows of every column block along "data"
  (``emb_rows_data``; a decode step, whose lookup the reference does not
  pin, re-lays them out so, ``emb_rows_relayout``); the tied head's
  vocab blocks are joined over "model" (``tp_logits_gather``). A
  prefill splits the heads over "model" as the train step does
  (``tp_heads_gather`` where they do not divide); a decode step gathers
  q, k and v whole along "model"
  (``tp_heads_gather``). A decode step re-splits the router over
  "model" where it lies (``tp_resplit``) and sums its logits' partials
  over "model", as the reference's decode HLO does. MoE groups are the
  reference's, over the whole batch: where one group spans several batch
  shards (every decode step with B below ``moe_group_size``), each
  position gathers the group's router probabilities along "data"
  (``moe_group_probs``), routes the whole group, and takes each dispatch
  row from the one shard that owns its token (``moe_group_dispatch``).
  The experts split over "model" (E / M each, ``expert_gather``, or every
  expert's d_ff / M, summed over "model"). Each layer's gathered blocks
  live only while its product runs.
* The batch whole (long_500k): no parameter moves. The model gets a
  ``collectives.StationaryView`` of every placed leaf and the tokens of
  the batch as ``collectives.Rows`` at its home. Each product runs on the
  positions that hold the weight's blocks (``collectives.block_matmul``:
  the activations go to the holders as ``tp_act``, the partial products
  come back as ``tp_partial``), ``embed`` is looked up as the
  reference's HLO forms it with the batch whole (the tokens at every
  position from the host, each position's block's rows, the partial rows
  across "model", ``emb_rows_model``; the home takes its rows of the
  column blocks it lacks, ``emb_rows_home``; the tied head multiplies by
  its transposed blocks), and the experts stay where they live
  (``expert_send``: the dispatch buffer's slices to the experts, or the
  whole buffer to each d_ff block). The norms, RoPE, attention and the
  residual stream run at the home.
* Under ``fsdp`` (prefill) each batch shard runs ``model.prefill`` at its
  home over parameters *stored* by their specs and gathered layer by layer
  there (``ShardView`` / ``local``, read-only here; ``all_gather``), the
  ZeRO-style choice of the sharded train step; with ``act_spec`` and
  expert-sharded MoE the experts stay where they live. Where one MoE
  group spans several batch shards (fewer tokens a shard than a group),
  each run of the shards it spans is computed at the run's first home over
  all the run's rows, so the groups are the reference's, and the other
  shards' logits and keys and values then go to their homes
  (``prefill_span``). With ``act_spec`` the head (or a tied table) stays
  where its vocab blocks lie, as the reference's partitioner forms a
  prefill's logits: every run's last rows go to the blocks, and the
  blocks' logits to position 0 (``collectives.head_logits``; a spanned
  shard then gets only its keys and values).

The KV cache is a pair of ``ShardedTensor`` s (L, B, S, KV, hd) placed by
``lm_cache_specs``: ``P(None, ba, "model", None, None)`` for B ≥ the
production batch shards, else ``P(None, None, (*ba, "model"), None,
None)``, the flash-decoding layout. The cache is never gathered whole:
the prefill copies each head's part of each block of its cache to the
position that holds the block (``cache_scatter``: from the batch shard's
home, or, with the batch split, from the position of its group that
computed that head). With the batch split, each position writes a decode
step's keys and values into its own block where its sequence slice holds
``cache_len`` and attends over its slice with all heads; the slices'
(m, l, o) cross "model" (``attn_partial``) and every position adds them in
ascending slice order with the log-sum-exp rescale
(``layers.combine_attention_partials``). With it whole, a step writes the
new token's keys and values in place into the one slice that holds
position ``cache_len`` (``kv_write``), sends the query to every slice
(``q_send``), where ``layers.decode_attention_partial`` gives the slice's
unnormalised (m, l, o), and adds the partials back at the home
(``attn_partial``) the same way. Every move is counted in ``mesh.bytes``
under the name in parentheses (and, where it names both ends, in
``mesh.moves``); the logits come to position 0 (``logits_gather``). The
split attention and the block products sum in another order than one
device, so decode logits (and ``tp2d`` prefill logits) differ from one
device's by rounding; on one position the split path is the model's own
prefill and decode step bit for bit, and under ``fsdp`` with one batch
shard the prefill is one device's bit for bit.

BST's serve cells (:func:`make_sharded_click`, :func:`make_sharded_retrieval`)
take the per-batch-shard shape of ``fsdp``: the forward per batch shard at
its home, or the candidates per block at theirs, the outputs joined at
position 0.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.distrib.collectives import (HomeViews, LyingHead, Rows,
                                             ShardView, StationaryView,
                                             TPView, batch_groups, kv_heads,
                                             send)
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


def _stationary(params, mesh, tokens: torch.Tensor) -> Any:
    """``collectives.StationaryView`` s of every placed leaf; the table's
    holds the batch's ids at every position, each copied there from the
    host (as the reference's ``in_shardings`` replicate them)."""
    views = tree_map(lambda x: StationaryView(x)
                     if isinstance(x, ShardedTensor) else x, params)
    if isinstance(params.get("embed"), ShardedTensor):
        ids = []
        for pos in range(mesh.size):
            with mesh.at(pos):
                ids.append(tokens.to(mesh.device(pos)))
        views["embed"] = StationaryView(params["embed"], ids=ids)
    return views


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
                mesh.count("logits_gather", _nbytes(t), to=0, frm=h)
            out.append(t.to(dev0))
        return torch.cat(out, dim=0)


def _split(batch_spec) -> bool:
    """Whether ``batch_spec`` splits the batch over mesh axes."""
    return len(batch_spec) > 0 and batch_spec[0] is not None


def _tp_views(params, groups, step: str) -> Any:
    """``collectives.TPView.serving`` views of every placed leaf for a
    serving ``step`` with the batch split over ``groups``."""
    def views(key, tree):
        return tree_map(lambda x: TPView.serving(x, groups, step,
                                                 head=key == "head")
                        if isinstance(x, ShardedTensor) else x, tree)
    return {k: views(k, v) for k, v in params.items()}


def _all_rows(mesh, t: torch.Tensor, groups) -> Rows:
    """``t``'s rows cut into one equal batch shard per group, each copied
    to every position of its group: ``Rows`` over all the positions."""
    Bd = t.shape[0] // len(groups)
    parts = [None] * mesh.size
    for d, group in enumerate(groups):
        for pos in group:
            with mesh.at(pos):
                parts[pos] = t[d * Bd:(d + 1) * Bd].to(mesh.device(pos))
    return Rows(parts, list(range(mesh.size)), mesh)


def place_cache(mesh, spec, parts, capacity: int) -> Cache:
    """The batch shards' prefill caches as a cache of ``capacity`` ≥ S
    positions laid out by ``spec``. ``parts[d]`` lists where batch shard
    d's keys and values lie, as ``(position, first key-value head, k,
    v)`` with k and v (L, B/D, S, heads, hd) (one entry at the shard's
    home holding every head, or one per position of its group holding its
    heads under ``tp2d`` with the batch split). Each position's block is
    allocated there, zeros past S, and each head's part of the prompt is
    copied from the position itself where it holds that head, else from
    the first that does (``cache_scatter``)."""
    _, _, k0, _ = parts[0][0]
    Lyr, Bd, S, _, hd = k0.shape
    KV = max(lo + k.shape[3] for _, lo, k, _ in parts[0])
    shape = (Lyr, Bd * len(parts), capacity, KV, hd)
    lay = Layout(mesh, spec, shape)
    Bb, Sb = lay.block_shape[1], lay.block_shape[2]
    if lay.block_shape[3:] != (KV, hd):
        raise ValueError(f"cache spec {spec!r} splits the heads")
    out = ([], [])
    for pos in range(mesh.size):
        block = lay.block_of(pos)
        b0, s0 = block[1] * Bb, block[2] * Sb
        d = b0 // Bd
        if (b0 + Bb - 1) // Bd != d:
            raise ValueError(f"cache block rows {b0}..{b0 + Bb - 1} span "
                             f"two batch shards of {Bd} rows")
        r0, s1 = b0 - d * Bd, min(s0 + Sb, S)
        srcs = sorted(parts[d], key=lambda e: e[0] != pos)
        for which in (0, 1):
            with mesh.at(pos), mesh.moving():
                blk = torch.zeros(lay.block_shape, dtype=k0.dtype,
                                  device=mesh.device(pos))
                h = 0
                while s1 > s0 and h < KV:
                    frm, lo, *kv = next(e for e in srcs
                                        if e[1] <= h < e[1] + e[2].shape[3])
                    t = kv[which]
                    hi = lo + t.shape[3]
                    src = t[:, r0:r0 + Bb, s0:s1, h - lo:]
                    if frm != pos:
                        mesh.count("cache_scatter", _nbytes(src), to=pos,
                                   frm=frm)
                    blk[:, :, :s1 - s0, h:hi].copy_(src)
                    h = hi
            out[which].append(blk)
    return (ShardedTensor(lay, k0.dtype, out[0]),
            ShardedTensor(lay, k0.dtype, out[1]))


def _prefill_split(model, mesh, groups, params, tokens):
    """A ``tp2d`` prefill with the batch split (see the module's
    docstring): the logits at each batch shard's home, and per batch
    shard the positions of its group with the key-value heads each
    computed."""
    cfg = model.cfg
    lg, (ks, vs) = model.prefill(_tp_views(params, groups, "prefill"),
                                 _all_rows(mesh, tokens, groups))
    parts = []
    for group in groups:
        mine = []
        for pos in group:
            k = ks.parts[pos]
            lo = (0 if k.shape[3] == cfg.n_kv_heads else
                  kv_heads(mesh, pos, cfg.n_heads, cfg.n_kv_heads)[0])
            mine.append((pos, lo, k, vs.parts[pos]))
        parts.append(mine)
    return [lg.parts[g[0]] for g in groups], parts


def _prefill_fsdp(model, mesh, homes, groups, params, tokens, run: int):
    """An ``fsdp`` prefill: ``model.prefill`` at a home over its rows, the
    parameters gathered layer by layer there. Each run of ``run``
    consecutive batch shards (the shards one MoE group spans; one where
    the groups lie inside the shards) is computed at the run's first home
    over all its rows, so the reference's groups are formed over the same
    tokens; each other shard's last logits and keys and values then go to
    its own home (``prefill_span``). A table that the model looks up where
    its rows lie (``looks_up_in_place``) is looked up first, every run's
    tokens at once, as the reference looks its whole batch up
    (``HomeViews.take_rows``), and each run's prefill takes its rows. A
    head that stays where it lies (``head_in_place``) multiplies every
    run's last rows at once (``collectives.head_logits``: the logits at
    position 0; only the keys and values of a spanned shard go home). The
    logits, per batch shard where its keys and values lie
    (:func:`place_cache`'s ``parts``), and the position of each shard's
    logits."""
    D = len(homes)
    Bd = tokens.shape[0] // D
    runs = list(range(0, D, run))
    at = [homes[r] for r in runs]
    views, toks = [], []
    for r, home in zip(runs, at):
        with mesh.at(home):
            views.append(_views(params, home, groups[r]))
            toks.append(tokens[r * Bd:(r + run) * Bd].to(mesh.device(home)))
    table = HomeViews([v.get("embed") for v in views], at, mesh)
    rows = [None] * len(runs)
    if (isinstance(params.get("embed"), ShardedTensor)
            and model.looks_up_in_place(table)):
        with mesh.at(at[0]):
            rows = table.take_rows(Rows(toks, at, mesh),
                                   model.compute_dtype).parts
    key = "embed" if model.cfg.tie_embeddings else "head"
    head = HomeViews([v.get(key) for v in views], at, mesh)
    lies = model.head_in_place(head)
    logits, parts, lasts = [], [], []
    for r, home, view, tok, x in zip(runs, at, views, toks, rows):
        with mesh.at(home):
            lg, (k, v) = model.prefill(view, tok, x, last=lies)
        lasts.append(lg)
        for j in range(run):
            # a head that stays where it lies takes the run's last rows at
            # its home: only the keys and values go to a spanned shard
            mine = (k[:, j * Bd:(j + 1) * Bd], v[:, j * Bd:(j + 1) * Bd])
            if not lies:
                mine = (lg[j * Bd:(j + 1) * Bd],) + mine
            to = homes[r + j]
            if to != home:
                with mesh.at(to), mesh.moving():
                    for t in mine:
                        mesh.count("prefill_span", _nbytes(t), frm=home,
                                   to=to)
                    mine = tuple(t.to(mesh.device(to), copy=True)
                                 for t in mine)
            if not lies:
                logits.append(mine[0])
            parts.append([(to, 0, mine[-2], mine[-1])])
    if lies:
        # every run's last rows times the head's blocks at once, the
        # logits at position 0
        whole = LyingHead(head, transposed=model.cfg.tie_embeddings).logits(
            Rows(lasts, at, mesh))
        logits = [lg[j * Bd:(j + 1) * Bd] for lg in whole for j in range(run)]
        return logits, parts, [0] * D
    return logits, parts, homes


def make_sharded_prefill(model, mesh, batch_spec, cache_spec,
                         capacity: Optional[int] = None,
                         policy: str = "fsdp") -> Callable:
    """``prefill(params, tokens) → (logits, (k_cache, v_cache))``:
    ``model.prefill`` over ``params`` placed by the ``policy`` rules
    (:func:`place_params`) — under ``tp2d`` over every batch shard at once,
    the weights gathered along the batch axes with the batch split and
    where they lie with it whole, under ``fsdp`` once per batch shard at
    its home with each layer gathered there (once per run of the shards a
    MoE group spans, at the run's first home: :func:`_prefill_fsdp`) — the
    logits (B, 1, V) on
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
        # the batch shards a MoE group spans (raises where the groups
        # neither fit into nor span whole shards)
        run = model.moe_span(B, S, D) if policy == "fsdp" else 1
        with torch.no_grad():
            where = homes
            if policy == "tp2d" and _split(batch_spec):
                logits, parts = _prefill_split(model, mesh, groups, params,
                                               tokens)
            elif policy == "tp2d":
                lg, (ks, vs) = model.prefill(
                    _stationary(params, mesh, tokens),
                    _rows(mesh, tokens, homes))
                logits = lg.parts
                parts = [[(h, 0, k, v)]
                         for h, k, v in zip(homes, ks.parts, vs.parts)]
                del ks, vs
            else:
                logits, parts, where = _prefill_fsdp(model, mesh, homes,
                                                     groups, params, tokens,
                                                     run)
            cache = place_cache(mesh, cache_spec, parts,
                                S if capacity is None else capacity)
            del parts
            return _to_position_0(mesh, logits, where), cache

    return prefill


def _attend_split(model, mesh, groups, lay) -> Callable:
    """A decode step's attention with the batch split and every position
    holding all heads (``TPView`` s): each position writes the new token's
    keys and values into its block of the cache where its sequence slice
    holds ``cache_len`` and attends over its slice; the slices' (m, l, o)
    cross "model" (``attn_partial``) and every position adds them in
    ascending slice order with the log-sum-exp rescale. A cache whose
    sequence is not split is :meth:`TransformerLM._cache_attend`'s."""
    cd = model.compute_dtype
    shard = {p: d for d, g in enumerate(groups) for p in g}
    Bb, Sb = lay.block_shape[1], lay.block_shape[2]
    # each position's slice group: the positions holding its cache block's
    # rows, in ascending sequence slice
    key, slices = {}, {}
    for pos in range(mesh.size):
        block = lay.block_of(pos)
        if block[1] != shard[pos] or Bb * len(groups) != lay.shape[1]:
            raise ValueError(f"cache {lay.spec!r}: position {pos} holds "
                             f"batch block {block[1]}, not its batch shard "
                             f"{shard[pos]}")
        key[pos] = block[:2] + block[3:]
        slices.setdefault(key[pos], []).append((block[2], pos))
    order = {pos: [p for _, p in sorted(slices[key[pos]])]
             for pos in range(mesh.size)}

    def attend(i, q, k, v, cache, n):
        ks, vs = cache
        parts = {}
        for pos in range(mesh.size):
            s = lay.block_of(pos)[2]
            with mesh.at(pos):
                if s * Sb <= n < (s + 1) * Sb:
                    for src, kv in ((k, ks), (v, vs)):
                        kv.shards[pos][i, :, n - s * Sb].copy_(
                            src.parts[pos][:, 0].to(kv.dtype))
                kc = ks.shards[pos][i].to(cd)
                vc = vs.shards[pos][i].to(cd)
                qp = q.parts[pos]
                if len(order[pos]) == 1:
                    parts[pos] = L.decode_attention(
                        qp, kc, vc, cache_len=torch.full(
                            (qp.shape[0],), n + 1, dtype=torch.int32,
                            device=qp.device))
                else:
                    valid = min(max(n + 1 - s * Sb, 0), Sb)
                    parts[pos] = L.decode_attention_partial(qp, kc, vc,
                                                            valid)
        out = []
        for pos in range(mesh.size):
            if len(order[pos]) == 1:
                out.append(parts[pos])
                continue
            got = []
            with mesh.at(pos), mesh.moving():
                for src in order[pos]:
                    if src != pos:
                        mesh.count("attn_partial", sum(
                            _nbytes(t) for t in parts[src]), frm=src,
                            to=pos)
                    got.append(tuple(t.to(mesh.device(pos))
                                     for t in parts[src]))
            with mesh.at(pos):
                out.append(L.combine_attention_partials(
                    got, q.parts[pos].dtype))
        return Rows(out, list(range(mesh.size)), mesh)

    return attend


def make_sharded_decode(model, mesh, batch_spec) -> Callable:
    """``decode(params, token, cache, cache_len) → (logits, cache)``: one
    token per sequence (B, 1) at position ``cache_len`` (a Python int)
    against ``cache`` placed by ``lm_cache_specs`` (written in place),
    over ``params`` placed by their specs; the logits (B, 1, V) on
    position 0. With the batch split, ``model.decode_step`` runs at every
    position of each batch shard's group (the column blocks gathered along
    the batch axes, the rows moved to the row blocks and the head, the
    heads gathered over "model", the attention split over the group's
    cache slices); with it whole, at its home with the weights where they
    lie, the attention split over the cache's slices."""
    homes, groups = batch_groups(mesh, batch_spec[0] if len(batch_spec)
                                 else None)
    D = len(homes)
    home = homes[0]
    cd = model.compute_dtype

    def attend(i, q, k, v, cache, n):
        with mesh.at(home):
            return Rows([attend_home(i, q.parts[0], k.parts[0], v.parts[0],
                                     cache, n)], homes, mesh)

    def attend_home(i, q, k, v, cache, n):
        """Layer ``i``'s attention for the whole batch at ``home`` over the
        cache's sequence slices, each at its holder."""
        ks, vs = cache
        lay = ks.layout
        Sb = lay.block_shape[2]
        slices = sorted((blk[2], lay.holders(blk)[0]) for blk in lay.blocks())
        for (j, h) in slices:
            if j != n // Sb:
                continue
            for src, kv in ((k, ks), (v, vs)):
                src = src.to(kv.dtype)
                if h != home:
                    mesh.count("kv_write", _nbytes(src), to=h)
                with mesh.moving():
                    off = n - j * Sb
                    kv.shards[h][i, :, off:off + 1].copy_(src)
        parts = []
        for (j, h) in slices:
            if h != home:
                mesh.count("q_send", _nbytes(q), to=h)
            with mesh.moving():
                qh = q.to(mesh.device(h))
            with mesh.at(h):
                valid = min(max(n + 1 - j * Sb, 0), Sb)
                kc = ks.shards[h][i].to(cd)
                vc = vs.shards[h][i].to(cd)
                part = L.decode_attention_partial(qh, kc, vc, valid)
            if h != home:
                mesh.count("attn_partial", sum(_nbytes(t) for t in part),
                           to=home)
            with mesh.moving():
                parts.append(tuple(t.to(mesh.device(home)) for t in part))
        return L.combine_attention_partials(parts, q.dtype)

    def decode(params, token: torch.Tensor, cache: Cache, cache_len: int):
        n = int(cache_len)
        if token.shape[0] % D:
            raise ValueError(f"batch {token.shape[0]} does not split over "
                             f"{D} shards")
        with torch.no_grad():
            if _split(batch_spec):
                lg, _ = model.decode_step(
                    _tp_views(params, groups, "decode"),
                    _all_rows(mesh, token, groups), cache, n,
                    attend=_attend_split(model, mesh, groups,
                                         cache[0].layout))
                return _to_position_0(mesh, [lg.parts[h] for h in homes],
                                      homes), cache
            lg, _ = model.decode_step(_stationary(params, mesh, token),
                                      _rows(mesh, token, homes), cache, n,
                                      attend=attend)
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
