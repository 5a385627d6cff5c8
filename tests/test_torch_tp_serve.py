"""LM serving on the device mesh under ``tp2d``, on the CPU (meshes of
``["cpu"] * 4``, f32 SMOKE configs): with the batch whole, the weights
where they lie (``distrib/collectives.py``: ``StationaryView``, ``Rows``,
``block_matmul``, ``take_rows_two_axis``; ``distrib/serving.py``); with
it split over "data", as the reference's partitioner splits its jitted steps
(``TPView.serving``, ``tp_rows_linear``).

* ``block_matmul`` on 2 × 2, 1 × 2, 2 × 1, 1 × 4 (and 2 × 2 × 2 with
  "pod"), the batch whole and split over the batch axes, the weight split
  as the reference splits ``wq`` (P("data", "model")) and ``wo``
  (P("model", "data")), with and without a bias split like its columns:
  within 1e-6 of the largest entry of ``x @ w + b`` (f32 partial sums
  added in another order), two calls bitwise, and ``Mesh.bytes`` only
  ``tp_act`` / ``tp_partial``, each the count worked out from the rows,
  the shapes and which holder serves which home. On one position it is
  ``x @ w + b`` bit for bit.
* The two-axis lookup (``embed`` under ``tp2d``, P("model", "data")):
  bitwise ``take_rows`` of the whole table, negative, out-of-range and
  −0.0 rows included, through ``StationaryView.take_rows`` (the batch
  whole: ``emb_rows_model`` the partial rows reduce-scattered and
  all-gathered over each "model" line, ``emb_rows_home`` each home's rows
  of the column blocks it lacks) and the train step's ``TPView``; its
  backward sums each block's rows
  (``tests/test_torch_tp_train.py`` holds it bitwise, and each form's
  rows and −0.0 entries). The prefill's and decode step's lookup bytes
  by kind and axis a chip equal the reference's HLO collectives of the
  embedding's gather, to the byte, with the batch split and whole
  (``test_tp2d_lookup_moves_as_the_reference``), the port's own
  re-layouts (``emb_rows_relayout``, ``emb_rows_home``) apart.
* ``tp2d`` prefill and decode for the SMOKE configs of qwen3-moe with 16
  experts (GQA, experts over "model"), deepseek-7b (MHA, dense), qwen2-72b
  (QKV bias), smollm-135m (tied head, 3 heads over 2 "model" blocks) and
  dbrx-132b, with the batch whole (B 2) and split (B 16): prefill and
  decode logits within ``LOGIT_RTOL`` (1e-5 of the largest logit) of the
  one-device port, each one-device decode step reading the cache the mesh
  step left (``test_torch_sharded_serve.reading``: a bf16 cache entry
  one bf16 step apart moves later logits by more than the step's own
  rounding), the caches within one bf16 step on at most 0.5 % of their
  entries (``tests/test_torch_lm.py``'s bound); an independent one-device
  decode of the same tokens on its own cache within
  ``test_torch_sharded_serve.ALONE_TOL`` (2^-8 of the largest logit, one
  bf16 step) and the same cache bound; two runs bitwise; with the batch
  whole no parameter byte moved (no ``all_gather``; the lookup moves the
  batch's ids and rows only), with it split the bytes of the reference's
  split (below). Against the reference's JAX ``prefill`` /
  ``decode_step`` (weights through ``params_from_jax``) to
  ``tests/test_torch_lm.py``'s tolerances (logits rtol / atol 1e-4, bf16
  caches within one bf16 step on at most 0.5 % of entries).
* ``moe_block`` over ``Rows`` with the experts where they live and the
  batch whole: bitwise the unsharded block.
* With the batch split (B 16 above, B 4 below): every collective's bytes
  of a prefill and each decode step equal
  ``chip_smoke.serve_tp2d_bytes_want`` on (1, 2), (2, 1), (2, 2) and
  (1, 4) for the 16-expert qwen3-moe (``expert`` and ``ffn``) and smollm
  (an ``fsdp`` prefill's, the experts where they live under ``expert``,
  ``chip_smoke.serve_fsdp_bytes_want`` on (2, 2), (4, 1), (1, 4), (2, 1));
  the weights move along "data" only and the sums along "model" only; on
  one position the path is ``TransformerLM.prefill`` / ``decode_step``
  bit for bit; two runs bitwise. Against the reference's jitted
  ``prefill`` and ``decode_step`` under the ``tp2d`` ``in_shardings`` on a
  2 × 2 JAX mesh of four host devices (one child process), the batch
  split (B 4) and whole (B 1): logits to rtol 1e-4, the HLO's collective
  bytes read by kind and axis (weights gathered along "data" with the
  batch split, none with it whole) and printed beside the port's.
* Fault 7: an ``fsdp`` prefill on 2 × 2 whose MoE group (64 tokens, B 4 ×
  16) spans both batch shards runs both shards' rows at the first home:
  logits and cache bitwise the one-device prefill, within 1e-4 of the
  reference's jitted ``fsdp`` prefill (the same child), bytes
  ``chip_smoke.serve_fsdp_bytes_want``'s (``prefill_span``); groups that
  neither fit into nor span whole shards raise.

JAX is imported inside the tests that need it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.config.registry import get_arch
from repro_torch.configs import qwen3_moe_30b_a3b as qcfg
from repro_torch.distrib.collectives import (Rows, StationaryView,
                                             batch_groups, block_matmul)
from repro_torch.distrib.serving import (make_sharded_decode,
                                         make_sharded_prefill, place_params)
from repro_torch.distrib.sharding import (Layout, P, device_put, gather,
                                          lm_cache_specs, lm_param_specs)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as TM
from repro_torch.models.transformer import TransformerLM, params_from_jax
from repro_torch.sparse.segment import take_rows

import chip_smoke
from test_torch_sharded_serve import bf16_close, hold_alone, reading
from test_torch_tp_train import (HLO_AXES, REPO, _block_sum, _by_axis,
                                 _lookup, whole_lookup_bytes)

torch.set_num_threads(1)

LOGIT_RTOL = 1e-5
MATMUL_RTOL = 1e-6
MOE16 = dataclasses.replace(
    qcfg.SMOKE, moe=dataclasses.replace(qcfg.SMOKE.moe, n_experts=16))
CONFIGS = {"qwen3-moe-e16": MOE16,
           **{a: get_arch(a, smoke=True).model
              for a in ("deepseek-7b", "qwen2-72b", "smollm-135m",
                        "dbrx-132b")}}
# the collectives a tp2d serving step with the batch whole may count:
# activations, ids, the looked-up rows, the KV cache and the logits; never
# a parameter
ACTIVATIONS = {"tp_act", "tp_partial", "emb_rows_model", "emb_rows_home",
               "expert_send",
               "cache_scatter", "kv_write", "q_send", "attn_partial",
               "logits_gather"}
# with the batch split: the weights gathered along "data", the rows moved
# to the blocks that stay, the sums over "model", the heads, experts and
# attention partials over "model", the lookup, the cache and the logits
WEIGHT_MOVES = {"tp_zero_gather"}
SUM_MOVES = {"tp_model_sum"}
SPLIT = WEIGHT_MOVES | SUM_MOVES | {
    "tp_rows_gather", "tp_rows_scatter", "tp_heads_gather",
    "tp_logits_gather", "expert_gather", "emb_ids_permute", "emb_ids_gather",
    "emb_rows_model", "emb_rows_data", "emb_rows_relayout",
    "cache_scatter", "attn_partial", "logits_gather", "tp_resplit",
    "moe_group_probs", "moe_group_dispatch"}
MOE16_FFN = dataclasses.replace(
    MOE16, moe=dataclasses.replace(MOE16.moe, moe_shard="ffn"))
# the models the reference's serving HLO is read for, and the formula held
SPLIT_MODELS = {"qwen3-moe-e16": MOE16, "qwen3-moe-e16-ffn": MOE16_FFN,
                "smollm-135m": CONFIGS["smollm-135m"]}


def _mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return Mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def _rows(mesh, t, homes):
    Bd = t.shape[0] // len(homes)
    return Rows([t[d * Bd:(d + 1) * Bd] for d in range(len(homes))],
                list(homes), mesh)


def _server(mesh, lay, block, home):
    """The holder of ``block`` whose coordinates on the axes the layout's
    spec leaves out are ``home``'s."""
    used = {a for axes in lay.axes for a in axes}
    c = mesh.coords(home)
    (h,) = [p for p in lay.holders(block)
            if all(mesh.coords(p)[a] == c[a]
                   for a in mesh.axis_names if a not in used)]
    return h


# -- block_matmul ------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("spec", [P("data", "model"), P("model", "data")],
                         ids=["wq", "wo"])
@pytest.mark.parametrize("batch", ["whole", "split"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1), (1, 4),
                                   (2, 2, 2)],
                         ids=["2x2", "1x2", "2x1", "1x4", "2x2x2"])
def test_block_matmul(shape, batch, spec, bias):
    mesh = _mesh(shape)
    ba = ("pod", "data") if len(shape) == 3 else "data"
    homes, _ = batch_groups(mesh, ba if batch == "split" else None)
    rng = np.random.default_rng(len(homes) + sum(shape))
    B, S, n_in, n_out = 8, 3, 32, 48
    x = torch.from_numpy(rng.standard_normal((B, S, n_in))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n_in, n_out))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n_out).astype(np.float32))
    view = StationaryView(device_put(w, mesh, spec))
    bview = StationaryView(device_put(b, mesh, P(spec[1]))) if bias else None
    want = x @ w + b if bias else x @ w
    xs = _rows(mesh, x, homes)
    got = block_matmul(xs, view, torch.float32, bview)
    again = block_matmul(xs, view, torch.float32, bview)
    whole = torch.cat(got.parts)
    assert whole.shape == want.shape
    err = float((whole - want).abs().max())
    assert err <= MATMUL_RTOL * float(want.abs().max()), err
    assert all(torch.equal(p, q) for p, q in zip(got.parts, again.parts))
    # the bytes: each home's rows to each block's server, the partials back
    lay = Layout(mesh, spec, (n_in, n_out))
    D_in, D_out = lay.counts
    rows = B * S // len(homes)
    act = part = 0
    for block in lay.blocks():
        for home in homes:
            if _server(mesh, lay, block, home) != home:
                act += rows * n_in // D_in * 4
                part += rows * n_out // D_out * 4
    want_bytes = {k: 2 * v for k, v in (("tp_act", act), ("tp_partial", part))
                  if v}
    assert dict(mesh.bytes) == want_bytes
    assert sum(mesh.received.values()) == sum(want_bytes.values())


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "bias"])
def test_block_matmul_on_one_position_is_the_product(bias):
    mesh = Mesh((1, 1), ("data", "model"), ["cpu"])
    g = torch.Generator().manual_seed(3)
    x, w, b = (torch.randn(s, generator=g) for s in ((4, 5, 24), (24, 40),
                                                     (40,)))
    spec = P("data", "model")
    bview = StationaryView(device_put(b, mesh, P("model"))) if bias else None
    got = block_matmul(Rows([x], [0], mesh),
                       StationaryView(device_put(w, mesh, spec)),
                       torch.float32, bview)
    assert torch.equal(got.parts[0], x @ w + b if bias else x @ w)
    assert not mesh.bytes


# -- the two-axis lookup -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "1x4", "4x1"])
def test_two_axis_lookup_is_take_rows(shape):
    mesh = _mesh(shape)
    V, e = 24, 8
    table = torch.randn((V, e), generator=torch.Generator().manual_seed(1))
    table[5] = -0.0
    placed = device_put(table, mesh, P("model", "data"))
    ids = torch.tensor([[0, 5, 23, -1, -24, 24, -25, 11],
                        [7, 12, 6, 18, 3, 5, 0, 100],
                        [-5, 1, 2, 22, 17, 9, 13, -100],
                        [4, 4, 19, 20, 21, 8, 10, 14]], dtype=torch.int32)
    want = take_rows(table, ids)

    def same(got):
        assert got.shape == want.shape
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan], want[~nan])
        assert torch.equal(torch.signbit(got), torch.signbit(want))

    homes, _ = batch_groups(mesh, "data")
    got = StationaryView(placed, ids=[ids] * mesh.size).take_rows(
        _rows(mesh, ids, homes))
    same(torch.cat(got.parts))
    # every position looks the whole batch up in its block, each "model"
    # line reduce-scatters and all-gathers the partial rows, and each home
    # takes its rows of each column block it lacks
    assert dict(mesh.bytes) == whole_lookup_bytes(mesh, placed.layout,
                                                  homes, ids.numel(), 4)


def test_two_axis_lookup_has_a_backward():
    """The lookup of a table split on two axes differentiates (its backward
    landed with the ``tp2d`` train step; ``tests/test_torch_tp_train.py``
    holds it bitwise against ``take_rows``'s): through the train step's
    ``TPView`` each block's gradient is the sum of its rows' gradients,
    and only the lookup's own collectives move bytes, nothing gathered."""
    mesh = _mesh((2, 2))
    table = torch.randn(8, 4, generator=torch.Generator().manual_seed(4))
    ids = torch.tensor([[1, 2], [2, 7]])
    view, got, _ = _lookup(mesh, table, ids, "pinned")
    torch.autograd.backward([got.parts[p] for p in range(mesh.size)
                             if view.collects(p)],
                            [torch.ones_like(got.parts[p])
                             for p in range(mesh.size) if view.collects(p)])
    want = torch.zeros(8, 4)
    want[1], want[2], want[7] = 1.0, 2.0, 1.0
    assert torch.equal(_block_sum(view), want)
    assert set(mesh.bytes) == {"emb_ids_permute", "emb_ids_gather",
                               "emb_rows_model", "emb_rows_data",
                               "emb_grad_data"}


# -- tp2d prefill and decode -------------------------------------------------------

def _cfg_with_bias(cfg, params, seed=11):
    """Nonzero QKV biases where the config has them (the inits zero them)."""
    if cfg.qkv_bias:
        g = torch.Generator().manual_seed(seed)
        for lp in params["layers"]:
            for key in ("bq", "bk", "bv"):
                lp[key] = 0.1 * torch.randn(lp[key].shape, generator=g)
    return params


def _tp_served(cfg, params, B, S, tokens_out=4):
    """(one-device (logits, k, v) per step, each decode step reading the
    mesh's cache; the mesh's two runs, each (logits, k, v) per step and
    the bytes and the moves by (name, source, receiver) per step; the
    independent one-device run's (logits, k, v) per decode step, on its
    own cache) of a tp2d prefill and ``tokens_out`` teacher-forced decode
    steps."""
    mesh = _mesh((2, 2))
    wide = B >= 16
    bspec = P("data", None) if wide else P(None, None)
    gs = min(4096, max(64, B * S // 8))
    model = TransformerLM(cfg, moe_group_size=gs,
                          act_spec=P("data", None, None) if wide else None)
    plain = TransformerLM(cfg, moe_group_size=gs)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    lg, (ks, vs) = plain.prefill(params, tokens)
    want = [(lg, ks.clone(), vs.clone())]
    ks = F.pad(ks, (0, 0, 0, 0, 0, tokens_out))
    vs = F.pad(vs, (0, 0, 0, 0, 0, tokens_out))
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "tp2d"))
    prefill = make_sharded_prefill(model, mesh, bspec,
                                   lm_cache_specs(False, B),
                                   capacity=S + tokens_out, policy="tp2d")
    decode = make_sharded_decode(model, mesh, bspec)
    runs, own, alone = [], (ks.clone(), vs.clone()), []
    for _ in range(2):
        mesh.reset_bytes()
        glg, cache = prefill(placed, tokens)
        got = [(glg, gather(cache[0])[:, :, :S], gather(cache[1])[:, :, :S])]
        nbytes = [(dict(mesh.bytes), dict(mesh.moves))]
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        for i in range(tokens_out):
            mesh.reset_bytes()
            glg, cache = decode(placed, tok, cache, S + i)
            nbytes.append((dict(mesh.bytes), dict(mesh.moves)))
            gk, gv = gather(cache[0]), gather(cache[1])
            if not runs:
                wlg, _ = plain.decode_step(params, tok, None, S + i,
                                           attend=reading((gk, gv),
                                                          (ks, vs)))
                want.append((wlg, ks.clone(), vs.clone()))
                alg, own = plain.decode_step(params, tok, own, S + i)
                alone.append((alg, own[0].clone(), own[1].clone()))
            got.append((glg, gk, gv))
            tok = torch.argmax(want[i + 1][0], dim=-1).to(torch.int32)
        runs.append((got, nbytes))
    return want, runs, alone


def _lookup_bytes(cfg, n):
    """``emb_rows_model`` and ``emb_rows_home`` of one lookup of n ids with
    the batch whole in the (V, d) table on the 2 × 2 mesh (P("model",
    "data"): four blocks), the rows in the compute dtype: each of the 4
    positions receives, in the reduce-scatter and the all-gather over its
    "model" line of 2, half of the other vocab block's partial rows of all
    n ids (d / 2 wide) each time, the home the other column block's n
    rows."""
    c = 2 if cfg.dtype == "bfloat16" else 4
    return {"emb_rows_model": 4 * n * cfg.d_model // 2 * c,
            "emb_rows_home": n * cfg.d_model // 2 * c}


def _along(mesh, moves, names, axis):
    """Whether every move of ``names`` runs between positions that differ
    on ``axis`` only."""
    other = "model" if axis == "data" else "data"
    return all(mesh.coords(a)[other] == mesh.coords(b)[other]
               and mesh.coords(a)[axis] != mesh.coords(b)[axis]
               for (n, a, b) in moves if n in names)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("B,S", [(2, 16), (16, 8)], ids=["whole", "split"])
def test_tp2d_prefill_and_decode(name, B, S):
    """The batch whole: no parameter byte moves. The batch split over
    "data" (B 16): the reference's split, each step's bytes by name equal
    to ``chip_smoke.serve_tp2d_bytes_want``, the weights moving along
    "data" only and the sums along "model" only."""
    cfg = CONFIGS[name]
    params = _cfg_with_bias(cfg, TransformerLM(cfg).init(
        torch.Generator().manual_seed(0)))
    want, runs, alone = _tp_served(cfg, params, B, S)
    (got, nbytes), (again, _) = runs
    for step, ((wlg, wk, wv), (glg, gk, gv)) in enumerate(zip(want, got)):
        scale = float(wlg.abs().max())
        err = float((glg - wlg).abs().max())
        assert err <= LOGIT_RTOL * scale, (step, err, scale)
        for w, g in ((wk, gk), (wv, gv)):
            bf16_close(g, w)
    hold_alone(got[1:], alone)
    for a, b in zip(got, again):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    if B < 16:
        for i, (step, _) in enumerate(nbytes):
            assert set(step) <= ACTIVATIONS, step
            assert step["tp_act"] > 0 and step["tp_partial"] > 0
            for k, v in _lookup_bytes(cfg, B * S if i == 0 else B).items():
                assert step[k] == v, (k, step[k], v)
        if cfg.moe is not None and cfg.moe.n_experts % 16 == 0:
            assert all(step["expert_send"] > 0 for step, _ in nbytes)
        return
    mesh = _mesh((2, 2))
    gs = min(4096, max(64, B * S // 8))
    for i, (step, moves) in enumerate(nbytes):
        kind = "prefill" if i == 0 else "decode"
        assert step == chip_smoke.serve_tp2d_bytes_want(
            cfg, (2, 2), B, S, kind, gs, S + 4), (kind, step)
        assert set(step) <= SPLIT and step["tp_zero_gather"] > 0
        assert _along(mesh, moves, WEIGHT_MOVES, "data")
        assert _along(mesh, moves, SUM_MOVES, "model")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tp2d_serving_matches_the_reference(name):
    """tp2d prefill (the batch whole, the cache split over all four
    positions) and one decode step against the reference's JAX model fed
    the same weights."""
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import TransformerLM as RLM

    from test_torch_lm import _assert_bf16_cache_close, _jax_cfg
    cfg = CONFIGS[name]
    rmodel = RLM(_jax_cfg(cfg))
    tree = jax.tree_util.tree_map(np.asarray,
                                  rmodel.init(jax.random.PRNGKey(0)))
    if cfg.qkv_bias:
        rng = np.random.default_rng(11)
        for key in ("bq", "bk", "bv"):
            tree["layers"][key] = 0.1 * rng.standard_normal(
                tree["layers"][key].shape).astype(np.float32)
    params = params_from_jax(cfg, tree, device="cpu")
    mesh = _mesh((2, 2))
    model = TransformerLM(cfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "tp2d"))
    prefill = make_sharded_prefill(model, mesh, P(None, None),
                                   lm_cache_specs(False, 2), capacity=16,
                                   policy="tp2d")
    lg, cache = prefill(placed, torch.from_numpy(toks))
    rlg, (rk, rv) = rmodel.prefill(tree, toks)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=1e-4,
                               atol=1e-4)
    for got, want in zip(cache, (rk, rv)):
        _assert_bf16_cache_close(gather(got)[:, :, :12], want)
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    tok = np.array([[7], [3]], np.int32)
    rlg, _ = rmodel.decode_step(tree, jnp.asarray(tok),
                                (jnp.pad(rk, pad), jnp.pad(rv, pad)),
                                jnp.asarray(12, jnp.int32))
    decode = make_sharded_decode(model, mesh, P(None, None))
    mesh.reset_bytes()
    lg, _ = decode(placed, torch.from_numpy(tok), cache, 12)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=1e-4,
                               atol=1e-4)
    assert set(mesh.bytes) <= ACTIVATIONS


# -- the MoE block with the experts where they live ---------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
def test_moe_block_over_rows_is_the_unsharded_block(shape):
    """The batch whole (one home): the router whole at the home, the
    experts over "model" where they live; y and aux bitwise the unsharded
    block's."""
    cfg = MoEConfig(n_experts=16, top_k=4, d_ff_expert=24)
    g = torch.Generator().manual_seed(7)
    params = TM.init_moe_params(g, cfg, 16)
    x = torch.randn((48, 16), generator=g)
    y0, a0 = TM.moe_block(x, params, cfg, 2)
    mesh = _mesh(shape)
    views = {k: StationaryView(device_put(
        v, mesh, P(None, None) if k == "router" else P("model", None, None)))
        for k, v in params.items()}
    y1, a1 = TM.moe_block(Rows([x], [0], mesh), views, cfg, 2)
    assert torch.equal(y1.parts[0], y0) and torch.equal(a1.parts[0], a0)
    assert set(mesh.bytes) == {"expert_send"}


# -- with the batch split: the reference's split ------------------------------------

def _split_run(cfg, shape, B=4, S=16, tokens_out=4, params=None):
    """A tp2d prefill and ``tokens_out`` decode steps with the batch split
    over "data" on a ``shape`` mesh (the cache's sequence over "model"):
    the logits of each step, the cache after the prefill and after the
    last step (gathered), each step's bytes by name. The decode steps feed
    the one-device model's greedy tokens of the prompt's prefill, then
    token 0."""
    mesh = _mesh(shape)
    if params is None:
        params = TransformerLM(cfg).init(torch.Generator().manual_seed(0))
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None))
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "tp2d"))
    cspec = P(None, "data", "model", None, None)
    prefill = make_sharded_prefill(model, mesh, P("data", None), cspec,
                                   capacity=S + tokens_out, policy="tp2d")
    decode = make_sharded_decode(model, mesh, P("data", None))
    lg, cache = prefill(placed, tokens)
    logits, nbytes = [lg], [dict(mesh.bytes)]
    caches = [tuple(gather(c) for c in cache)]
    tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    for i in range(tokens_out):
        mesh.reset_bytes()
        lg, cache = decode(placed, tok, cache, S + i)
        logits.append(lg)
        nbytes.append(dict(mesh.bytes))
        tok = torch.zeros_like(tok)
    caches.append(tuple(gather(c) for c in cache))
    return tokens, logits, caches, nbytes


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)],
                         ids=["1x2", "2x1", "2x2", "1x4"])
@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_tp2d_serve_bytes_by_formula(name, shape):
    """A prefill's and each decode step's bytes by name equal to
    ``chip_smoke.serve_tp2d_bytes_want`` (the formula chip_smoke.py holds
    the card's runs to)."""
    cfg = SPLIT_MODELS[name]
    _, _, _, nbytes = _split_run(cfg, shape)
    for i, step in enumerate(nbytes):
        kind = "prefill" if i == 0 else "decode"
        assert step == chip_smoke.serve_tp2d_bytes_want(
            cfg, shape, 4, 16, kind, 16, 20), (kind, step)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4), (2, 1)],
                         ids=["2x2", "4x1", "1x4", "2x1"])
@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_fsdp_prefill_bytes_by_formula(name, shape):
    """An ``fsdp`` prefill with the batch split over "data" (the prefill
    cell's default, serve-sharded-lm (ii)'s prefill): its bytes by name
    equal to ``chip_smoke.serve_fsdp_bytes_want``."""
    cfg = SPLIT_MODELS[name]
    mesh = _mesh(shape)
    B, S = 16, 8
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None))
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    prefill = make_sharded_prefill(model, mesh, P("data", None),
                                   lm_cache_specs(False, B), capacity=S + 4)
    prefill(place_params(params, mesh, lm_param_specs(params, cfg, "fsdp")),
            tokens)
    assert dict(mesh.bytes) == chip_smoke.serve_fsdp_bytes_want(
        cfg, shape, B, S, 16, S + 4, tokens.element_size())


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_tp2d_split_serving_on_one_position_is_the_model(name):
    """On a (1, 1) mesh the split path is ``TransformerLM.prefill`` and
    ``decode_step`` bit for bit: logits and caches."""
    cfg = SPLIT_MODELS[name]
    params = TransformerLM(cfg).init(torch.Generator().manual_seed(0))
    tokens, logits, caches, nbytes = _split_run(cfg, (1, 1), params=params)
    plain = TransformerLM(cfg, moe_group_size=16)
    lg, (ks, vs) = plain.prefill(params, tokens)
    assert torch.equal(logits[0], lg)
    assert torch.equal(caches[0][0][:, :, :16], ks)
    assert torch.equal(caches[0][1][:, :, :16], vs)
    ks, vs = (F.pad(c, (0, 0, 0, 0, 0, 4)) for c in (ks, vs))
    tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    for i, got in enumerate(logits[1:]):
        want, (ks, vs) = plain.decode_step(params, tok, (ks, vs), 16 + i)
        assert torch.equal(got, want), i
        tok = torch.zeros_like(tok)
    assert torch.equal(caches[1][0], ks) and torch.equal(caches[1][1], vs)
    assert not any(nbytes)


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_tp2d_split_serving_repeats_bitwise(name):
    """Two runs of the split path on 2 × 2: logits, caches and bytes bit
    for bit the same."""
    cfg = SPLIT_MODELS[name]
    a, b = (_split_run(cfg, (2, 2)) for _ in range(2))
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    for x, y in zip(a[2], b[2]):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert a[3] == b[3]


# -- against the reference's jitted prefill and decode -------------------------------

_SERVE_CHILD = HLO_AXES + r'''
import json, sys
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.config.base import MoEConfig, TransformerConfig
from repro.distrib.sharding import lm_param_specs
from repro.models.transformer import TransformerLM

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
ns = lambda s: NamedSharding(mesh, s)
out = {}
for case in json.loads(sys.argv[1]):
    kw = dict(case["cfg"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    cfg = TransformerConfig(**kw)
    split = case["split"]
    model = TransformerLM(cfg, moe_group_size=case.get("group", 16),
                          act_spec=P("data", None, None) if split else None)
    params = model.init(jax.random.PRNGKey(0))
    psh = jax.tree.map(ns, lm_param_specs(params, cfg,
                                          case.get("policy", "tp2d")))
    bs = ns(P("data", None) if split else P(None, None))
    cs = ns(P(None, "data", "model", None, None) if split
            else P(None, None, ("data", "model"), None, None))
    prefill = jax.jit(model.prefill, in_shardings=(psh, bs))
    decode = jax.jit(model.decode_step,
                     in_shardings=(psh, bs, (cs, cs), ns(P())))
    tokens = np.array(case["tokens"], np.int32)
    S = tokens.shape[1]
    if "token" not in case:             # a prefill alone
        with mesh:
            lg, _ = prefill(params, tokens)
            text = prefill.lower(params, tokens).compile().as_text()
        out[case["id"]] = {"prefill": np.asarray(lg, np.float32).tolist(),
                           "hlo": {"prefill": read_hlo(text), "weights": {
                               "prefill": weight_gathers(text)}, "lookup": {
                               "prefill": lookup_collectives(
                                   text, *LM_LOOKUP)}, "head": {
                               "prefill": head_collectives(
                                   text, PREFILL_HEAD)}}}
        continue
    token = np.array(case["token"], np.int32)
    with mesh:
        lg, (k, v) = prefill(params, tokens)
        pad = ((0, 0), (0, 0), (0, case["extra"]), (0, 0), (0, 0))
        cache = tuple(np.pad(np.asarray(c), pad) for c in (k, v))
        n = jnp.asarray(S, jnp.int32)
        dlg, _ = decode(params, token, cache, n)
        texts = {"prefill": prefill.lower(params, tokens).compile()
                 .as_text(),
                 "decode": decode.lower(params, token, cache, n).compile()
                 .as_text()}
        hlo = {k: read_hlo(t) for k, t in texts.items()}
        hlo["weights"] = {k: weight_gathers(t) for k, t in texts.items()}
        hlo["lookup"] = {k: lookup_collectives(t, *LM_LOOKUP)
                         for k, t in texts.items()}
    out[case["id"]] = {"prefill": np.asarray(lg, np.float32).tolist(),
                       "decode": np.asarray(dlg, np.float32).tolist(),
                       "hlo": hlo}
print("OUT " + json.dumps(out))
'''


def _serve_case(name, batch):
    cfg = SPLIT_MODELS[name]
    B = 4 if batch == "split" else 1
    rng = np.random.default_rng(5)
    return {"id": f"{name}-{batch}", "cfg": dataclasses.asdict(cfg),
            "split": batch == "split", "extra": 4,
            "tokens": rng.integers(0, cfg.vocab_size, (B, 16)).tolist(),
            "token": rng.integers(0, cfg.vocab_size, (B, 1)).tolist()}


# fault 6's input: B 16 with the batch split over "data" on 2 × 2, one MoE
# group of 16 tokens at a decode step spanning both batch shards; every row
# row 0's tokens (the two shards' tokens pick the same experts, so each
# expert's 8 slots overflow), or distinct random rows
FAULT6 = {"expert-same": ("qwen3-moe-e16", True),
          "ffn-same": ("qwen3-moe-e16-ffn", True),
          "expert-random": ("qwen3-moe-e16", False)}


def _fault6_case(key):
    name, same = FAULT6[key]
    cfg = SPLIT_MODELS[name]
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (16, 16))
    token = rng.integers(0, cfg.vocab_size, (16, 1))
    if same:
        tokens[:], token[:] = tokens[0], token[0]
    return {"id": f"fault6-{key}", "cfg": dataclasses.asdict(cfg),
            "split": True, "extra": 4, "tokens": tokens.tolist(),
            "token": token.tolist()}


# fault 7's input: an ``fsdp`` prefill of B 4 × 16 with the batch split over
# "data" on 2 × 2 and ``moe_group_size`` 64, so one group of 64 tokens
# spans both batch shards (32 tokens each); every row row 0's (each picked
# expert's 16 slots overflow) or distinct random rows
FAULT7 = {"expert-same": ("qwen3-moe-e16", True),
          "ffn-same": ("qwen3-moe-e16-ffn", True),
          "expert-random": ("qwen3-moe-e16", False)}
FAULT7_GROUP = 64


def _fault7_case(key):
    name, same = FAULT7[key]
    cfg = SPLIT_MODELS[name]
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 16))
    if same:
        tokens[:] = tokens[0]
    return {"id": f"fault7-{key}", "cfg": dataclasses.asdict(cfg),
            "split": True, "policy": "fsdp", "group": FAULT7_GROUP,
            "extra": 4, "tokens": tokens.tolist()}


def _fsdp_prefill_case(name):
    """An ``fsdp`` prefill alone of B 4 × 16 random tokens, the batch split
    over "data" on 2 × 2, groups of 16 (inside the batch shards)."""
    cfg = SPLIT_MODELS[name]
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (4, 16))
    return {"id": f"fsdp-{name}", "cfg": dataclasses.asdict(cfg),
            "split": True, "policy": "fsdp", "extra": 4,
            "tokens": tokens.tolist()}


@pytest.fixture(scope="module")
def reference_serving():
    """The reference's jitted ``prefill`` and ``decode_step`` of every case
    under the ``tp2d`` ``in_shardings`` (fault 7's prefill and the three
    models' ``fsdp`` prefill alone, under the ``fsdp`` ones) on a 2 × 2
    JAX mesh of four host devices (one child
    process): logits, the compiled HLO's collective bytes a chip by kind
    and axis, and its weight gathers along "data" a chip (``weights``),
    per case id."""
    pytest.importorskip("jax")
    cases = ([_serve_case(n, b) for n in sorted(SPLIT_MODELS)
              for b in ("split", "whole")]
             + [_fault6_case(k) for k in sorted(FAULT6)]
             + [_fault7_case(k) for k in sorted(FAULT7)]
             + [_fsdp_prefill_case(n) for n in sorted(SPLIT_MODELS)])
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(_SERVE_CHILD), json.dumps(cases)],
                         env=env, capture_output=True, text=True, cwd=REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("OUT "))
    return {c["id"]: c for c in cases}, json.loads(line[4:])


@pytest.mark.parametrize("batch", ["split", "whole"])
@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_tp2d_serving_splits_as_the_reference_jitted_steps(
        reference_serving, name, batch):
    """The reference's jitted ``prefill`` and ``decode_step`` under a 2 × 2
    JAX mesh with the ``tp2d`` ``in_shardings`` (XLA's partitioner places
    each product) against the port's ``make_sharded_prefill(policy=
    "tp2d")`` and ``make_sharded_decode`` on 2 × 2 with the same weights:
    the prefill's and one decode step's logits to rtol 1e-4 (f32). With
    the batch split over "data" (B 4) the reference's HLO gathers weights
    along "data" and the port's weight bytes move along "data" only and
    its sums along "model" only (none of the stationary products' moves);
    with it whole (B 1) neither moves a weight: the reference gathers
    nothing along "data" but the rows, and the port moves no parameter
    byte. Both sides' bytes by kind or name and axis are printed
    (``-s``)."""
    import jax
    from repro.models.transformer import TransformerLM as RLM
    from test_torch_lm import _jax_cfg
    cases, ref = reference_serving
    case, want = cases[f"{name}-{batch}"], ref[f"{name}-{batch}"]
    cfg = SPLIT_MODELS[name]
    split = batch == "split"
    tree = jax.tree_util.tree_map(np.asarray, RLM(_jax_cfg(cfg)).init(
        jax.random.PRNGKey(0)))
    params = params_from_jax(cfg, tree, device="cpu")
    mesh = _mesh((2, 2))
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None) if split else None)
    bspec = P("data", None) if split else P(None, None)
    cspec = (P(None, "data", "model", None, None) if split
             else P(None, None, ("data", "model"), None, None))
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "tp2d"))
    tokens = torch.tensor(case["tokens"], dtype=torch.int32)
    token = torch.tensor(case["token"], dtype=torch.int32)
    S = tokens.shape[1]
    prefill = make_sharded_prefill(model, mesh, bspec, cspec,
                                   capacity=S + case["extra"],
                                   policy="tp2d")
    decode = make_sharded_decode(model, mesh, bspec)
    lg, cache = prefill(placed, tokens)
    pre = _by_axis(mesh, mesh.moves)
    pre_bytes = dict(mesh.bytes)
    mesh.reset_bytes()
    dlg, _ = decode(placed, token, cache, S)
    dec = _by_axis(mesh, mesh.moves)
    dec_bytes = dict(mesh.bytes)
    print(f"\n{name}, batch {batch}: reference HLO, bytes a chip by kind "
          f"and axis: prefill {want['hlo']['prefill']}; decode "
          f"{want['hlo']['decode']}\nthe port, bytes by name: prefill "
          f"{pre_bytes}; decode {dec_bytes}; by name and axis (the moves "
          f"that name both ends): prefill {pre}; decode {dec}")
    np.testing.assert_allclose(lg.numpy(), np.array(want["prefill"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dlg.numpy(), np.array(want["decode"]),
                               rtol=1e-4, atol=1e-4)
    params_bytes = sum(int(np.asarray(x).nbytes)
                       for x in jax.tree_util.tree_leaves(tree))
    if split:
        # the decode step's weight bytes along "data" a position: the
        # reference's all-gathers of weight blocks (its router is permuted
        # between the off-diagonal positions, the port's re-split as
        # ``tp_resplit``, neither along "data")
        assert dec_bytes["tp_zero_gather"] // 4 == \
            want["hlo"]["weights"]["decode"], (dec_bytes, want["hlo"])
        assert dec_bytes.get("tp_resplit", 0) == (
            2 * 2 * 32 * 16 * 4 if cfg.moe else 0)
    for hlo, moved, by_axis in ((want["hlo"]["prefill"], pre_bytes, pre),
                                (want["hlo"]["decode"], dec_bytes, dec)):
        if split:
            assert hlo.get("all-gather data", 0) > 0
            assert set(moved) <= SPLIT and moved["tp_zero_gather"] > 0
            assert all(k.endswith(" data") for k in by_axis
                       if k.split()[0] in WEIGHT_MOVES)
            assert all(k.endswith(" model") for k in by_axis
                       if k.split()[0] in SUM_MOVES)
        else:
            # the reference's "data" gathers move rows, not weights
            assert hlo.get("all-gather data", 0) < params_bytes / 1000
            assert set(moved) <= ACTIVATIONS, moved


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("batch", ["split", "whole"])
@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_tp2d_lookup_moves_as_the_reference(reference_serving, name, batch,
                                            step):
    """The serving steps' lookup against the reference's jitted
    ``prefill`` and ``decode_step`` on the 2 × 2 mesh (B 4 split over
    "data", B 1 whole; 16 prompt positions): the port's lookup bytes by
    kind and axis a chip (``test_torch_tp_train.lookup_by_kind``) equal,
    to the byte, the HLO's collectives of the embedding's gather. With the
    batch split: the ids permuted and gathered along "model", the partial
    rows all-reduced over "model", and in the prefill, which the
    reference pins, the rows' all-to-all along "data"; a decode step's
    rows are left split by column, and the port re-lays them out into its
    batch shards (``emb_rows_relayout``, along "data", its own). With the
    batch whole only the all-reduce over "model"; the port's home then
    takes its rows of the other column block (``emb_rows_home``)."""
    from test_torch_tp_train import lookup_by_kind
    cases, ref = reference_serving
    case, want = cases[f"{name}-{batch}"], ref[f"{name}-{batch}"]
    cfg = SPLIT_MODELS[name]
    split = batch == "split"
    params = TransformerLM(cfg).init(torch.Generator().manual_seed(0))
    mesh = _mesh((2, 2))
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None) if split else None)
    bspec = P("data", None) if split else P(None, None)
    cspec = (P(None, "data", "model", None, None) if split
             else P(None, None, ("data", "model"), None, None))
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "tp2d"))
    tokens = torch.tensor(case["tokens"], dtype=torch.int32)
    token = torch.tensor(case["token"], dtype=torch.int32)
    S = tokens.shape[1]
    prefill = make_sharded_prefill(model, mesh, bspec, cspec,
                                   capacity=S + case["extra"],
                                   policy="tp2d")
    _, cache = prefill(placed, tokens)
    if step == "decode":
        mesh.reset_bytes()
        make_sharded_decode(model, mesh, bspec)(placed, token, cache, S)
    got, own = lookup_by_kind(mesh, mesh.moves)
    print(f"\n{name}, batch {batch}, {step}: the reference HLO's lookup "
          f"{want['hlo']['lookup'][step]}; the port {got}, its own "
          f"re-layout {own}")
    assert got == want["hlo"]["lookup"][step]
    c, d = 2 if cfg.dtype == "bfloat16" else 4, cfg.d_model
    rows = (4 // 2 if split else 1) * (S if step == "prefill" else 1)
    if split and step == "prefill":
        assert not own
    else:
        assert own == {"emb_rows_relayout" if split else "emb_rows_home":
                       (4 if split else 1) * rows * d // 2 * c}


def _fsdp_prefill_lookup(reference_serving, name):
    """The port's ``fsdp`` prefill of :func:`_fsdp_prefill_case`'s tokens:
    the reference's reading of its lookup, the port's lookup bytes by kind
    and axis a chip (``test_torch_tp_train.lookup_by_kind``) and its own
    moves, its bytes, and the logits checked within rtol 1e-4 of the
    reference's; every ``emb_*`` byte is
    ``chip_smoke.fsdp_lookup_want``'s."""
    import jax
    from repro.models.transformer import TransformerLM as RLM
    from test_torch_lm import _jax_cfg
    from test_torch_tp_train import lookup_by_kind
    cases, ref = reference_serving
    case, want = cases[f"fsdp-{name}"], ref[f"fsdp-{name}"]
    cfg = SPLIT_MODELS[name]
    tree = jax.tree_util.tree_map(np.asarray, RLM(_jax_cfg(cfg)).init(
        jax.random.PRNGKey(0)))
    params = params_from_jax(cfg, tree, device="cpu")
    mesh = _mesh((2, 2))
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None))
    tokens = torch.tensor(case["tokens"], dtype=torch.int32)
    B, S = tokens.shape
    prefill = make_sharded_prefill(model, mesh, P("data", None),
                                   P(None, "data", "model", None, None),
                                   capacity=S + 4)
    lg, _ = prefill(place_params(params, mesh,
                                 lm_param_specs(params, cfg, "fsdp")), tokens)
    got, own = lookup_by_kind(mesh, mesh.moves)
    read = want["hlo"]["lookup"]["prefill"]
    print(f"\n{name}, fsdp prefill: the reference HLO's lookup {read}; the "
          f"port {got}, its own moves {own}")
    assert {k: v for k, v in mesh.bytes.items() if k.startswith("emb_")} \
        == chip_smoke.fsdp_lookup_want(cfg, (2, 2),
                                       [[(0, B // 2 * S), (1, B // 2 * S)]],
                                       False)
    np.testing.assert_allclose(lg.numpy(), np.array(want["prefill"]),
                               rtol=1e-4, atol=1e-4)
    return read, got, own, mesh


# the reference's reading of smollm's tied table in the ``fsdp`` prefill,
# stated as it was read when the port gathered the table for its head
FSDP_PREFILL_TIED_READ = {"all-gather data": 128, "all-reduce both": 24576}


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_fsdp_prefill_lookup_moves_as_the_reference(reference_serving,
                                                    name):
    """The ``fsdp`` prefill's lookup (the prefill cell's default, B 4 × 16
    split over "data" on 2 × 2, the table P(("data", "model"), None);
    smollm's tied one too, looked up where it lies since its head stays
    where it lies, its reading ``FSDP_PREFILL_TIED_READ``) against the
    reference's jitted ``fsdp`` prefill: the port's lookup bytes by kind
    and axis a chip (``test_torch_tp_train.lookup_by_kind``) equal, to the
    byte, the HLO's collectives of the embedding's gather: the ids'
    all-gather along "data" and the partial rows' all-reduce over both
    axes, the two batch shards looked up at once; apart, the port's own
    move of each batch shard's ids from its home to its group
    (``emb_ids_home``). Every ``emb_*`` byte is
    ``chip_smoke.fsdp_lookup_want``'s, and the logits are within rtol
    1e-4 of the reference's."""
    read, got, own, _ = _fsdp_prefill_lookup(reference_serving, name)
    assert got == read
    assert set(got) == {"all-gather data", "all-reduce both"}
    assert set(own) == {"emb_ids_home"}
    if SPLIT_MODELS[name].tie_embeddings:
        assert read == FSDP_PREFILL_TIED_READ


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_fsdp_prefill_head_moves_as_the_reference(reference_serving, name):
    """The ``fsdp`` prefill's logits (B 4 × 16 over "data" on 2 × 2, the
    head P(None, ("data", "model")), smollm's tied table read as its
    transpose) against the reference's jitted ``fsdp`` prefill: the
    port's head bytes by kind and axis a chip
    (``test_torch_tp_train.head_by_kind``) equal, to the byte, the HLO's
    collectives of ``hidden @ self._head_w(params)`` (``PREFILL_HEAD``):
    the last rows all-gathered along "data", each position forming its
    vocab block's logits; apart, the port's own moves (the rows from each
    home to its group, ``head_rows_home``; the blocks' logits to position
    0, ``logits_gather``, where the reference leaves them where they lie).
    Neither the head nor a tied table is gathered; the bytes are
    ``chip_smoke.serve_fsdp_bytes_want``'s, and the logits within rtol
    1e-4 of the reference's."""
    from test_torch_tp_train import head_by_kind
    cases, ref = reference_serving
    read = ref[f"fsdp-{name}"]["hlo"]["head"]["prefill"]
    _, _, _, mesh = _fsdp_prefill_lookup(reference_serving, name)
    fwd, bwd, own = head_by_kind(mesh, mesh.moves)
    print(f"\n{name}, fsdp prefill: the reference HLO's head {read}; the "
          f"port {fwd}, its own moves {own}")
    assert fwd == read == {"all-gather data": read["all-gather data"]}
    assert not bwd and set(own) == {"head_rows_home"}
    B, S = np.array(cases[f"fsdp-{name}"]["tokens"]).shape
    assert dict(mesh.bytes) == chip_smoke.serve_fsdp_bytes_want(
        SPLIT_MODELS[name], (2, 2), B, S, 16, S + 4)
    # the parent's form gathered the head (a tied table) at each of the 2
    # homes, 3 of its 4 blocks each
    cfg = SPLIT_MODELS[name]
    gathered = chip_smoke.serve_fsdp_bytes_want(
        cfg, (2, 2), B, S, 16, S + 4, act_spec=False).get("all_gather", 0)
    assert gathered - mesh.bytes.get("all_gather", 0) == \
        2 * 3 * cfg.vocab_size * cfg.d_model * 4 // 4


@pytest.mark.parametrize("key", sorted(FAULT6))
def test_split_decode_routes_one_group_over_the_batch(reference_serving,
                                                      key):
    """Fault 6: with the batch split over "data" a decode step's MoE group
    (16 tokens, ``moe_group_size`` 16, B 16) spans both batch shards, and
    the reference routes it once over the whole batch. With every row row
    0's tokens each picked expert gets 16 slots for its capacity of 8, so
    the reference drops the second shard's, which routing each shard alone
    would keep. The 2 × 2 split prefill and one ``make_sharded_decode``
    step (16 × 16 tokens, f32) within ``LOGIT_RTOL`` (1e-5 of the largest
    logit) of the one-device ``prefill`` / ``decode_step`` on the same
    tokens, and within rtol / atol 1e-4 of the reference's jitted steps;
    the decode step's bytes ``chip_smoke.serve_tp2d_bytes_want``'s, the
    group's exchange (``moe_group_probs``, ``moe_group_dispatch``) along
    "data" only."""
    import jax
    from repro.models.transformer import TransformerLM as RLM
    from test_torch_lm import _jax_cfg
    cases, ref = reference_serving
    case, want = cases[f"fault6-{key}"], ref[f"fault6-{key}"]
    cfg = SPLIT_MODELS[FAULT6[key][0]]
    tree = jax.tree_util.tree_map(np.asarray, RLM(_jax_cfg(cfg)).init(
        jax.random.PRNGKey(0)))
    params = params_from_jax(cfg, tree, device="cpu")
    tokens = torch.tensor(case["tokens"], dtype=torch.int32)
    token = torch.tensor(case["token"], dtype=torch.int32)
    B, S = tokens.shape
    plain = TransformerLM(cfg, moe_group_size=16)
    lg1, (ks, vs) = plain.prefill(params, tokens)
    ks, vs = (F.pad(c, (0, 0, 0, 0, 0, 4)) for c in (ks, vs))
    dlg1, _ = plain.decode_step(params, token, (ks, vs), S)
    mesh = _mesh((2, 2))
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None))
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "tp2d"))
    prefill = make_sharded_prefill(model, mesh, P("data", None),
                                   P(None, "data", "model", None, None),
                                   capacity=S + 4, policy="tp2d")
    decode = make_sharded_decode(model, mesh, P("data", None))
    lg, cache = prefill(placed, tokens)
    mesh.reset_bytes()
    dlg, _ = decode(placed, token, cache, S)
    for got, one, ref_lg in ((lg, lg1, want["prefill"]),
                             (dlg, dlg1, want["decode"])):
        err = float((got - one).abs().max())
        assert err <= LOGIT_RTOL * float(one.abs().max()), err
        np.testing.assert_allclose(got.numpy(), np.array(ref_lg),
                                   rtol=1e-4, atol=1e-4)
    assert dict(mesh.bytes) == chip_smoke.serve_tp2d_bytes_want(
        cfg, (2, 2), B, S, "decode", 16, S + 4)
    assert mesh.bytes["moe_group_dispatch"] > 0
    assert _along(mesh, mesh.moves, {"moe_group_probs",
                                     "moe_group_dispatch"}, "data")


@pytest.mark.parametrize("key", sorted(FAULT7))
def test_fsdp_prefill_routes_one_group_over_the_batch(reference_serving,
                                                      key):
    """Fault 7: an ``fsdp`` prefill on 2 × 2 with the batch split over
    "data" whose MoE group (64 tokens, ``moe_group_size`` 64, B 4 × 16)
    spans both batch shards, as the reference groups it. The run of the two
    shards is computed at the first home over both shards' rows, and the
    second shard's keys and values go to its home (``prefill_span``; the
    head multiplies the run's last rows where its blocks lie). The cache
    bitwise the one-device ``prefill``'s and the logits within
    ``LOGIT_RTOL`` of its largest (f32; the head's vocab blocks multiplied
    where they lie; with every row row 0's, each picked expert's slots
    overflow, and the second shard's are dropped as the reference drops
    them), within rtol / atol 1e-4 of the reference's jitted ``fsdp``
    prefill; the bytes ``chip_smoke.serve_fsdp_bytes_want``'s. The
    port's bytes by name and axis are printed beside the reference HLO's
    (``-s``)."""
    import jax
    from repro.models.transformer import TransformerLM as RLM
    from test_torch_lm import _jax_cfg
    cases, ref = reference_serving
    case, want = cases[f"fault7-{key}"], ref[f"fault7-{key}"]
    cfg = SPLIT_MODELS[FAULT7[key][0]]
    tree = jax.tree_util.tree_map(np.asarray, RLM(_jax_cfg(cfg)).init(
        jax.random.PRNGKey(0)))
    params = params_from_jax(cfg, tree, device="cpu")
    tokens = torch.tensor(case["tokens"], dtype=torch.int32)
    B, S = tokens.shape
    plain = TransformerLM(cfg, moe_group_size=FAULT7_GROUP)
    lg1, (ks, vs) = plain.prefill(params, tokens)
    mesh = _mesh((2, 2))
    model = TransformerLM(cfg, moe_group_size=FAULT7_GROUP,
                          act_spec=P("data", None, None))
    assert model.moe_span(B, S, 2) == 2
    placed = place_params(params, mesh, lm_param_specs(params, cfg, "fsdp"))
    prefill = make_sharded_prefill(model, mesh, P("data", None),
                                   P(None, "data", "model", None, None),
                                   capacity=S + 4)
    lg, cache = prefill(placed, tokens)
    print(f"\nfault 7 ({key}): reference HLO, bytes a chip by kind and "
          f"axis: {want['hlo']['prefill']}, weight gathers along \"data\" "
          f"{want['hlo']['weights']['prefill']}\nthe port, bytes by name: "
          f"{dict(mesh.bytes)}; by name and axis: "
          f"{_by_axis(mesh, mesh.moves)}")
    err = float((lg - lg1).abs().max())
    assert err <= LOGIT_RTOL * float(lg1.abs().max()), err
    assert torch.equal(gather(cache[0])[:, :, :S], ks)
    assert torch.equal(gather(cache[1])[:, :, :S], vs)
    np.testing.assert_allclose(lg.numpy(), np.array(want["prefill"]),
                               rtol=1e-4, atol=1e-4)
    assert dict(mesh.bytes) == chip_smoke.serve_fsdp_bytes_want(
        cfg, (2, 2), B, S, FAULT7_GROUP, S + 4)
    assert mesh.bytes["prefill_span"] > 0


def test_fsdp_prefill_refuses_groups_across_uneven_shards():
    """Where the MoE groups neither fit into the batch shards nor span
    whole runs of them (3 groups of 16 tokens over 4 shards of 12), the
    ``fsdp`` prefill raises and names the shapes."""
    cfg = SPLIT_MODELS["qwen3-moe-e16"]
    mesh = _mesh((4, 1))
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None))
    params = model.init(torch.Generator().manual_seed(0))
    prefill = make_sharded_prefill(model, mesh, P("data", None),
                                   P(None, "data", None, None, None))
    tokens = torch.zeros((4, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="3 MoE groups of 16 tokens"):
        prefill(place_params(params, mesh,
                             lm_param_specs(params, cfg, "fsdp")), tokens)
