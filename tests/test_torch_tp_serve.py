"""LM serving on the device mesh under ``tp2d`` with the weights where they
lie (``distrib/collectives.py``: ``StationaryView``, ``Rows``,
``block_matmul``, ``take_rows_2d``; ``distrib/serving.py``), on the CPU
(meshes of ``["cpu"] * 4``, f32 SMOKE configs).

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
  −0.0 rows included, through ``StationaryView.take_rows`` and
  ``ShardView.take_rows``; ``emb_ids`` / ``emb_rows`` the ids and rows
  each remote block sends; its backward sums each block's rows
  (``tests/test_torch_tp_train.py`` holds it bitwise).
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
  bf16 step) and the same cache bound; two runs bitwise; no
  parameter byte moved (no ``all_gather``; the lookup moves the batch's
  ids and rows only). Against the reference's JAX ``prefill`` /
  ``decode_step`` (weights through ``params_from_jax``) to
  ``tests/test_torch_lm.py``'s tolerances (logits rtol / atol 1e-4, bf16
  caches within one bf16 step on at most 0.5 % of entries).
* ``moe_block`` over ``Rows`` with the experts where they live and the
  batch whole: bitwise the unsharded block.

JAX is imported inside the tests that need it.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.config.registry import get_arch
from repro_torch.configs import qwen3_moe_30b_a3b as qcfg
from repro_torch.distrib.collectives import (Rows, ShardView, StationaryView,
                                             batch_groups, block_matmul)
from repro_torch.distrib.serving import (make_sharded_decode,
                                         make_sharded_prefill, place_params)
from repro_torch.distrib.sharding import (Layout, P, device_put, gather,
                                          lm_cache_specs, lm_param_specs)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as TM
from repro_torch.models.transformer import TransformerLM, params_from_jax
from repro_torch.sparse.segment import take_rows

from test_torch_sharded_serve import bf16_close, hold_alone, reading

torch.set_num_threads(1)

LOGIT_RTOL = 1e-5
MATMUL_RTOL = 1e-6
MOE16 = dataclasses.replace(
    qcfg.SMOKE, moe=dataclasses.replace(qcfg.SMOKE.moe, n_experts=16))
CONFIGS = {"qwen3-moe-e16": MOE16,
           **{a: get_arch(a, smoke=True).model
              for a in ("deepseek-7b", "qwen2-72b", "smollm-135m",
                        "dbrx-132b")}}
# the collectives a tp2d serving step may count: activations, ids, the
# looked-up rows, the KV cache and the logits; never a parameter
ACTIVATIONS = {"tp_act", "tp_partial", "emb_ids", "emb_rows", "expert_send",
               "cache_scatter", "kv_write", "q_send", "attn_partial",
               "logits_gather"}


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
    got = StationaryView(placed).take_rows(_rows(mesh, ids, homes))
    same(torch.cat(got.parts))
    # the ids go to every block's server, its column block of the rows
    # comes back
    lay = placed.layout
    K, C = lay.counts
    n_ids, rows = 0, 0
    for home in homes:
        for block in lay.blocks():
            if _server(mesh, lay, block, home) != home:
                n_ids += ids.numel() // len(homes) * 4
                rows += ids.numel() // len(homes) * e // C * 4
    assert dict(mesh.bytes) == {k: v for k, v in (("emb_ids", n_ids),
                                                  ("emb_rows", rows)) if v}
    mesh.reset_bytes()
    group = list(range(mesh.size))
    with torch.no_grad():
        same(ShardView(placed, 0, group, grad=False).take_rows(ids))
    assert "all_gather" not in mesh.bytes


def test_two_axis_lookup_has_a_backward():
    """The lookup of a table split on two axes differentiates (its backward
    landed with the ``tp2d`` train step; ``tests/test_torch_tp_train.py``
    holds it bitwise against ``take_rows``'s): each block's gradient is
    the sum of its rows' gradients, and nothing is gathered."""
    mesh = _mesh((2, 2))
    table = torch.randn(8, 4, generator=torch.Generator().manual_seed(4))
    placed = device_put(table, mesh, P("model", "data"))
    view = ShardView(placed, 0, [0, 1, 2, 3])
    view.take_rows(torch.tensor([1, 2, 2, 7])).sum().backward()
    want = torch.zeros(8, 4)
    want[1], want[2], want[7] = 1.0, 2.0, 1.0
    for block, _, grad in view.grads():
        assert torch.equal(grad, want[placed.layout.slices(block)])
    assert set(mesh.bytes) == {"emb_ids", "emb_rows", "emb_grad"}


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
    the bytes per step; the independent one-device run's (logits, k, v)
    per decode step, on its own cache) of a tp2d prefill and
    ``tokens_out`` teacher-forced decode steps."""
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
        nbytes = [dict(mesh.bytes)]
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        for i in range(tokens_out):
            mesh.reset_bytes()
            glg, cache = decode(placed, tok, cache, S + i)
            nbytes.append(dict(mesh.bytes))
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
    """``emb_ids`` and ``emb_rows`` of one lookup of n int32 ids in the
    (V, d) f32 table on the 2 × 2 mesh (P("model", "data"): four blocks,
    one of them at each home)."""
    return {"emb_ids": 3 * n * 4, "emb_rows": 3 * n * cfg.d_model // 2 * 4}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("B,S", [(2, 16), (16, 8)], ids=["whole", "split"])
def test_tp2d_prefill_and_decode(name, B, S):
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
    for i, step in enumerate(nbytes):
        assert set(step) <= ACTIVATIONS, step
        assert step["tp_act"] > 0 and step["tp_partial"] > 0
        for k, v in _lookup_bytes(cfg, B * S if i == 0 else B).items():
            assert step[k] == v, (k, step[k], v)
    if cfg.moe is not None and cfg.moe.n_experts % 16 == 0:
        assert all(step["expert_send"] > 0 for step in nbytes)


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
