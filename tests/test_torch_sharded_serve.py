"""Serving on the device mesh and the paper's IGPM cell, on the CPU
(meshes of ``["cpu"] * 4``).

* The IGPM cell (``launch/cells.py:igpm_cell``): its reduced inputs equal
  the reference's concrete cell's bit for bit, its refresh is within
  ``RWR_TOL`` of the reference's, its published geometry builds on meta
  tensors with nothing allocated, and the arc-sharded refresh
  (``core.rwr.label_rwr`` over the placed graph) on 1 × 4, 2 × 2 and 4 × 1
  meshes is within ``RWR_TOL`` of the unsharded one (bitwise with one arc
  block),
  with ``Mesh.bytes`` the count worked out from n, L, the sweeps and the
  blocks. RWR_TOL: 1e-6 of the table's largest entry (f32 sums of one
  vertex's messages split over the arc blocks, or added in another order
  by XLA: a few ulps of the largest entries).
* Sharded prefill (``fsdp``) and decode (``tp2d``, the cache placed by
  ``lm_cache_specs``; ``distrib/serving.py``) against the unsharded
  ``prefill`` / ``decode_step``, on the qwen3-moe SMOKE config and a dense
  one (f32): with the batch whole, prefill logits and the gathered cache
  bitwise; with B = 16, which splits the batch over "data" and keeps the
  experts where they live, within ``LOGIT_RTOL``. Decode logits within
  ``LOGIT_RTOL`` (1e-5 of the largest logit: the split attention and the
  block products add in another order) in both cache layouts, each
  unsharded step reading the cache the sharded step left; the cache
  after each step, gathered, bitwise the unsharded cache except the
  decoded tokens' keys and values, which come from the rounding of the
  block products and the split attention and must be within one bf16
  step (layer 0's were bitwise while decode gathered the weights at the
  home). An independent one-device decode of the same tokens, on its own
  cache, is held to ``ALONE_TOL`` (2^-8 of the largest logit: one bf16
  step, the cache's own rounding, since an entry one bf16 step apart
  moves every later step) and its caches within one bf16 step on at most
  0.5 % of the entries.
  Both are also held against the reference's JAX ``prefill``/``decode_step``
  (weights through ``params_from_jax``) to ``tests/test_torch_lm.py``'s
  tolerances (logits rtol/atol 1e-4, bf16 caches at most 0.5 % of entries
  one bf16 step apart).
* The split attention (``layers.decode_attention_partial`` +
  ``combine_attention_partials``) equals ``decode_attention`` within 1e-6
  (f32), a slice with every slot at or past ``cache_len`` included.

JAX is imported inside the tests that need it.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.config.base import TransformerConfig
from repro_torch.config.registry import get_arch
from repro_torch.configs import qwen3_moe_30b_a3b as qcfg
from repro_torch.distrib.serving import (make_sharded_decode,
                                         make_sharded_prefill, place_params)
from repro_torch.distrib.sharding import (P, ShardedTensor, gather,
                                          lm_cache_specs, lm_param_specs)
from repro_torch.launch.cells import build_cell, pad512
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as TL
from repro_torch.models.transformer import TransformerLM, params_from_jax

torch.set_num_threads(1)

CPU4 = ["cpu"] * 4
RWR_TOL = 1e-6
LOGIT_RTOL = 1e-5
# two decodes each on its own bf16 cache, in which an entry may round one
# bf16 step (2^-8 of it) apart and move every later step: logits within
# one bf16 step of the largest logit
ALONE_TOL = 2.0 ** -8
DENSE = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=128, dtype="float32",
                          remat="none")
MODELS = {"qwen3-moe-smoke": qcfg.SMOKE, "dense-smoke": DENSE}


def _close(got, want, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{err} > {tol} × {scale}"


def bf16_close(got, want):
    """``tests/test_torch_lm.py``'s bf16 cache tolerance: within one bf16
    step (rtol 2^-7, atol 1e-5 for entries near 0, where f32 sums in
    another order differ by their terms' rounding) on at most 0.5 % of the
    entries."""
    a, b = got.float().numpy(), want.float().numpy()
    np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=1e-5)
    assert (a != b).mean() <= 0.005


def hold_alone(got, alone):
    """The mesh's decode steps (logits, k, v) against the independent
    one-device run's: the logits within ``ALONE_TOL`` of the largest,
    the caches ``bf16_close``."""
    for (glg, gk, gv), (alg, ak, av) in zip(got, alone):
        _close(glg, alg, ALONE_TOL)
        bf16_close(gk, ak)
        bf16_close(gv, av)


# -- the IGPM cell -----------------------------------------------------------------

def _igpm(mesh=None, concrete=True):
    return build_cell(get_arch("igpm-pem", smoke=True), "friends2008", "cpu",
                      smoke=True, mesh=mesh, concrete=concrete)


def test_igpm_cell_inputs_and_refresh_match_the_reference():
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell as rbuild
    ref = rbuild(rget("igpm-pem", smoke=True), "friends2008", concrete=True,
                 smoke=True)
    cell = _igpm()
    (g, r0), (rg, rr0) = cell.args, ref.args
    for f in rg._fields:
        want = np.asarray(getattr(rg, f))
        got = getattr(g, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(r0.numpy(), np.asarray(rr0))
    assert cell.meta == ref.meta and cell.kind == ref.kind == "stream"
    want = torch.from_numpy(np.array(ref.step_fn(rg, rr0)))
    got = cell.step_fn(g, r0)
    assert got.shape == (64, 4) and torch.isfinite(got).all()
    _close(got, want, RWR_TOL)


def test_igpm_published_geometry_on_meta():
    arch = get_arch("igpm-pem")
    cell = build_cell(arch, "friends2008", concrete=False)
    g, r0 = cell.args
    assert g.senders.shape == (pad512(2 * 3_871_909),) == (7_744_000,)
    assert g.senders.device.type == "meta" and r0.device.type == "meta"
    assert r0.shape == (224_879, 4) and g.degree.dtype == torch.float32
    assert cell.meta == {"n_nodes": 224_879, "n_edges": 7_744_000,
                         "rwr_iters": 5, "n_labels": 4}
    r = cell.step_fn(g, r0)          # the refresh runs on shapes alone
    assert r.shape == (224_879, 4) and r.is_meta
    mesh = Mesh((16, 16), ("data", "model"), ["meta"] * 256)
    sharded = build_cell(arch, "friends2008", mesh=mesh, concrete=False)
    gs, _ = sharded.args
    assert isinstance(gs.senders, ShardedTensor)
    assert gs.senders.layout.block_shape == (7_744_000 // 16,)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_arc_sharded_refresh(shape):
    want = _igpm().step_fn(*_igpm().args)
    mesh = Mesh(shape, ("data", "model"), CPU4)
    cell = _igpm(mesh)
    g, r0 = cell.args
    assert g.senders.spec == P("data") and r0.spec == P(None, None)
    got = cell.step_fn(g, r0)
    D = shape[0]
    if D == 1:
        assert torch.equal(got, want)
    else:
        _close(got, want, RWR_TOL)
    n, L, iters = 64, 4, cell.meta["rwr_iters"]
    assert dict(mesh.bytes) == ({} if D == 1 else
                                {"arc_psum": iters * 2 * (D - 1) * n * L * 4})


# -- sharded prefill and decode ----------------------------------------------------

def reading(cache, written):
    """An ``attend`` for the unsharded ``decode_step`` that attends over
    ``cache`` (the sharded step's, gathered: its keys and values of the
    decoded token included) and writes the step's own keys and values
    into ``written`` instead (the cache the unsharded run would hold)."""
    def attend(i, q, k, v, _, n):
        written[0][i, :, n:n + 1] = k.to(written[0].dtype)
        written[1][i, :, n:n + 1] = v.to(written[1].dtype)
        kc, vc = (c[i].to(q.dtype) for c in cache)
        return TL.decode_attention(q, kc, vc, cache_len=torch.full(
            (q.shape[0],), n + 1, dtype=torch.int32))
    return attend


def _served(cfg, B, S, tokens_out=4):
    """(unsharded logits and caches per step, sharded ones, mesh bytes,
    the cache's spec, the independent unsharded run's logits and caches
    per decode step) of a prefill and ``tokens_out`` teacher-forced decode
    steps. Each unsharded decode step of the first kind reads the cache
    the sharded step left (``reading``): a decoded token's keys and values
    differ from one device's by rounding (block products, the split
    attention) and the bf16 cache can round such an entry one bf16 step
    apart, which moves the logits of every later step by more than the
    step's own rounding. The independent run decodes the same tokens on
    its own cache."""
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    wide = B >= 16
    bspec = P("data", None) if wide else P(None, None)
    gs = min(4096, max(64, B * S // 8))
    model = TransformerLM(cfg, moe_group_size=gs,
                          act_spec=P("data", None, None) if wide else None)
    plain = TransformerLM(cfg, moe_group_size=gs)
    params = plain.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    cap = S + tokens_out
    lg, (ks, vs) = plain.prefill(params, tokens)
    want = [(lg, ks.clone(), vs.clone())]
    ks = F.pad(ks, (0, 0, 0, 0, 0, tokens_out))
    vs = F.pad(vs, (0, 0, 0, 0, 0, tokens_out))
    cspec = lm_cache_specs(False, B)
    prefill = make_sharded_prefill(model, mesh, bspec, cspec, capacity=cap)
    glg, cache = prefill(place_params(params, mesh, lm_param_specs(
        params, cfg, "fsdp")), tokens)
    got = [(glg, gather(cache[0])[:, :, :S], gather(cache[1])[:, :, :S])]
    assert cache[0].spec == cspec
    decode = make_sharded_decode(model, mesh, bspec)
    placed = place_params(params, mesh, lm_param_specs(params, cfg))
    own, alone = (ks.clone(), vs.clone()), []
    tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    for i in range(tokens_out):
        glg, cache = decode(placed, tok, cache, S + i)
        gk, gv = gather(cache[0]), gather(cache[1])
        lg, _ = plain.decode_step(params, tok, None, S + i,
                                  attend=reading((gk, gv), (ks, vs)))
        want.append((lg, ks.clone(), vs.clone()))
        got.append((glg, gk, gv))
        alg, own = plain.decode_step(params, tok, own, S + i)
        alone.append((alg, own[0].clone(), own[1].clone()))
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    return want, got, dict(mesh.bytes), cspec, alone


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("B,S", [(2, 16), (16, 8)], ids=["whole", "split"])
def test_sharded_prefill_and_decode(name, B, S):
    cfg = MODELS[name]
    want, got, nbytes, cspec, alone = _served(cfg, B, S)
    (wlg, wk, wv), (glg, gk, gv) = want[0], got[0]
    if B < 16:
        assert cspec == P(None, None, ("data", "model"), None, None)
        assert torch.equal(glg, wlg)
    else:
        assert cspec == P(None, "data", "model", None, None)
        _close(glg, wlg, LOGIT_RTOL)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    for i, ((wlg, wk, wv), (glg, gk, gv)) in enumerate(zip(want[1:],
                                                           got[1:])):
        _close(glg, wlg, LOGIT_RTOL)
        n = S + i          # the slot this step wrote
        for w, g in ((wk, gk), (wv, gv)):
            # the prompt's slots and those not yet written: bitwise
            assert torch.equal(g[:, :, :S], w[:, :, :S])
            assert torch.equal(g[:, :, n + 1:], w[:, :, n + 1:])
            # the decoded slots (block products, the split attention
            # below them): one bf16 step
            np.testing.assert_allclose(g[:, :, S:n + 1].float().numpy(),
                                       w[:, :, S:n + 1].float().numpy(),
                                       rtol=2.0 ** -7, atol=1e-6)
    hold_alone(got[1:], alone)
    # decode with the batch whole: the products where the weight blocks
    # lie; with it split, the reference's split (weights gathered along
    # "data", the rows moved to the row blocks, sums over "model")
    moved = (("kv_write", "q_send", "tp_act", "tp_partial") if B < 16 else
             ("tp_zero_gather", "tp_model_sum", "tp_rows_gather",
              "tp_rows_scatter"))
    for key in ("all_gather", "cache_scatter", "attn_partial") + moved:
        assert nbytes.get(key, 0) > 0, key


def test_sharded_serving_matches_the_reference():
    """Sharded prefill and decode (the batch whole, the cache split over
    all four positions) against the reference's JAX model fed the same
    weights."""
    import jax
    import jax.numpy as jnp
    from repro.config.base import MoEConfig as RMoE
    from repro.config.base import TransformerConfig as RTC
    from repro.models.transformer import TransformerLM as RLM
    for cfg in MODELS.values():
        kw = dataclasses.asdict(cfg)
        if cfg.moe is not None:
            kw["moe"] = RMoE(**kw["moe"])
        rmodel = RLM(RTC(**kw))
        rparams = rmodel.init(jax.random.PRNGKey(0))
        params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                             rparams),
                                 device="cpu")
        mesh = Mesh((2, 2), ("data", "model"), CPU4)
        model = TransformerLM(cfg)
        toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12),
                                                 dtype=np.int32)
        cspec = lm_cache_specs(False, 2)
        prefill = make_sharded_prefill(model, mesh, P(None, None), cspec,
                                       capacity=16)
        lg, cache = prefill(place_params(params, mesh, lm_param_specs(
            params, cfg, "fsdp")), torch.from_numpy(toks))
        rlg, (rk, rv) = rmodel.prefill(rparams, toks)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=1e-4,
                                   atol=1e-4)
        for got, want in zip(cache, (rk, rv)):
            a = gather(got)[:, :, :12].float().numpy()
            b = np.asarray(want).astype(np.float32)
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=1e-5)
            assert (a != b).mean() <= 0.005
        pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
        rk, rv = jnp.pad(rk, pad), jnp.pad(rv, pad)
        tok = np.array([[7], [3]], np.int32)
        rlg, _ = rmodel.decode_step(rparams, jnp.asarray(tok), (rk, rv),
                                    jnp.asarray(12, jnp.int32))
        decode = make_sharded_decode(model, mesh, P(None, None))
        lg, _ = decode(place_params(params, mesh, lm_param_specs(params,
                                                                 cfg)),
                       torch.from_numpy(tok), cache, 12)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("cache_len", [0, 5, 15, 31])
def test_split_attention_equals_decode_attention(cache_len):
    rng = np.random.default_rng(cache_len)
    B, S, H, KV, hd = 3, 32, 8, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    n = cache_len + 1
    want = TL.decode_attention(q, k, v, torch.full((B,), n))
    Sb = 8
    parts = [TL.decode_attention_partial(q, k[:, j:j + Sb], v[:, j:j + Sb],
                                         min(max(n - j, 0), Sb))
             for j in range(0, S, Sb)]
    if n <= S - Sb:     # the last slice lies wholly at or past cache_len
        m, l, o = parts[-1]
        assert torch.isinf(m).all() and not l.any() and not o.any()
    got = TL.combine_attention_partials(parts, q.dtype)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
