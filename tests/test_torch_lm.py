"""The port's LM serving path against the JAX package, on the CPU.

Every test feeds the same numpy inputs (fixed seeds) to a JAX function and
its counterpart in ``repro_torch``; the port runs its plain versions (CPU
tensors), the JAX model its jnp paths. Model weights go from the JAX
``TransformerLM.init`` tree to the port through ``params_from_jax``.

Tolerances, all in f32: layer functions to rtol 1e-5 / atol 1e-6 (one
rounding of another summation order); ``moe_block`` routing (expert ids,
the slot sort permutation, the keep mask) bitwise, y and aux to rtol 1e-4 /
atol 1e-5; prefill and decode logits to rtol 1e-4 / atol 1e-4; the greedy
tokens of the serve loop equal. The KV caches are bf16 by design: at most
0.5 % of their entries differ, each by at most one bf16 step (rtol 2^-7)
or 1e-5 absolute — k and v come out of f32 products whose last bits differ
between the two CPU matmul libraries, and an f32 value near a bf16
rounding boundary then rounds the other way (1-4 of 1,536 entries at these
shapes; near zero the f32 difference is several bf16 steps). JAX is imported inside the tests,
so that ``pytest --noconftest -m cuda`` collects this file without it.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.config.base import MoEConfig, TransformerConfig
from repro_torch.config.registry import get_arch, list_archs
from repro_torch.configs import qwen3_moe_30b_a3b as qcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.transformer import TransformerLM, params_from_jax

torch.set_num_threads(1)

# a dense SMOKE-sized LM (SwiGLU MLP), as tests/test_models.py's CFG
DENSE = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=128, dtype="float32",
                          remat="none")
MODELS = {"qwen3-moe-smoke": qcfg.SMOKE, "dense-smoke": DENSE}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_cfg(cfg):
    """The JAX package's TransformerConfig with this config's fields."""
    from repro.config.base import MoEConfig as RMoE
    from repro.config.base import TransformerConfig as RTC
    kw = dataclasses.asdict(cfg)
    if cfg.moe is not None:
        kw["moe"] = RMoE(**kw["moe"])
    return RTC(**kw)


@pytest.fixture(scope="module", params=sorted(MODELS))
def lm(request):
    """(name, port cfg, JAX model, JAX params, port model, port params)."""
    import jax

    from repro.models.transformer import TransformerLM as RLM
    cfg = MODELS[request.param]
    rmodel = RLM(_jax_cfg(cfg))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return (request.param, cfg, rmodel, rparams, TransformerLM(cfg),
            params_from_jax(cfg, tree, device="cpu"))


# -- layers ----------------------------------------------------------------------

def test_rms_norm_matches():
    import jax.numpy as jnp

    from repro.models.layers import rms_norm
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = TL.rms_norm(_t(x), _t(w), 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    import jax.numpy as jnp

    from repro.models.layers import apply_rope
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 109), (2, 9)).astype(np.int32)
    want = np.asarray(apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = TL.apply_rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,H,KV,block", [(96, 4, 2, 32), (50, 4, 1, 16),
                                          (40, 2, 2, 64)])
def test_blockwise_attention_matches(S, H, KV, block, causal):
    import jax.numpy as jnp

    from repro.models.layers import blockwise_attention
    rng = np.random.default_rng(S + H)
    q = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, KV, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, KV, 16)).astype(np.float32)
    want = np.asarray(blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal,
                                          block=block))
    got = TL.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                 block=block)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_blockwise_and_dense_attention_match_with_offset():
    import jax.numpy as jnp

    from repro.models.layers import blockwise_attention, dense_attention
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 24, 2, 16)).astype(np.float32)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for fj, ft in ((blockwise_attention, TL.blockwise_attention),
                   (dense_attention, TL.dense_attention)):
        want = np.asarray(fj(*args, causal=True, q_offset=16))
        got = ft(_t(q), _t(k), _t(v), causal=True, q_offset=16).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_decode_attention_matches():
    import jax.numpy as jnp

    from repro.models.layers import decode_attention
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    lens = np.array([20, 32], np.int32)
    want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v),
                                       cache_len=jnp.asarray(lens)))
    got = TL.decode_attention(_t(q), _t(k), _t(v), cache_len=_t(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_swiglu_matches():
    import jax.numpy as jnp

    from repro.models.layers import swiglu
    rng = np.random.default_rng(4)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.3
                     for s in ((3, 5, 16), (16, 32), (16, 32), (32, 16)))
    want = np.asarray(swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))
    got = TL.swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- MoE -------------------------------------------------------------------------

def _jax_routing(x, router, cfg, n_groups, capacity_factor):
    """The routing steps of repro.models.moe.moe_block, lines 44-79."""
    import jax
    import jax.numpy as jnp

    from repro.models.moe import moe_capacity
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = n_groups if T % n_groups == 0 else 1
    S = T // G
    C = moe_capacity(S, E, k, capacity_factor)
    xg = jnp.asarray(x).reshape(G, S, d)
    probs = jax.nn.softmax((xg @ jnp.asarray(router)).astype(jnp.float32),
                           axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    N = S * k
    e_flat = expert_idx.reshape(G, N)
    perm = jnp.argsort(e_flat, axis=1)
    se = jnp.take_along_axis(e_flat, perm, axis=1)
    ar = jnp.arange(N)[None, :]
    is_start = jnp.concatenate(
        [jnp.ones((G, 1), bool), se[:, 1:] != se[:, :-1]], axis=1)
    run_start = jax.lax.cummax(jnp.where(is_start, ar, 0), axis=1)
    keep = (ar - run_start) < C
    return (np.asarray(expert_idx), np.asarray(perm), np.asarray(keep))


def _moe_params(mcfg, d, seed):
    import jax
    import jax.numpy as jnp

    from repro.models.moe import init_moe_params
    p = init_moe_params(jax.random.PRNGKey(seed), _jax_cfg(
        dataclasses.replace(DENSE, moe=mcfg)).moe, d)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


@pytest.mark.parametrize("T,n_groups,cf", [(64, 2, 1.25), (96, 1, 1.25),
                                           (90, 4, 1.25), (64, 2, 0.5)])
def test_moe_block_matches(T, n_groups, cf):
    """n_groups 4 with T=90 falls back to one group (T % 4 != 0); factor
    0.5 drops slots over capacity."""
    from repro.models.moe import moe_block
    mcfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=32)
    d = 16
    jp, tp = _moe_params(mcfg, d, seed=T)
    x = np.random.default_rng(T).standard_normal((T, d)).astype(np.float32)
    y_j, aux_j = moe_block(x, jp, _jax_cfg(dataclasses.replace(
        DENSE, moe=mcfg)).moe, n_groups, capacity_factor=cf)
    y_t, aux_t = TM.moe_block(_t(x), tp, mcfg, n_groups, capacity_factor=cf)

    idx_j, perm_j, keep_j = _jax_routing(x, np.asarray(jp["router"]), mcfg,
                                         n_groups, cf)
    r = TM.route(_t(x), tp["router"], mcfg, n_groups, cf)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx_j)
    np.testing.assert_array_equal(r.perm.numpy(), perm_j)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    if cf < 1:
        assert not keep_j.all()
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-4,
                               atol=1e-5)


def test_moe_capacity_drops_overflow_like_reference():
    """tests/test_models.py:103's case: every token routed to expert 0."""
    import jax.numpy as jnp

    from repro.models.moe import moe_block, moe_capacity
    mcfg = MoEConfig(n_experts=2, top_k=1, d_ff_expert=8)
    d, T = 4, 64
    jp, tp = _moe_params(mcfg, d, seed=0)
    router = np.array([[10.0, -10.0]] * d, np.float32)
    jp["router"], tp["router"] = jnp.asarray(router), _t(router)
    x = (np.abs(np.random.default_rng(0).standard_normal((T, d)))
         + 0.1).astype(np.float32)
    y_j, _ = moe_block(jnp.asarray(x), jp, _jax_cfg(dataclasses.replace(
        DENSE, moe=mcfg)).moe, n_groups=1, capacity_factor=0.25)
    y_t, _ = TM.moe_block(_t(x), tp, mcfg, n_groups=1, capacity_factor=0.25)
    C = moe_capacity(T, 2, 1, 0.25)
    assert TM.moe_capacity(T, 2, 1, 0.25) == C
    r = TM.route(_t(x), tp["router"], mcfg, 1, 0.25)
    _, _, keep_j = _jax_routing(x, router, mcfg, 1, 0.25)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    assert int((y_t.abs().sum(dim=1) > 1e-9).sum()) == C
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-5)


def test_top_k_ties_go_to_the_lower_index():
    x = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = TM.top_k_stable(x, 3)
    assert idx.tolist() == [[1, 2, 4]]
    assert vals[0].tolist() == pytest.approx([0.3, 0.3, 0.3])


def test_unported_sharding_knobs_raise():
    mcfg = MoEConfig(n_experts=2, top_k=1, d_ff_expert=8)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TM.moe_block(torch.zeros((4, 4)), {}, mcfg, 1, exp_spec=("data",))
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        TransformerLM(DENSE, act_spec=("data",))


# -- the model -------------------------------------------------------------------

def _assert_bf16_cache_close(got, want):
    a = got.float().numpy()
    b = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=1e-5)
    assert (a != b).mean() <= 0.005


def test_params_from_jax_unstacks_and_casts(lm):
    name, cfg, _, rparams, _, params = lm
    assert len(params["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            params["layers"][i]["wq"].numpy(),
            np.asarray(rparams["layers"]["wq"][i]))
    if cfg.moe is not None:
        assert params["layers"][1]["moe"]["wd"].shape == (
            cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model)
    # a bf16 config keeps 2-byte weights, also from ml_dtypes bf16 arrays
    import jax.numpy as jnp
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    tree = {"embed": np.asarray(jnp.asarray(rparams["embed"], jnp.bfloat16)),
            "ln_f": np.asarray(rparams["ln_f"]),
            "layers": {"wq": np.asarray(rparams["layers"]["wq"])}}
    out = params_from_jax(bf, tree, device="cpu")
    assert out["embed"].dtype == torch.bfloat16
    assert out["layers"][0]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["embed"].float().numpy(),
        np.asarray(rparams["embed"]).astype(jnp.bfloat16).astype(np.float32))


def test_prefill_matches(lm):
    name, cfg, rmodel, rparams, model, params = lm
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    logits_j, (ks_j, vs_j) = rmodel.prefill(rparams, toks)
    logits_t, (ks_t, vs_t) = model.prefill(params, _t(toks))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)
    assert ks_t.dtype == torch.bfloat16
    for got, want in ((ks_t, ks_j), (vs_t, vs_j)):
        _assert_bf16_cache_close(got, want)


def test_decode_step_matches(lm):
    import jax.numpy as jnp
    name, cfg, rmodel, rparams, model, params = lm
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    _, (ks_j, vs_j) = rmodel.prefill(rparams, toks)
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    ks_j, vs_j = jnp.pad(ks_j, pad), jnp.pad(vs_j, pad)
    ks_t = torch.from_numpy(np.asarray(ks_j).astype(np.float32)) \
        .to(torch.bfloat16)
    vs_t = torch.from_numpy(np.asarray(vs_j).astype(np.float32)) \
        .to(torch.bfloat16)
    tok = np.array([[7], [3]], np.int32)
    logits_j, (ks_j, vs_j) = rmodel.decode_step(
        rparams, jnp.asarray(tok), (ks_j, vs_j), jnp.asarray(12, jnp.int32))
    logits_t, (ks_t, vs_t) = model.decode_step(params, _t(tok), (ks_t, vs_t),
                                               12)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)
    for got, want in ((ks_t, ks_j), (vs_t, vs_j)):
        _assert_bf16_cache_close(got, want)
        # the decoded token's slot is written; the slots past it stay zero
        assert got[:, :, 12].abs().sum() > 0
        assert not got[:, :, 13:].any()


def test_forward_logits_match(lm):
    name, cfg, rmodel, rparams, model, params = lm
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 10),
                                             dtype=np.int32)
    h_j, aux_j = rmodel.forward(rparams, toks)
    h_t, aux_t = model.forward(params, _t(toks))
    np.testing.assert_allclose(model.logits(params, h_t).numpy(),
                               np.asarray(rmodel.logits(rparams, h_j)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-4,
                               atol=1e-6)


def test_greedy_loop_matches_reference_loop(lm):
    """The reference loop of repro/launch/serve.py:38-51 on both sides."""
    import jax.numpy as jnp
    name, cfg, rmodel, rparams, model, params = lm
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    tokens_out = 6
    logits, (ks, vs) = rmodel.prefill(rparams, jnp.asarray(prompt))
    pad = ((0, 0), (0, 0), (0, tokens_out), (0, 0), (0, 0))
    ks, vs = jnp.pad(ks, pad), jnp.pad(vs, pad)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(tokens_out - 1):
        logits, (ks, vs) = rmodel.decode_step(rparams, tok, (ks, vs),
                                              jnp.asarray(12 + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))
    gen = tserve.greedy_generate(model, params, _t(prompt), tokens_out)
    np.testing.assert_array_equal(gen.tokens.numpy(), want)
    np.testing.assert_allclose(gen.logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    assert gen.cache[0].shape == (cfg.n_layers, 2, 12 + tokens_out,
                                  cfg.n_kv_heads, cfg.head_dim)


def test_prefill_gives_last_decode_logits_when_nothing_drops(monkeypatch):
    """tests/test_models.py:46 for the MoE model: with the MoE routed at a
    capacity that drops no slot (factor E / top_k, patched into
    ``moe.route`` for the test), a prefill over the prompt and the
    fed-back tokens gives the last decode step's logits; 3e-2 as there,
    since the decode path reads the bf16 cache."""
    route = TM.route

    def no_drop(x, router, mcfg, n_groups, capacity_factor=1.25):
        r = route(x, router, mcfg, n_groups, mcfg.n_experts / mcfg.top_k)
        assert bool(r.keep.all())
        return r

    monkeypatch.setattr(TM, "route", no_drop)
    cfg = qcfg.SMOKE
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    gen = tserve.greedy_generate(model, params, prompt, 6)
    full = torch.cat([prompt, gen.tokens[:, :-1].long()], dim=1)
    logits, _ = model.prefill(params, full)
    torch.testing.assert_close(logits, gen.logits, rtol=3e-2, atol=3e-2)


def test_serve_lm_continuation_matches_reference_cli(capsys):
    """The reference ``serve_lm`` on the qwen3-moe SMOKE config prints the
    greedy continuation of its own weights and prompt; the port's loop on
    the same weights and prompt gives the same tokens."""
    import jax

    from repro.config.registry import get_arch as r_get_arch
    from repro.launch.serve import serve_lm
    from repro.models.transformer import TransformerLM as RLM
    arch = r_get_arch("qwen3-moe-30b-a3b", smoke=True)
    serve_lm(arch, 16)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "greedy continuation" in ln][0]
    want = [int(t) for t in re.findall(r"\d+", line.split(":", 1)[1])]
    rparams = RLM(arch.model).init(jax.random.PRNGKey(0))
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12),
                                           0, arch.model.vocab_size))
    cfg = get_arch("qwen3-moe-30b-a3b", smoke=True).model
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                         rparams),
                             device="cpu")
    gen = tserve.greedy_generate(TransformerLM(cfg), params, _t(prompt), 16)
    assert gen.tokens[0].tolist() == want


def test_port_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--arch", "qwen3-moe-30b-a3b", "--tokens", "3",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decoded 3 tokens/seq" in out
    # the igpm branch serves, synchronous or async; the serving
    # controller needs --async --closed-loop (tests/test_torch_control.py)
    with pytest.raises(SystemExit, match="--control wants --async"):
        tserve.main(["--arch", "igpm-pem", "--device", "cpu", "--control",
                     "train"])


# -- configs and registry --------------------------------------------------------

def test_qwen3_configs_match_reference():
    from repro.configs import qwen3_moe_30b_a3b as rq
    for ours, theirs in ((qcfg.FULL, rq.FULL), (qcfg.SMOKE, rq.SMOKE)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert qcfg.full().source == rq.full().source
    # the serve-lm depth cut of chip_smoke.py: 8 of 48 layers
    eight = dataclasses.replace(qcfg.FULL, n_layers=8)
    assert eight.param_count() == 5_607_294_976


def test_registry_lists_ported_archs_only():
    from repro.config.registry import get_arch as r_get_arch
    assert list_archs() == ["dbrx-132b", "deepseek-7b", "igpm-pem",
                            "qwen2-72b", "qwen3-moe-30b-a3b", "smollm-135m"]
    for arch_id in list_archs():
        for smoke in (False, True):
            ours, theirs = get_arch(arch_id, smoke), r_get_arch(arch_id, smoke)
            assert (ours.arch_id, ours.family, ours.source) == \
                (theirs.arch_id, theirs.family, theirs.source)
            assert dataclasses.asdict(ours.model) == \
                dataclasses.asdict(theirs.model)
    with pytest.raises(KeyError, match="not ported"):
        get_arch("schnet")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
