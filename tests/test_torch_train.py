"""The port's LM training path against the JAX package, on the CPU.

Every test feeds the same numpy inputs (fixed seeds) to a JAX function and
its counterpart in ``repro_torch``; the port runs its plain versions (CPU
tensors: the flash-attention and expert-GEMM autograd functions take the
plain forward and backward), the JAX package its jnp paths and
``jax.grad``. Model weights go from the JAX ``TransformerLM.init`` tree to
the port through ``params_from_jax(..., dtype=float32)``, the f32 masters
training keeps.

Tolerances, all in f32: the token pipeline bitwise; ``warmup_cosine`` to
1e-7 relative plus two ulps of its f32 cosine carried through the
schedule (XLA's cosine is not correctly rounded and differs from torch's
in the last bit);
the optimizer to 1e-6 relative (the bias corrections' f32 ``pow`` differs
in the last bit between XLA and torch, ROADMAP queue 3's accepted Adam
divergence, and the global norm sums its leaves in another order); the
cross entropies and the two kernels' gradients to rtol 1e-5 / 1e-4 with an
absolute floor for entries that cancel to ~0 (sums in another order); the
LM's loss to rtol 1e-5 and every gradient leaf to rtol 1e-4 plus 1e-5 of
the leaf's largest entry (the backward runs through MoE routing, softmax
and long sums in another order). Train steps: losses and gradient norms
to rtol 1e-4, and parameters within 1e-4 relative plus 2·lr per step
absolute: Adam's update is ≈ lr·sign(g), so an entry whose gradient is
rounding noise around 0 can take the opposite sign in the two packages
and differ by up to 2·lr per step; at most 0.1 % of the entries may be
outside rtol 1e-4 / atol 1e-6 (1-3 of several thousand are, by up to
1.3e-5, at lr 1e-3).
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.config.base import TrainConfig  # noqa: E402
from repro_torch.configs import qwen3_moe_30b_a3b as qcfg  # noqa: E402
from repro_torch.data.lm import TokenPipeline, synthetic_token_batches  # noqa: E402
from repro_torch.distrib.fault import StragglerMonitor  # noqa: E402
from repro_torch.kernels.expert_gemm import ExpertGemm  # noqa: E402
from repro_torch.kernels.expert_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.transformer import (TransformerLM,  # noqa: E402
                                            params_from_jax,
                                            train_state_from_jax,
                                            train_state_to_jax)
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim.schedules import warmup_cosine  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402
from repro_torch.train.state import (TrainState, make_train_step,  # noqa: E402
                                     new_train_state)

from test_torch_lm import DENSE, _jax_cfg  # noqa: E402

torch.set_num_threads(1)

MODELS = {"qwen3-moe-smoke": qcfg.SMOKE, "dense-smoke": DENSE}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, floor):
    """|got − want| ≤ rtol·|want| + floor·max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = floor * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _leaves_ref_layout(port_tree):
    """The port's tree (layers as a list) as {key: f32 numpy}, stacked."""
    from repro_torch.train.state import stack_layers
    out = {}

    def walk(node, prefix):
        kids = (node.items() if isinstance(node, dict) else
                zip(node._fields, node) if hasattr(node, "_fields") else None)
        if kids is not None:
            for k, v in kids:
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = np.asarray(node, np.float32)
    walk(stack_layers(port_tree), "")
    return out


def _leaves_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[key] = np.asarray(leaf, np.float32)
    return out


@pytest.fixture(scope="module", params=sorted(MODELS))
def lm(request):
    """(name, port cfg, JAX model, JAX params, port model)."""
    from repro.models.transformer import TransformerLM as RLM
    cfg = MODELS[request.param]
    rmodel = RLM(_jax_cfg(cfg))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    return request.param, cfg, rmodel, rparams, TransformerLM(cfg)


def _port_params(cfg, rparams):
    return params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, rparams),
                           device="cpu", dtype=torch.float32)


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 32, 0),
                                                  (151936, 2, 64, 3),
                                                  (100, 6, 17, 11)])
def test_token_pipeline_is_bitwise_the_reference(vocab, batch, seq, seed):
    from repro.data.lm import TokenPipeline as RPipe
    from repro.data.lm import synthetic_token_batches as rbatches
    ours, theirs = TokenPipeline(vocab, batch, seq, seed), \
        RPipe(vocab, batch, seq, seed)
    for step in (0, 1, 7):
        for a, b in zip(ours.batch_at(step), theirs.batch_at(step)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        for rank in range(2):
            for a, b in zip(ours.shard_at(step, rank, 2),
                            theirs.shard_at(step, rank, 2)):
                np.testing.assert_array_equal(a, b)
    for (a, b), (c, d) in zip(
            zip(synthetic_token_batches(vocab, batch, seq, seed), range(2)),
            zip(rbatches(vocab, batch, seq, seed), range(2))):
        np.testing.assert_array_equal(a[0], c[0])
        np.testing.assert_array_equal(a[1], c[1])


# -- optimizer -------------------------------------------------------------------

@pytest.mark.parametrize("base_lr,warmup,total", [(3e-4, 100, 1000),
                                                  (3e-4, 1, 5),
                                                  (1e-3, 0, 1200)])
def test_warmup_cosine_matches_reference(base_lr, warmup, total):
    from repro.optim.schedules import warmup_cosine as rwc
    steps = np.arange(0, 1201, dtype=np.int32)
    want = np.asarray(rwc(jnp.asarray(steps), base_lr, warmup, total))
    got = warmup_cosine(torch.as_tensor(steps), base_lr, warmup, total)
    assert got.dtype == torch.float32
    # XLA's f32 cosine is not correctly rounded (1 ulp, 6e-8, off torch's
    # for ~5 % of arguments); the schedule scales cos by 0.45·base_lr and
    # rounds three more times, so allow two cosine ulps through that factor
    # (near the floor, 0.1·base_lr, 5.4e-7 relative)
    cos_ulps = 0.45 * base_lr * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=cos_ulps)
    assert (got.numpy() == want).mean() > 0.9
    # one step as the train step hands it over: an int32 scalar tensor
    assert float(warmup_cosine(torch.tensor(7, dtype=torch.int32), base_lr,
                               warmup, total)) == float(
        warmup_cosine(torch.as_tensor(steps), base_lr, warmup, total)[7])


def _opt_trees(seed):
    """params, grads, m, v as numpy dicts: matrices, vectors, a nested
    dict and a 3-D leaf (decay by ndim)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "inner": {"e": (3, 4, 2), "n": (4,)}}

    def draw(scale=1.0, positive=False):
        def one(s):
            a = rng.standard_normal(s).astype(np.float32) * scale
            return np.abs(a) if positive else a
        return jax.tree_util.tree_map(one, shapes,
                                      is_leaf=lambda x: isinstance(x, tuple))
    return draw(), draw(0.7), draw(0.1), draw(0.01, positive=True)


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    return torch.tensor(np.array(tree))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_global_norm_and_clip_match_reference(max_norm):
    from repro.optim.adamw import clip_by_global_norm, global_norm
    _, grads, _, _ = _opt_trees(1)
    want_n = float(global_norm(grads))
    assert float(TA.global_norm(_port_tree(grads))) == pytest.approx(
        want_n, rel=1e-6)
    want_g, want_norm = clip_by_global_norm(grads, max_norm)
    got_g, got_norm = TA.clip_by_global_norm(_port_tree(grads), max_norm)
    assert float(got_norm) == pytest.approx(float(want_norm), rel=1e-6)
    for a, b in zip(TA.tree_leaves(got_g), jax.tree.leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_reference(grad_clip):
    """One update from step 3 with non-zero moments; params, m and v within
    1e-6 relative; weight decay only on the leaves with ndim >= 2."""
    from repro.optim.adamw import AdamWState as RState
    from repro.optim.adamw import adamw_update
    params, grads, m, v = _opt_trees(2)
    lr = np.float32(2.5e-3)
    rstate = RState(jnp.asarray(3, jnp.int32), m, v)
    want_p, want_s, want_n = adamw_update(grads, rstate, params,
                                          jnp.asarray(lr),
                                          grad_clip=grad_clip)
    tstate = TA.AdamWState(torch.tensor(3, dtype=torch.int32),
                           _port_tree(m), _port_tree(v))
    got_p, got_s, got_n = TA.adamw_update(_port_tree(grads), tstate,
                                          _port_tree(params),
                                          torch.tensor(lr),
                                          grad_clip=grad_clip)
    assert int(got_s.step) == int(want_s.step) == 4
    assert float(got_n) == pytest.approx(float(want_n), rel=1e-6)
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        for a, b in zip(TA.tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


def test_adamw_keeps_f32_moments_and_the_parameter_dtype():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
         "n": torch.ones((4,), dtype=torch.bfloat16)}
    st = TA.adamw_init(p)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert all(t.dtype == torch.float32 for t in TA.tree_leaves(st.m))
    g = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16),
         "n": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    out, st, _ = TA.adamw_update(g, st, p, 0.1, weight_decay=0.5)
    assert out["w"].dtype == out["n"].dtype == torch.bfloat16
    # u = 1 after one step; decay 0.5 on the matrix only
    assert float(out["w"][0, 0]) == pytest.approx(1 - 0.1 * 1.5, abs=4e-3)
    assert float(out["n"][0]) == pytest.approx(1 - 0.1, abs=4e-3)


# -- losses and the two kernels' gradients ----------------------------------------

def _xent_inputs(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 8)).astype(np.float32)
    w = (rng.standard_normal((8, 50)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 50, (2, S)).astype(np.int32)
    labels[0, ::5] = -1
    return x, w, labels


@pytest.mark.parametrize("S,chunk", [(37, 16), (37, 512), (32, 16)])
def test_softmax_xent_chunked_value_and_grad_match(S, chunk):
    from repro.models.layers import softmax_xent_chunked
    x, w, labels = _xent_inputs(S)

    def ref(x, w):
        return softmax_xent_chunked(lambda xc: xc @ w, x, jnp.asarray(labels),
                                    chunk=chunk)
    want, (gx, gw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = TL.softmax_xent_chunked(lambda xc: xc @ wt, xt, _t(labels),
                                  chunk=chunk)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    _close(xt.grad.numpy(), gx, 1e-5, 1e-6)
    _close(wt.grad.numpy(), gw, 1e-5, 1e-6)


def test_softmax_xent_sharded_value_and_grad_match():
    from repro.models.layers import softmax_xent_sharded
    x, w, labels = _xent_inputs(21)
    want, (gx, gw) = jax.value_and_grad(
        lambda x, w: softmax_xent_sharded(x, w, jnp.asarray(labels)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = TL.softmax_xent_sharded(xt, wt, _t(labels))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    _close(xt.grad.numpy(), gx, 1e-5, 1e-6)
    _close(wt.grad.numpy(), gw, 1e-5, 1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,H,KV,hd,q_offset", [
    (40, 40, 4, 2, 16, 0),     # GQA
    (33, 33, 4, 1, 8, 0),      # MQA, ragged S
    (24, 24, 2, 2, 16, 0),     # MHA
    (8, 24, 4, 2, 16, 16),     # queries after a 16-key prefix
])
def test_flash_attention_grad_matches_jax_grad(Sq, Sk, H, KV, hd, q_offset,
                                               causal):
    """``blockwise_attention`` with a gradient goes through FlashAttention
    (plain forward and backward on the CPU) and agrees with jax.grad of the
    reference's blockwise attention on q, k and v."""
    from repro.models.layers import blockwise_attention
    rng = np.random.default_rng(Sq + Sk + H + hd)
    q = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
    r = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)

    def ref(q, k, v):
        o = blockwise_attention(q, k, v, causal=causal, block=16,
                                q_offset=q_offset)
        return jnp.sum(o * r), o
    (_, o_want), grads = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o = TL.blockwise_attention(qt, kt, vt, causal=causal, q_offset=q_offset)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (o * _t(r)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_want),
                               rtol=1e-4, atol=1e-5)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_flash_lse_is_the_rows_logsumexp():
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((1, 9, 4, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, 12, 2, 8)).astype(np.float32))
    o, lse = flash_ops.flash_attention(q, k, k.clone(), causal=True,
                                       q_offset=3, return_lse=True)
    assert torch.equal(o, flash_ops.flash_attention(q, k, k.clone(),
                                                    causal=True, q_offset=3))
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(2, dim=2)) / 8 ** 0.5
    mask = torch.arange(12)[None] <= 3 + torch.arange(9)[:, None]
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert lse.shape == (1, 4, 9) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("G,E,C,d,f", [(2, 4, 6, 8, 5), (1, 3, 9, 16, 16),
                                       (3, 2, 8, 12, 7)])
def test_expert_gemm_grad_matches_jax_grad(G, E, C, d, f):
    rng = np.random.default_rng(G + E + C + d + f)
    x = rng.standard_normal((G * E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    r = rng.standard_normal((G * E, C, f)).astype(np.float32)

    def ref(x, w):
        y = jnp.einsum("gecd,edf->gecf", x.reshape(G, E, C, d), w)
        return jnp.sum(y.reshape(G * E, C, f) * r)
    gx, gw = jax.grad(ref, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    (ExpertGemm.apply(xt, wt) * _t(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,E,C,d,f", [(2, 4, 6, 8, 5), (4, 8, 88, 64, 72),
                                       (3, 2, 8, 12, 7)])
def test_expert_gemm_grad_on_the_cpu_is_bitwise_the_copies_route(G, E, C, d,
                                                                 f, dtype):
    """``ExpertGemm``'s gradients on CPU tensors are, bit for bit, those of
    the route before the backward had kernels of its own: ``expert_gemm``
    on a contiguous Wᵀ for dX, and on X, dY copied to (E, d, G·C) ×
    (E, G·C, f) for dW."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(G * E + C)
    x = _t(rng.standard_normal((G * E, C, d)).astype(np.float32)).to(tdt)
    w = _t(rng.standard_normal((E, d, f)).astype(np.float32)).to(tdt)
    dy = _t(rng.standard_normal((G * E, C, f)).astype(np.float32)).to(tdt)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    ExpertGemm.apply(xg, wg).backward(dy)
    want_dx = gemm_ops.expert_gemm(dy, w.transpose(1, 2).contiguous())
    xt = x.view(G, E, C, d).permute(1, 3, 0, 2).reshape(E, d, G * C)
    dyt = dy.view(G, E, C, f).transpose(0, 1).reshape(E, G * C, f)
    want_dw = gemm_ops.expert_gemm(xt.contiguous(), dyt.contiguous())
    assert xg.grad.dtype == tdt and torch.equal(xg.grad, want_dx)
    assert wg.grad.dtype == tdt and torch.equal(wg.grad, want_dw)


@pytest.mark.parametrize("G,S,k,E,d", [(2, 16, 2, 4, 8), (1, 24, 8, 16, 16),
                                       (4, 9, 3, 5, 5)])
def test_dispatch_gather_backward_sums_slots_in_sorted_order(G, S, k, E, d):
    """The MoE dispatch gather's backward adds each token's k slot
    gradients from zero in ascending sorted-slot order: bit for bit an
    explicit loop over the sorted slots (gradients spread over six
    decades, so another order would round differently)."""
    from repro_torch.models import moe as TM
    rng = np.random.default_rng(G * S + k)
    experts = torch.as_tensor(rng.integers(0, E, (G, S * k)))
    perm = torch.sort(experts, dim=1, stable=True).indices
    tokens = perm // k                 # slot t·k + j belongs to token t
    order = TM.slot_order(perm, k)
    x = torch.as_tensor(rng.standard_normal((G, S, d)).astype(np.float32))
    x.requires_grad_()
    y = TM.DispatchGather.apply(x, tokens, order)
    assert torch.equal(y.detach(), x.detach().gather(
        1, tokens[..., None].expand(G, S * k, d)))
    g = torch.as_tensor((rng.standard_normal((G, S * k, d))
                         * 10.0 ** rng.uniform(-3, 3, (G, S * k, 1)))
                        .astype(np.float32))
    y.backward(g)
    want = torch.zeros((G, S, d))
    for gi in range(G):
        for i in range(S * k):         # ascending sorted position
            t = int(tokens[gi, i])
            want[gi, t] = want[gi, t] + g[gi, i]
    assert torch.equal(x.grad, want)


# -- the model's loss and gradients ------------------------------------------------

def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[1, -3:] = -1
    return toks, labels


def test_loss_and_every_gradient_leaf_match_reference(lm):
    name, cfg, rmodel, rparams, model = lm
    toks, labels = _batch(cfg, 7)
    want, rgrads = jax.value_and_grad(rmodel.loss)(rparams, toks, labels)
    params = _port_params(cfg, rparams)
    for p in TA.tree_leaves(params):
        p.requires_grad_()
    got = model.loss(params, _t(toks), _t(labels))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    grads = _leaves_ref_layout(TA.tree_map(lambda p: p.grad, params))
    want_g = _leaves_jax(rgrads)
    assert sorted(grads) == sorted(want_g)
    for key in want_g:
        _close(grads[key], want_g[key], 1e-4, 1e-5)


def test_remat_full_gives_bitwise_equal_grads_and_recomputes(monkeypatch):
    """``remat="full"`` recomputes each layer in the backward pass (the
    flash forward and the three expert products run twice per layer) and
    gives the same gradient bits as ``remat="none"``."""
    from repro.models.transformer import TransformerLM as RLM
    calls = {"flash": 0, "gemm": 0}
    flash = flash_ops.flash_attention

    def count_flash(*a, **kw):
        calls["flash"] += 1
        return flash(*a, **kw)

    def counted(fn):
        def count_gemm(*a, **kw):
            calls["gemm"] += 1
            return fn(*a, **kw)
        return count_gemm
    monkeypatch.setattr(flash_ops, "flash_attention", count_flash)
    # the three products forward and their dX and dW backward
    for name in ("expert_gemm", "expert_gemm_dx", "expert_gemm_dw"):
        monkeypatch.setattr(gemm_ops, name, counted(getattr(gemm_ops, name)))
    cfg = qcfg.SMOKE
    rparams = RLM(_jax_cfg(cfg)).init(jax.random.PRNGKey(1))
    toks, labels = _batch(cfg, 8)
    out = {}
    for remat in ("none", "full"):
        model = TransformerLM(dataclasses.replace(cfg, remat=remat))
        params = _port_params(cfg, rparams)
        for p in TA.tree_leaves(params):
            p.requires_grad_()
        calls.update(flash=0, gemm=0)
        loss = model.loss(params, _t(toks), _t(labels))
        loss.backward()
        out[remat] = (loss.detach(),
                      [p.grad for p in TA.tree_leaves(params)], dict(calls))
    L = cfg.n_layers
    assert out["none"][2] == {"flash": L, "gemm": 3 * L + 6 * L}
    assert out["full"][2] == {"flash": 2 * L, "gemm": 6 * L + 6 * L}
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


def test_remat_dots_waits_for_its_item():
    """Its item (ROADMAP 13.2) has landed: ``remat="dots"`` is accepted and
    gives ``remat="none"``'s loss bit for bit (its gradients and recompute
    are held per config in ``tests/test_torch_lm_configs.py``); an unknown
    policy is still refused."""
    toks = torch.zeros((1, 4), dtype=torch.int32)
    losses = []
    for remat in ("none", "dots"):
        model = TransformerLM(dataclasses.replace(DENSE, remat=remat))
        params = model.init(torch.Generator().manual_seed(0),
                            dtype=torch.float32)
        for p in TA.tree_leaves(params):
            p.requires_grad_()
        losses.append(model.loss(params, toks, toks))
    assert torch.equal(losses[0].detach(), losses[1].detach())
    model = TransformerLM(dataclasses.replace(DENSE, remat="some"))
    with pytest.raises(ValueError, match="unknown remat"):
        model.forward(params, toks)


def test_init_keeps_f32_masters_on_request():
    model = TransformerLM(dataclasses.replace(qcfg.SMOKE, dtype="bfloat16"))
    serve = model.init(torch.Generator().manual_seed(0))
    train = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    assert serve["layers"][0]["moe"]["wg"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in TA.tree_leaves(train))
    # the same draws, rounded for serving
    assert torch.equal(train["embed"].to(torch.bfloat16), serve["embed"])


# -- the train step ----------------------------------------------------------------

TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
N_STEPS = 3


def _ref_state(rparams):
    from repro.train.state import new_train_state as rnew
    return rnew(rparams)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(lm, microbatches):
    from repro.train.state import make_train_step as rmake
    name, cfg, rmodel, rparams, model = lm
    rstep = jax.jit(rmake(rmodel.loss, TCFG, microbatches=microbatches))
    tstep = make_train_step(model.loss, TCFG, microbatches=microbatches)
    rstate = _ref_state(rparams)
    tstate = new_train_state(_port_params(cfg, rparams))
    for i in range(N_STEPS):
        toks, labels = _batch(cfg, 100 + i, B=4)
        rstate, rm = rstep(rstate, jnp.asarray(toks), jnp.asarray(labels))
        tstate, tm = tstep(tstate, _t(toks), _t(labels))
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=1e-4)
        assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-7)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
    assert int(tstate.opt.step) == int(rstate.opt.step) == N_STEPS
    got = _leaves_ref_layout(tstate.params)
    want = _leaves_jax(rstate.params)
    # a flipped sign-like update differs by at most 2·lr per step
    flips = 2 * TCFG.learning_rate * N_STEPS
    n_out = n_all = 0
    for key in want:
        a, b = got[key], want[key]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=flips)
        n_out += int((np.abs(a - b) > 1e-4 * np.abs(b) + 1e-6).sum())
        n_all += b.size
    assert n_out <= 1e-3 * n_all, f"{n_out} of {n_all} entries"


# -- the loop and its checkpoints ---------------------------------------------------

def _loop(cfg, state, tmp_path, print_fn=print, **kw):
    model = TransformerLM(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=3,
                       checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       **kw)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=0)
    return TrainLoop(make_train_step(model.loss, tcfg), state, pipe.batch_at,
                     tcfg, log_every=1, print_fn=print_fn)


def _fresh_state(cfg, seed=0):
    model = TransformerLM(cfg)
    return new_train_state(model.init(torch.Generator().manual_seed(seed),
                                      dtype=torch.float32))


def _state_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(TA.tree_leaves(a),
                                                 TA.tree_leaves(b)))


def test_loop_restores_on_start_and_resumes_at_the_next_step(tmp_path):
    cfg = qcfg.SMOKE
    lines = []
    loop = _loop(cfg, _fresh_state(cfg), tmp_path, print_fn=lines.append)
    assert loop.start_step == 0
    metrics = loop.run()
    assert metrics.steps == [0, 1, 2]
    assert all(np.isfinite(metrics.losses))
    assert loop.ckpt.all_steps() == [1, 2]
    assert sum("step 0 loss" in ln for ln in lines) == 1
    again = _loop(cfg, _fresh_state(cfg, seed=5), tmp_path,
                  print_fn=lines.append)
    assert again.start_step == 3
    assert "[loop] restored checkpoint step 2" in lines
    assert _state_equal(again.state, loop.state)
    assert int(again.state.opt.step) == 3
    assert again.run(1).steps == [3]


def test_loop_checkpoints_and_stops_on_sigterm(tmp_path):
    cfg = DENSE
    lines = []
    loop = _loop(cfg, _fresh_state(cfg), tmp_path, print_fn=lines.append)
    batch_at = loop.batch_fn

    def batch_fn(step):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch_at(step)
    loop.batch_fn = batch_fn
    prev = signal.getsignal(signal.SIGTERM)
    metrics = loop.run(10)
    assert signal.getsignal(signal.SIGTERM) is prev
    assert metrics.steps == [0, 1]
    assert "[loop] SIGTERM — checkpointing at 2" in lines
    assert loop.ckpt.latest_step() == 2


def test_checkpoints_cross_packages_both_ways(tmp_path):
    """A port checkpoint restores into the reference's TrainLoop state, and
    a reference checkpoint (its Checkpointer, as its TrainLoop saves) into
    the port's TrainLoop, bitwise."""
    from repro.checkpoint.checkpointer import Checkpointer as RCkpt
    from repro.config.base import TrainConfig as RTC
    from repro.models.transformer import TransformerLM as RLM
    from repro.optim.adamw import AdamWState as RState
    from repro.train.loop import TrainLoop as RLoop
    from repro.train.state import TrainState as RTrainState
    cfg = qcfg.SMOKE
    rmodel = RLM(_jax_cfg(cfg))
    rparams = rmodel.init(jax.random.PRNGKey(3))
    # port → reference
    port = _loop(cfg, _fresh_state(cfg), tmp_path / "port",
                 print_fn=lambda *_: None)
    port.run(2)
    rcfg = RTC(checkpoint_dir=str(tmp_path / "port"), total_steps=3)
    rloop = RLoop(lambda s, *b: (s, {}), _ref_state(rparams),
                  lambda step: (), rcfg, print_fn=lambda *_: None)
    assert rloop.start_step == 2
    want = train_state_to_jax(port.state)
    for a, b in zip(jax.tree.leaves(rloop.state), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # reference → port
    rng = np.random.default_rng(9)
    noise = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), rparams)
    rstate = RTrainState(rparams, RState(jnp.asarray(7, jnp.int32), noise,
                                         jax.tree_util.tree_map(np.abs,
                                                                noise)))
    ck = RCkpt(str(tmp_path / "ref"), async_save=False)
    ck.save(7, rstate)
    loop = _loop(cfg, _fresh_state(cfg), tmp_path / "ref",
                 print_fn=lambda *_: None)
    assert loop.start_step == 8 and int(loop.state.opt.step) == 7
    want = _leaves_jax(rstate)
    got = _leaves_ref_layout(loop.state)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_train_state_crosses_packages_bitwise():
    from repro.models.transformer import TransformerLM as RLM
    cfg = qcfg.SMOKE
    rparams = RLM(_jax_cfg(cfg)).init(jax.random.PRNGKey(2))
    rstate = _ref_state(jax.tree_util.tree_map(np.asarray, rparams))
    rstate = rstate._replace(opt=rstate.opt._replace(
        step=np.asarray(5, np.int32)))
    state = train_state_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                             rstate),
                                 device="cpu")
    assert isinstance(state, TrainState)
    assert state.params["layers"][0]["moe"]["wg"].dtype == torch.float32
    assert int(state.opt.step) == 5 and state.opt.step.dtype == torch.int32
    back = train_state_to_jax(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_straggler_monitor_matches_reference():
    from repro.distrib.fault import StragglerMonitor as RMon
    rng = np.random.default_rng(0)
    ours, theirs = StragglerMonitor(), RMon()
    for step in range(8):
        for rank in range(5):
            dt = float(rng.uniform(0.9, 1.1)) + (2.0 if rank == 3 else 0.0)
            ours.record(rank, dt)
            theirs.record(rank, dt)
        assert ours.stragglers() == theirs.stragglers()
    assert ours.stragglers() == [3]


# -- the CLI -----------------------------------------------------------------------

def test_train_cli_runs_on_cpu_and_prints_losses(capsys):
    ttrain.main(["--arch", "qwen3-moe-30b-a3b", "--steps", "3",
                 "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in out.splitlines() if ln.strip().startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "final loss" in out


def test_train_cli_feeds_the_reference_cells_batch():
    """The port's reduced train cell: the reference cell's tokens and
    labels, batch and sequence, and MoE group size."""
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell
    arch = rget("qwen3-moe-30b-a3b", smoke=True)
    cell = build_cell(arch, "train_4k", concrete=True, smoke=True)
    model, state, toks, labels = ttrain.lm_train_cell(
        qcfg.SMOKE, "train_4k", torch.device("cpu"))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(cell.args[1]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(cell.args[2]))
    assert model.moe_group_size == 64
    assert int(state.opt.step) == 0


@pytest.mark.parametrize("arch_id,item", [("dimenet", "13.3"),
                                          ("schnet", "13.3"),
                                          ("graphcast", "13.3"),
                                          ("bst", "13.4"),
                                          ("meshgraphnet", "13.3")])
def test_train_cli_names_the_item_an_unported_arch_waits_for(arch_id, item,
                                                           capsys):
    """The archs that waited for items 13.3 (GNNs) and 13.4 (BST) are
    ported: the CLI trains their reduced cell and prints finite losses."""
    ttrain.main(["--arch", arch_id, "--device", "cpu", "--steps", "2",
                 "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in out.splitlines() if ln.strip().startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all(), (item, out)


def test_train_cli_refuses_an_arch_without_a_train_shape():
    with pytest.raises(SystemExit, match="no train shape"):
        ttrain.main(["--arch", "igpm-pem", "--device", "cpu"])


# -- package re-exports ------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["config", "optim", "train", "models",
                                 "data", "distrib"])
def test_packages_export_what_the_reference_exports(pkg):
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    ours = importlib.import_module(f"repro_torch.{pkg}")
    want = list(ref.__all__)
    assert want and set(want) <= set(ours.__all__)
    for name in want:
        assert getattr(ours, name) is not None
