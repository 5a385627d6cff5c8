"""The other LM configs — smollm-135m, deepseek-7b, qwen2-72b, dbrx-132b —
and ``remat="dots"`` in the port against the JAX package, on the CPU.

Each case takes one config's ``SMOKE`` (f32, 2 layers): smollm's tied
embeddings and GQA at G 3, deepseek's MHA (G 1), qwen2's QKV bias at G 4,
dbrx's 4 experts top-2. Weights come from the JAX package's
``TransformerLM.init`` through ``params_from_jax``; both inits zero the
QKV biases, so the biases are redrawn here (seeded, nonzero) before either
side sees them. The port runs its plain versions (CPU tensors).

Tolerances are those of ``tests/test_torch_lm.py`` and
``tests/test_torch_train.py``: prefill and decode logits to rtol 1e-4 /
atol 1e-4, the bf16 KV caches within one bf16 step on at most 0.5 % of
their entries; the loss to rtol 1e-5 and every gradient leaf to rtol 1e-4
plus 1e-5 of the leaf's largest entry. ``remat="dots"`` must give the
reference's dots gradients within those tolerances and the port's
``remat="none"`` gradients bit for bit; its recompute is counted: the
flash forward and the expert products run twice per layer, ``aten.mm`` and
``aten.addmm`` (the products it saves) as often as without remat.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.kernels.expert_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.transformer import (TransformerLM,  # noqa: E402
                                            params_from_jax)
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

from test_torch_lm import _assert_bf16_cache_close, _jax_cfg  # noqa: E402
from test_torch_train import (_batch, _close, _leaves_jax,  # noqa: E402
                              _leaves_ref_layout)

torch.set_num_threads(1)

CONFIGS = {"smollm-135m": "smollm_135m", "deepseek-7b": "deepseek_7b",
           "qwen2-72b": "qwen2_72b", "dbrx-132b": "dbrx_132b"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_params(rmodel, cfg, seed=0):
    """The reference's init, with nonzero QKV biases where the config has
    them (both packages' inits zero them)."""
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 11)
        layers = dict(rparams["layers"])
        for key in ("bq", "bk", "bv"):
            layers[key] = jnp.asarray(
                0.1 * rng.standard_normal(layers[key].shape)
                .astype(np.float32))
        rparams = dict(rparams, layers=layers)
    return rparams


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lm(request):
    """(arch id, port cfg, JAX model, JAX params, port model)."""
    from repro.models.transformer import TransformerLM as RLM
    mod = importlib.import_module(
        f"repro_torch.configs.{CONFIGS[request.param]}")
    cfg = mod.SMOKE
    rmodel = RLM(_jax_cfg(cfg))
    return request.param, cfg, rmodel, _ref_params(rmodel, cfg), \
        TransformerLM(cfg)


def _port(cfg, rparams, dtype=None):
    return params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, rparams),
                           device="cpu", dtype=dtype)


@pytest.mark.parametrize("arch_id", sorted(CONFIGS))
def test_configs_match_reference(arch_id):
    from repro.config.registry import get_arch as r_get_arch
    for smoke in (False, True):
        ours, theirs = get_arch(arch_id, smoke), r_get_arch(arch_id, smoke)
        assert (ours.arch_id, ours.family, ours.source) == \
            (theirs.arch_id, theirs.family, theirs.source)
        assert dataclasses.asdict(ours.model) == \
            dataclasses.asdict(theirs.model)
        assert [dataclasses.asdict(s) for s in ours.shapes] == \
            [dataclasses.asdict(s) for s in theirs.shapes]


def test_prefill_and_decode_match(lm):
    arch_id, cfg, rmodel, rparams, model = lm
    params = _port(cfg, rparams)
    if cfg.tie_embeddings:
        assert "head" not in params
    if cfg.qkv_bias:
        assert all(bool(lay[key].abs().min() > 0) for lay in params["layers"]
                   for key in ("bq", "bk", "bv"))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    logits_j, (ks_j, vs_j) = rmodel.prefill(rparams, toks)
    logits_t, (ks_t, vs_t) = model.prefill(params, _t(toks))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)
    for got, want in ((ks_t, ks_j), (vs_t, vs_j)):
        _assert_bf16_cache_close(got, want)
    # one decode step, from the reference's own (padded) cache
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    ks_j, vs_j = jnp.pad(ks_j, pad), jnp.pad(vs_j, pad)
    cache = tuple(torch.from_numpy(np.asarray(c).astype(np.float32))
                  .to(torch.bfloat16) for c in (ks_j, vs_j))
    tok = np.array([[7], [3]], np.int32)
    logits_j, _ = rmodel.decode_step(rparams, jnp.asarray(tok), (ks_j, vs_j),
                                     jnp.asarray(12, jnp.int32))
    logits_t, _ = model.decode_step(params, _t(tok), cache, 12)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)


def test_loss_and_every_gradient_leaf_match(lm):
    arch_id, cfg, rmodel, rparams, model = lm
    toks, labels = _batch(cfg, 7)
    want, rgrads = jax.value_and_grad(rmodel.loss)(rparams, toks, labels)
    params = _port(cfg, rparams, torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_()
    got = model.loss(params, _t(toks), _t(labels))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    grads = _leaves_ref_layout(tree_map(lambda p: p.grad, params))
    want_g = _leaves_jax(rgrads)
    assert sorted(grads) == sorted(want_g)
    for key in want_g:
        _close(grads[key], want_g[key], 1e-4, 1e-5)


class _CountProducts(TorchDispatchMode):
    """Counts the ``aten.mm``/``aten.addmm`` calls that run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_matches_reference_and_none(lm, monkeypatch):
    from repro.models.transformer import TransformerLM as RLM
    arch_id, cfg, _, rparams, _ = lm
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
    toks, labels = _batch(cfg, 9)
    dots = dataclasses.replace(cfg, remat="dots")
    _, rgrads = jax.value_and_grad(RLM(_jax_cfg(dots)).loss)(rparams, toks,
                                                              labels)
    out = {}
    for remat in ("none", "dots"):
        model = TransformerLM(dataclasses.replace(cfg, remat=remat))
        params = _port(cfg, rparams, torch.float32)
        for p in tree_leaves(params):
            p.requires_grad_()
        calls.update(flash=0, gemm=0)
        with _CountProducts() as products:
            loss = model.loss(params, _t(toks), _t(labels))
            loss.backward()
        out[remat] = (loss.detach(), params, dict(calls, mm=products.n))
    L = cfg.n_layers
    moe = cfg.moe is not None
    assert out["none"][2] == {"flash": L, "gemm": 9 * L if moe else 0,
                              "mm": out["none"][2]["mm"]}
    # the flash forward and the three expert products run again in the
    # recompute; no saved product does
    assert out["dots"][2] == {"flash": 2 * L, "gemm": 12 * L if moe else 0,
                              "mm": out["none"][2]["mm"]}
    assert out["none"][2]["mm"] > 0
    assert torch.equal(out["none"][0], out["dots"][0])
    for a, b in zip(tree_leaves(out["none"][1]), tree_leaves(out["dots"][1])):
        assert torch.equal(a.grad, b.grad)
    grads = _leaves_ref_layout(tree_map(lambda p: p.grad, out["dots"][1]))
    want_g = _leaves_jax(rgrads)
    assert sorted(grads) == sorted(want_g)
    for key in want_g:
        _close(grads[key], want_g[key], 1e-4, 1e-5)


@pytest.mark.parametrize("arch_id", sorted(CONFIGS))
def test_serve_and_train_clis_run_on_cpu(arch_id, capsys):
    tserve.main(["--arch", arch_id, "--tokens", "4", "--device", "cpu"])
    ttrain.main(["--arch", arch_id, "--steps", "2", "--log-every", "1",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "greedy continuation" in out
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in out.splitlines() if ln.strip().startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_state_crosses_packages_bitwise(lm):
    """The reference's fresh ``TrainState`` (f32 masters, zero moments) as
    the port's train state and back, every leaf bit for bit."""
    from repro.train.state import new_train_state as rnew
    from repro_torch.models.transformer import (train_state_from_jax,
                                                train_state_to_jax)
    arch_id, cfg, _, rparams, _ = lm
    tree = jax.tree_util.tree_map(np.asarray, rnew(rparams))
    state = train_state_from_jax(cfg, tree, device="cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.params))
    back = train_state_to_jax(state)
    want = _leaves_jax(tree)
    got = {k.replace("/opt/", "/").replace("opt/", ""): v
           for k, v in _leaves_jax(back).items()}
    want = {k.replace("/opt/", "/").replace("opt/", ""): v
            for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
