"""BST in the port against the JAX package, on the CPU: the cells' inputs,
forward, loss, every gradient leaf, retrieval scores, the train step (one
and two microbatches) and both CLIs.

Weights come from the reference's ``BST.init`` through
``bst_params_from_jax``; inputs are the SMOKE cells' (``launch/cells.py``
of both packages draw them from ``numpy.random.default_rng(0)`` in one
order), and must be equal bit for bit. Tolerances, f32: logits, click
probabilities and retrieval scores to rtol 1e-5 / atol 1e-6 (matmuls and
the attention softmax summed in another order); the loss to rtol 1e-6;
every gradient leaf to rtol 1e-4 plus 1e-5 of the leaf's largest entry
(the tolerance of ``tests/test_torch_train.py``); three train steps' losses
and grad norms to rtol 1e-4 and the parameters to rtol 1e-4 plus the
flips of a sign-like Adam update (2·lr per step), as there.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.config.base import TrainConfig  # noqa: E402
from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.recsys.bst import (BST, BSTInputs,  # noqa: E402
                                           bst_params_from_jax)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.state import (make_train_step,  # noqa: E402
                                     new_train_state)

torch.set_num_threads(1)

SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
CPU = torch.device("cpu")


def _close(got, want, rtol, floor):
    """|got − want| ≤ rtol·|want| + floor·max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = floor * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def flat_port(tree, prefix=""):
    """{"a/b": f32 numpy} of a port tree (dicts of tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_port(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree.detach().float().numpy()}


def flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(p.key) for p in path)] = np.asarray(leaf,
                                                             np.float32)
    return out


def _ref_cell(shape):
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell
    return build_cell(rget("bst", smoke=True), shape, concrete=True,
                      smoke=True)


@pytest.fixture(scope="module")
def bst():
    """(JAX model, JAX params, port model, port params, SMOKE cfg)."""
    from repro.models.recsys.bst import BST as RBST
    cfg = get_arch("bst", smoke=True).model
    rmodel = RBST(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    return rmodel, rparams, BST(cfg), bst_params_from_jax(cfg, rparams,
                                                          "cpu"), cfg


def _inputs(shape="train_batch"):
    cell = tcells.bst_cell(get_arch("bst", smoke=True), shape, CPU,
                           smoke=True)
    return cell, _ref_cell(shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_inputs_match_reference_bitwise(shape):
    cell, ref = _inputs(shape)
    assert (cell.kind, cell.meta) == (ref.kind, ref.meta)
    ours, theirs = cell.args[1:], ref.args[1:]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a = list(a) if isinstance(a, BSTInputs) else [a]
        b = list(b) if isinstance(b, tuple) else [b]
        for x, y in zip(a, b):
            assert x.dtype == torch.from_numpy(np.array(y)).dtype
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_retrieval_candidates_pad_to_512():
    from repro.launch.cells import _pad512
    n = get_arch("bst").shape("retrieval_cand").dims["n_candidates"]
    assert tcells.pad512(n) == _pad512(n) == 1_000_448


@pytest.mark.parametrize("out_of_range", [False, True])
def test_forward_matches_reference(bst, out_of_range):
    """Logits; with an item id past the table and a user-feature id below
    -V, the rows they reach are NaN in both (``jnp.take``'s fill)."""
    rmodel, rparams, model, params, cfg = bst
    cell, ref = _inputs()
    rin = ref.args[1]
    if out_of_range:
        rin = rin._replace(
            item_hist=rin.item_hist.at[1, 2].set(cfg.n_items + 3),
            user_feats=rin.user_feats.at[3, 1].set(-cfg.user_feat_vocab - 1))
    tin = BSTInputs(*(torch.from_numpy(np.array(a)) for a in rin))
    want = np.asarray(rmodel.forward(rparams, rin))
    got = model.forward(params, tin).detach().numpy()
    assert np.isnan(want).sum() == (2 if out_of_range else 0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def test_loss_and_every_gradient_leaf_match_reference(bst):
    rmodel, rparams, model, params, cfg = bst
    _, ref = _inputs()
    rin = ref.args[1]
    tin = BSTInputs(*(torch.from_numpy(np.array(a)) for a in rin))
    want, rgrads = jax.value_and_grad(rmodel.loss)(rparams, rin)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
        p.grad = None
    loss = model.loss(params, tin)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    grads = flat_port({k: _grads(v) for k, v in params.items()})
    rflat = flat_jax(rgrads)
    assert sorted(grads) == sorted(rflat)
    for key in rflat:
        _close(grads[key], rflat[key], 1e-4, 1e-5)
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None


def _grads(node):
    if isinstance(node, dict):
        return {k: _grads(v) for k, v in node.items()}
    return node.grad if node.grad is not None else torch.zeros_like(node)


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_click_probabilities_match_reference(bst, shape):
    rmodel, rparams, model, params, cfg = bst
    cell, ref = _inputs(shape)
    want = np.asarray(ref.step_fn(rparams, ref.args[1]))
    with torch.no_grad():
        got = cell.step_fn(params, cell.args[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_retrieval_scores_match_reference(bst):
    rmodel, rparams, model, params, cfg = bst
    cell, ref = _inputs("retrieval_cand")
    want = np.asarray(ref.step_fn(rparams, *ref.args[1:]))
    with torch.no_grad():
        got = cell.step_fn(params, *cell.args[1:]).numpy()
    assert got.shape == want.shape == (1, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
N_STEPS = 3


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(bst, microbatches):
    """Three steps on the train cell's batch (8 rows; 2 microbatches of 4
    split by the port's tree map over ``BSTInputs``)."""
    from repro.train.state import make_train_step as rmake
    from repro.train.state import new_train_state as rnew
    rmodel, rparams, model, _, cfg = bst
    _, ref = _inputs()
    rin = ref.args[1]
    tin = BSTInputs(*(torch.from_numpy(np.array(a)) for a in rin))
    rstep = jax.jit(rmake(rmodel.loss, TCFG, microbatches=microbatches))
    tstep = make_train_step(model.loss, TCFG, microbatches=microbatches)
    rstate = rnew(rparams)
    tstate = new_train_state(bst_params_from_jax(cfg, rparams, "cpu"))
    for _ in range(N_STEPS):
        rstate, rm = rstep(rstate, rin)
        tstate, tm = tstep(tstate, tin)
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
    got, want = flat_port(tstate.params), flat_jax(rstate.params)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=flips)


def test_microbatches_split_named_tuples_and_pass_none_through():
    """The port's split of a batch tree: every tensor of a named tuple
    reshaped and sliced, ``None`` fields kept (``jax.tree.map``'s view)."""
    from repro_torch.models.gnn.common import GraphInputs
    seen = []

    def loss_fn(params, g):
        seen.append(g)
        return (params["w"] * g.node_feat).sum()

    step = make_train_step(loss_fn, TCFG, microbatches=2)
    g = GraphInputs(torch.arange(8.0).reshape(4, 2), torch.arange(4),
                    torch.arange(4), torch.zeros(4, 1))
    state = new_train_state({"w": torch.ones(2)})
    step(state, g)
    assert len(seen) == 2
    for i, part in enumerate(seen):
        assert part.positions is None and part.trip_kj is None
        np.testing.assert_array_equal(part.node_feat.numpy(),
                                      g.node_feat[2 * i:2 * i + 2].numpy())
        np.testing.assert_array_equal(part.senders.numpy(), [2 * i,
                                                             2 * i + 1])


def test_configs_match_reference():
    from repro.configs import bst as rb
    from repro_torch.configs import bst as tb
    for ours, theirs in ((tb.FULL, rb.FULL), (tb.SMOKE, rb.SMOKE)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert tb.full().source == rb.full().source
    # the FULL model's size: 153,865,665 parameters (2.46 GB at 16 B each)
    model = BST(tb.FULL)
    d, e = model.d_model, tb.FULL.embed_dim
    dims = ((tb.FULL.seq_len + 1) * d + tb.FULL.n_user_feats * e,) \
        + tb.FULL.mlp_dims + (1,)
    n = (tb.FULL.n_items + tb.FULL.n_cates) * e + (tb.FULL.seq_len + 1) * d \
        + tb.FULL.n_user_feats * tb.FULL.user_feat_vocab * e + 2 * d \
        + 4 * d * d + 8 * d * d + sum(a * b + b for a, b in zip(dims[:-1],
                                                             dims[1:]))
    assert n == 153_865_665


def test_serve_cli_scores_the_reduced_serve_cell(capsys):
    tserve.main(["--arch", "bst", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] bst p99-path batch=4:" in out and "ms/batch" in out
    probs = out.split("probs[:4]=")[1]
    cell = tcells.bst_cell(get_arch("bst", smoke=True), "serve_p99", CPU,
                           smoke=True)
    with torch.no_grad():
        want = cell.step_fn(*cell.args)[:4].numpy().round(3)
    assert probs.strip() == str(want)


def test_train_cli_trains_the_reduced_train_cell(capsys):
    ttrain.main(["--arch", "bst", "--device", "cpu", "--steps", "3",
                 "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[train] bst/train_batch (reduced config) — 3 steps on cpu" in out
    cell = tcells.bst_cell(get_arch("bst", smoke=True), "train_batch", CPU,
                           smoke=True)
    state, inputs = cell.args
    losses = []
    for _ in range(3):
        state, m = cell.step_fn(state, inputs)
        losses.append(f"loss {float(m['loss']):.4f}")
    for line, want in zip([ln for ln in out.splitlines() if "step" in ln
                           and "loss" in ln], losses):
        assert want in line
