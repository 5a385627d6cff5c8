"""SchNet, DimeNet, MeshGraphNet and GraphCast in the port against the JAX
package, on the CPU: the cells' inputs, forward, loss, every gradient
leaf, three train steps, the bf16 compute path, JAX's handling of ids out
of range, and the train CLI.

Weights come from the reference cell's ``init`` through
``gnn_params_from_jax``; inputs are the SMOKE cells' (``launch/cells.py``
of both packages draw them from ``numpy.random.default_rng(0)`` in one
order) and must be equal bit for bit. Tolerances, f32: predictions to
rtol 1e-5 plus 1e-6 of the largest |prediction| (matmuls summed in
another order; DimeNet's ``arccos``, ``sin`` and ``cos`` round differently
from XLA's by a few ulps), the loss to rtol 1e-5, every gradient leaf to
rtol 1e-4 plus 1e-5 of the leaf's largest entry (the tolerance of
``tests/test_torch_train.py``), three train steps' losses and grad norms
to rtol 1e-4. The bf16 path (``dtype="bfloat16"``: bf16 message passing
from f32 parameters) to rtol 2e-2 plus 2e-2 of the largest |prediction|:
bf16 rounds at 2⁻⁸ relative, after a few layers of sums in another order.
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
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.gnn.common import (GraphInputs,  # noqa: E402
                                           gnn_params_from_jax, make_model)
from repro_torch.models.gnn.graphcast import mesh_sizes  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.state import (make_train_step,  # noqa: E402
                                     new_train_state)

from test_torch_bst import _close, _grads, flat_jax, flat_port  # noqa: E402

torch.set_num_threads(1)

KINDS = ("schnet", "dimenet", "meshgraphnet", "graphcast")
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
CPU = torch.device("cpu")


def _ref_cell(kind, shape, **model_kw):
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell
    arch = rget(kind, smoke=True)
    if model_kw:
        arch = arch.replace_model(**model_kw)
    return build_cell(arch, shape, concrete=True, smoke=True)


def _port_inputs(rinputs) -> GraphInputs:
    return GraphInputs(*(None if a is None else torch.from_numpy(np.array(a))
                         for a in rinputs))


def _models(kind, **model_kw):
    from repro.models.gnn.common import make_model as rmake
    arch = get_arch(kind, smoke=True)
    if model_kw:
        arch = arch.replace_model(**model_kw)
    cfg = arch.model
    return rmake(cfg), make_model(cfg)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_cell_inputs_match_reference_bitwise(kind, shape):
    ref = _ref_cell(kind, shape)
    cell = tcells.gnn_cell(get_arch(kind, smoke=True), shape, CPU,
                           smoke=True)
    assert (cell.kind, cell.meta) == (ref.kind, ref.meta)
    ours, theirs = cell.args[1], ref.args[1]
    for name, a, b in zip(GraphInputs._fields, ours, theirs):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    # the port's init draws other numbers but the same tree of shapes
    want = flat_jax(ref.args[0].params)
    got = flat_port(cell.args[0].params)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_sizes_match_reference(shape):
    from repro.launch.cells import gnn_cell_sizes as r_sizes
    dims = get_arch("schnet").shape(shape).dims
    for d, padded in ((dims, True), (dims, False),
                      (tcells.GNN_SMOKE_DIMS[shape], False)):
        assert tcells.gnn_cell_sizes(shape, d, padded) == \
            r_sizes(shape, d, padded)
    if shape == "minibatch_lg":
        assert tcells.gnn_cell_sizes(shape, dims, True) == (169_984, 168_960)


def test_mesh_sizes_match_reference():
    from repro.models.gnn.graphcast import mesh_sizes as r_mesh
    for r in range(7):
        assert mesh_sizes(r) == r_mesh(r)
    assert mesh_sizes(6) == {"mesh_nodes": 40_962, "mesh_arcs": 245_760}


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "molecule"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_loss_and_every_gradient_leaf_match_reference(kind, shape):
    ref = _ref_cell(kind, shape)
    rmodel, model = _models(kind)
    rparams, rin = ref.args[0].params, ref.args[1]
    params = gnn_params_from_jax(rparams, "cpu")
    tin = _port_inputs(rin)
    want_pred = np.asarray(rmodel.forward(rparams, rin))
    with torch.no_grad():
        got_pred = model.forward(params, tin).numpy()
    assert got_pred.shape == want_pred.shape
    _close(got_pred, want_pred, 1e-5, 1e-6)

    want, rgrads = jax.value_and_grad(rmodel.loss)(rparams, rin)
    for p in tree_leaves(params):
        p.requires_grad_()
    loss = model.loss(params, tin)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    grads = flat_port(_grads(params))
    rflat = flat_jax(rgrads)
    assert sorted(grads) == sorted(rflat)
    for key in rflat:
        _close(grads[key], rflat[key], 1e-4, 1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_match_reference(kind):
    """Three steps of ``make_train_step`` on the full_graph_sm cell."""
    from repro.train.state import make_train_step as rmake
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    ref = _ref_cell(kind, "full_graph_sm")
    rmodel, model = _models(kind)
    rstate, rin = ref.args
    rstep = jax.jit(rmake(rmodel.loss, tcfg))
    tstep = make_train_step(model.loss, tcfg)
    tstate = new_train_state(gnn_params_from_jax(rstate.params, "cpu"))
    tin = _port_inputs(rin)
    for _ in range(3):
        rstate, rm = rstep(rstate, rin)
        tstate, tm = tstep(tstate, tin)
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_message_passing_matches_reference(kind):
    """``dtype="bfloat16"`` (the FULL configs' compute dtype) on the SMOKE
    widths: bf16 activations from f32 parameters, in both packages."""
    ref = _ref_cell(kind, "full_graph_sm", dtype="bfloat16")
    rmodel, model = _models(kind, dtype="bfloat16")
    rparams, rin = ref.args[0].params, ref.args[1]
    params = gnn_params_from_jax(rparams, "cpu")
    want = np.asarray(rmodel.forward(rparams, rin).astype(jnp.float32))
    with torch.no_grad():
        got = model.forward(params, _port_inputs(rin))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 2e-2, 2e-2)
    want_loss = float(rmodel.loss(rparams, rin))
    with torch.no_grad():
        got_loss = model.loss(params, _port_inputs(rin))
    assert got_loss.dtype == torch.float32
    assert float(got_loss) == pytest.approx(want_loss, rel=2e-2)


def _out_of_range(kind, rin, n_nodes):
    """Ids out of range in every index array the model reads (at the
    indexed array's length, past it, -1 and below its negative length):
    gathers clamp them or count them from the end, scatters drop them."""
    n = n_nodes
    if kind == "graphcast":
        n = mesh_sizes(get_arch(kind, smoke=True).model.mesh_refinement)[
            "mesh_nodes"]
    size = {"senders": n, "receivers": n,
            "trip_kj": n if kind == "graphcast" else rin.senders.shape[0],
            "trip_ji": n if kind == "graphcast" else rin.senders.shape[0]}
    fields = {}
    for key, hi in size.items():
        if getattr(rin, key) is None:
            continue
        a = np.array(getattr(rin, key))
        a[::7] = hi
        a[3::11] = hi + 5
        a[5::13] = -1
        a[6::17] = -3 * hi
        fields[key] = jnp.asarray(a)
    return rin._replace(**fields)


@pytest.mark.parametrize("kind", KINDS)
def test_out_of_range_ids_follow_jax_semantics(kind):
    ref = _ref_cell(kind, "full_graph_sm")
    rmodel, model = _models(kind)
    rparams = ref.args[0].params
    rin = _out_of_range(kind, ref.args[1], ref.meta["n_nodes"])
    want = np.asarray(rmodel.forward(rparams, rin))
    with torch.no_grad():
        got = model.forward(gnn_params_from_jax(rparams, "cpu"),
                            _port_inputs(rin)).numpy()
    assert np.isfinite(want).all()
    _close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_train_cli_trains_the_reduced_cell(kind, capsys):
    ttrain.main(["--arch", kind, "--device", "cpu", "--steps", "2",
                 "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"[train] {kind}/full_graph_sm (reduced config) — 2 steps on " \
           f"cpu" in out
    cell = tcells.gnn_cell(get_arch(kind, smoke=True), "full_graph_sm", CPU,
                           smoke=True)
    state, inputs = cell.args
    state, m = cell.step_fn(state, inputs)
    assert f"step    0 loss {float(m['loss']):.4f}" in out


def test_configs_match_reference():
    import importlib
    for kind in KINDS:
        ours = importlib.import_module(f"repro_torch.configs.{kind}")
        theirs = importlib.import_module(f"repro.configs.{kind}")
        for a, b in ((ours.FULL, theirs.FULL), (ours.SMOKE, theirs.SMOKE)):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert ours.full().source == theirs.full().source


@pytest.mark.parametrize("kind,model_kw", [
    ("graphcast", {"mesh_refinement": 2}), ("meshgraphnet", {})])
def test_full_width_and_depth_match_reference(kind, model_kw):
    """The FULL config (16 / 15 layers of d 512 / 128) in f32 on the SMOKE
    full_graph_sm cell (GraphCast's mesh cut to refinement 2): neither
    processor normalises, so on these random graphs the activations grow
    layer by layer to ~1e7–1e9 in the reference too; the port's
    predictions stay within rtol 1e-5 plus 1e-5 of the largest."""
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell
    from repro.models.gnn.common import make_model as rmake
    torch.set_num_threads(4)
    try:
        arch = rget(kind).replace_model(dtype="float32", **model_kw)
        ref = build_cell(arch, "full_graph_sm", concrete=True, smoke=True)
        rparams, rin = ref.args[0].params, ref.args[1]
        want = np.asarray(rmake(arch.model).forward(rparams, rin))
        with torch.no_grad():
            got = make_model(arch.model).forward(
                gnn_params_from_jax(rparams, "cpu"),
                _port_inputs(rin)).numpy()
    finally:
        torch.set_num_threads(1)
    assert np.abs(want).max() > 1e6
    _close(got, want, 1e-5, 1e-5)
