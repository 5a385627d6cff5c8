"""The GNNs trained with their edge arrays split over the batch axes, and
BST with its item table split by rows (ROADMAP 13.5 part 2, items 3 and 4),
on the CPU.

Meshes are ``["cpu"] * 2`` or ``* 4`` (a device list may repeat a device).
Each GNN's edge-sharded step (``train.state.make_edge_sharded_train_step``)
on a (1, 2) mesh — one edge block — must be ``make_train_step`` bit for bit;
on 2 × 2 — two edge blocks, whose partial sums fold in block order — its
loss and grad norm within 1e-5 relative of one device's and every leaf
within 2 · lr · steps (AdamW moves a leaf by at most about lr a step, so
where a gradient entry near 0 flips sign the leaves part by up to that),
and within 1e-4 relative of the reference's jitted step from the same
weights. BST's sharded ``train_batch`` step on 2 × 2 must be within f32
rounding of ``make_train_step(..., microbatches=2)`` (``mlp_w0``'s column
blocks stay where they lie, so its products are added over them), with no
``all_gather`` byte at all; with one column block that product is the
plain one bit for bit. The row-sharded lookup
(``ShardView.take_rows`` / ``take_along_fields``) must give the plain
lookups' values and gradients bit for bit at block boundaries, negative
ids, ids out of range (NaN rows), a −0.0 row and ids repeated across batch
shards, and move what the reference's jitted BST step moves for its item
and user tables (its compiled HLO read in a child with four host devices).
The cells' spec trees must equal the reference cells' leaf for leaf. The
files call ``torch.set_num_threads(1)``: the CPU's accumulating
``index_put_`` (the plain lookups' backward) splits rows over threads,
where ``segment_sum`` is a serial ``index_add``.

The tests marked ``cuda`` are the bitwise checks on the card (run them with
``python -m pytest --noconftest -m cuda tests/test_torch_sharded_gnn_bst.py``;
they import no JAX).
"""

import numpy as np
import pytest
import torch

from repro_torch.config.base import TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.distrib.collectives import ShardView
from repro_torch.distrib.sharding import (P, bst_param_specs, device_put,
                                          gather, state_specs_like)
from repro_torch.launch.cells import build_cell, bst_cell, gnn_cell
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models.gnn.common import gnn_params_from_jax
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sparse.segment import take_along_fields, take_rows
from repro_torch.train.state import (make_edge_sharded_train_step,
                                     make_sharded_train_step,
                                     make_train_step, new_sharded_train_state)

torch.set_num_threads(1)

KINDS = ("schnet", "dimenet", "meshgraphnet", "graphcast")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
BST_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
STEPS = 3


def _mesh(shape, device="cpu") -> Mesh:
    return Mesh(shape, ("data", "model"), [device] * (shape[0] * shape[1]))


def _gnn_on(kind, shape, params, device="cpu", cell_shape="full_graph_sm"):
    """(step, state, inputs) of the SMOKE ``cell_shape`` cell on a mesh of
    ``shape``, the state placed from ``params``, the step at ``TCFG``."""
    mesh = _mesh(shape, device)
    cell = gnn_cell(get_arch(kind, smoke=True), cell_shape, device,
                    smoke=True, mesh=mesh)
    specs, ispecs = cell.in_shardings
    step = make_edge_sharded_train_step(cell.model.loss, TCFG, mesh, specs,
                                        ispecs)
    return step, new_sharded_train_state(params, mesh, specs), cell.args[1]


def _one_device(kind, device="cpu", cell_shape="full_graph_sm"):
    cell = gnn_cell(get_arch(kind, smoke=True), cell_shape, device,
                    smoke=True)
    state, inputs = cell.args
    return make_train_step(cell.model.loss, TCFG), state, inputs


def _run(step, state, inputs, n=STEPS):
    out = []
    for _ in range(n):
        state, m = step(state, inputs)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def _leaves(state):
    return [gather(x) if not isinstance(x, torch.Tensor) else x
            for x in tree_leaves(state.params)]


def _copy(params):
    return {k: _copy(v) if isinstance(v, dict) else v.clone()
            for k, v in params.items()}


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("kind", KINDS)
def test_edge_sharded_step_matches_one_device(kind, mesh_shape):
    step1, state1, inputs1 = _one_device(kind)
    step2, state2, inputs2 = _gnn_on(kind, mesh_shape,
                                     _copy(state1.params))
    state1, want = _run(step1, state1, inputs1)
    state2, got = _run(step2, state2, inputs2)
    a, b = _leaves(state2), _leaves(state1)
    if mesh_shape == (1, 2):
        assert got == want
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        return
    for (lg, gg), (lw, gw) in zip(got, want):
        assert lg == pytest.approx(lw, rel=1e-5)
        assert gg == pytest.approx(gw, rel=1e-5)
    bound = 2 * TCFG.learning_rate * STEPS
    assert max(float((x - y).abs().max()) for x, y in zip(a, b)) <= bound


@pytest.mark.parametrize("kind", KINDS)
def test_edge_sharded_step_matches_reference(kind):
    """Three steps on 2 × 2 against the reference's jitted
    ``make_train_step`` from the same weights and inputs."""
    jax = pytest.importorskip("jax")
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell as rbuild
    from repro.models.gnn.common import make_model as rmake_model
    from repro.train.state import make_train_step as rmake
    ref = rbuild(rget(kind, smoke=True), "full_graph_sm", concrete=True,
                 smoke=True)
    rstate, rin = ref.args
    rstep = jax.jit(rmake(rmake_model(rget(kind, smoke=True).model).loss,
                          TCFG))
    step, state, inputs = _gnn_on(
        kind, (2, 2), gnn_params_from_jax(rstate.params, "cpu"))
    for _ in range(STEPS):
        rstate, rm = rstep(rstate, rin)
        state, m = step(state, inputs)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)


@pytest.mark.parametrize("kind", ["dimenet", "meshgraphnet"])
def test_edge_sharded_step_counts_its_collectives(kind):
    """DimeNet reads its edge tables whole and scatters into them; the
    others send node tables and fold partial sums: each name counts the
    bytes its formula gives for the cell's shapes."""
    step, state, inputs = _gnn_on(kind, (2, 2), _one_device(kind)[1].params)
    mesh = inputs.senders.mesh
    mesh.reset_bytes()
    step(state, inputs)
    cfg = get_arch(kind, smoke=True).model
    n, e, d = inputs.n_nodes, inputs.n_edges, cfg.d_hidden
    got = dict(mesh.bytes)
    if kind == "dimenet":
        # forward and backward: the output fold (N·d), and per layer mt
        # read whole and the triplet scatter (each home receives the other
        # half of an E·d table, both ways)
        assert got["edge_psum"] == 2 * n * d * 4
        layer = cfg.n_layers * 2 * e * d * 4
        assert got["edge_scatter"] == layer
        # s, r (int32) and the distances are gathered too, forward only
        assert got["edge_gather"] == layer + 3 * e * 4
        assert "node_send" not in got
    else:
        # per layer x goes to the other home and its fold comes back, in
        # the forward and in the backward
        assert got["node_send"] == got["edge_psum"] == \
            cfg.n_layers * 2 * n * d * 4


def test_bst_sharded_step_is_two_microbatches_bitwise():
    arch = get_arch("bst", smoke=True)
    one = bst_cell(arch, "train_batch", "cpu", smoke=True)
    model = one.model
    state, inputs = one.args
    params = _copy(state.params)
    state, want = _run(make_train_step(model.loss, TCFG, microbatches=2),
                       state, inputs)
    mesh = _mesh((2, 2))
    specs = state_specs_like(bst_param_specs(params, arch.model))
    assert specs.params["item_emb"] == P("model", None)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=2)
    sstate, got = _run(step, new_sharded_train_state(params, mesh, specs),
                       inputs)
    _assert_close_steps(want, got, sstate, state)
    # no leaf is gathered whole: the item table is looked up where its rows
    # lie, mlp_w0's column blocks stay where they lie
    assert "all_gather" not in mesh.bytes
    _assert_lookup_bytes(mesh, arch.model, inputs)


def _assert_close_steps(want, got, sstate, state):
    """Losses and grad norms within 1e-6 relative, every leaf after the
    steps within rtol 1e-5, atol 2 · lr · steps (f32 rounding alone: the
    sums over ``mlp_w0``'s column blocks, the halves of a batch)."""
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=1e-6)
        assert n1 == pytest.approx(n0, rel=1e-6)
    flips = 2 * TCFG.learning_rate * STEPS
    for x, y in zip(tree_leaves(sstate.params), tree_leaves(state.params)):
        np.testing.assert_allclose(gather(x).numpy(), y.numpy(), rtol=1e-5,
                                   atol=flips)


def _assert_lookup_bytes(mesh, cfg, inputs):
    """The step's lookups and ``mlp_w0``: each batch shard's home looks its
    half of the users up where the tables' rows lie and multiplies its
    rows by ``mlp_w0``'s blocks where they lie, ``STEPS`` times:
    ``chip_smoke.bst_lookup_want``'s and ``bst_mlp_want``'s bytes
    exactly."""
    import chip_smoke
    b = inputs.labels.shape[0] // 2
    want = dict(chip_smoke.bst_lookup_want(cfg, (2, 2), [(0, b), (1, b)]))
    want.update(chip_smoke.bst_mlp_want(cfg, (2, 2), [(0, b), (1, b)]))
    assert {k: v for k, v in mesh.bytes.items()
            if k.startswith(("emb_", "mlp_"))} \
        == {k: STEPS * v for k, v in want.items()}


def test_bst_sharded_step_at_one_microbatch():
    """The reference cell's one microbatch on 2 × 2, its rows over the two
    batch shards: one forward over both homes, the loss the batch's mean
    (each home's sum and count of terms added over the homes,
    ``loss_sum``), one backward. Against ``make_train_step`` at M = 1: the
    loss a mean of two half-batch sums rather than one, so f32 rounding
    alone: loss and grad norm within 1e-6 relative, every leaf after 3
    steps within rtol 1e-5, atol 2 · lr · steps; the same lookups' and
    ``mlp_w0``'s bytes as the two-microbatch step, nothing gathered."""
    arch = get_arch("bst", smoke=True)
    one = bst_cell(arch, "train_batch", "cpu", smoke=True)
    model = one.model
    state, inputs = one.args
    params = _copy(state.params)
    state, want = _run(make_train_step(model.loss, TCFG), state, inputs)
    mesh = _mesh((2, 2))
    specs = state_specs_like(bst_param_specs(params, arch.model))
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=1)
    sstate, got = _run(step, new_sharded_train_state(params, mesh, specs),
                       inputs)
    _assert_close_steps(want, got, sstate, state)
    assert "all_gather" not in mesh.bytes
    assert mesh.bytes["loss_sum"] == STEPS * 2 * 8
    _assert_lookup_bytes(mesh, arch.model, inputs)


# (mesh, microbatches) of the reference's BST train step read: where the
# port's layout is the reference's, and where it keeps whole microbatches on
# each of D > 1 batch shards
BST_LOOKUP_SAME = [((2, 2), 1), ((1, 4), 1), ((1, 4), 2)]
BST_LOOKUP_PORT = [((2, 2), 2)]
BST_LOOKUP = BST_LOOKUP_SAME + BST_LOOKUP_PORT

_BST_CHILD = r'''
import json, sys
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.config.base import TrainConfig
from repro.config.registry import get_arch
from repro.distrib.sharding import bst_param_specs, state_specs_like
from repro.models.recsys.bst import BST, BSTInputs
from repro.train.state import make_train_step, new_train_state

args = json.loads(open(sys.argv[1]).read())
cfg = get_arch("bst", smoke=True).model
model = BST(cfg)
state = new_train_state(model.init(jax.random.PRNGKey(0)))
B = args["batch"]
z = lambda *s: jnp.zeros(s, jnp.int32)
inputs = BSTInputs(z(B, cfg.seq_len), z(B, cfg.seq_len), z(B), z(B),
                   z(B, cfg.n_user_feats), jnp.zeros((B,), jnp.float32))
for i, case in enumerate(args["cases"]):
    D, MODEL = case["mesh"]
    mesh = Mesh(np.array(jax.devices()[:D * MODEL]).reshape(D, MODEL),
                ("data", "model"))
    ns = lambda s: NamedSharding(mesh, s)
    b1, b2 = P("data"), P("data", None)
    specs = state_specs_like(bst_param_specs(state.params, cfg))
    step = jax.jit(make_train_step(model.loss, TrainConfig(**args["tcfg"]),
                                   microbatches=case["micro"]),
                   in_shardings=(jax.tree.map(ns, specs), jax.tree.map(
                       ns, BSTInputs(b2, b2, b1, b1, b2, b1),
                       is_leaf=lambda x: isinstance(x, P))))
    with mesh:
        hlo = step.lower(state, inputs).compile().as_text()
    item, shapes = lookup_collectives(hlo, "models/recsys/bst.py",
                                      'jnp.take(params["item_emb"]', True)
    user = lookup_collectives(hlo, "models/recsys/bst.py",
                              "jnp.take_along_axis(")
    # the MLP's products: mlp_w0's column blocks, mlp_w1's rows after them
    mlp = {side: lookup_collectives(hlo, "models/recsys/bst.py",
                                    'x = x @ params[f"mlp_w{i}"]',
                                    ops=("/dot_general",), side=side)
           for side in ("fwd", "bwd")}
    # every collective of the module with an element of the user tables'
    # block gradient's shape (F, V / MODEL, e), by kind and axis
    block = "%d,%d,%d" % (cfg.n_user_feats, cfg.user_feat_vocab // MODEL,
                          cfg.embed_dim)
    grads = sorted({f"{m.group(3)} {axis(l)}" for l in hlo.splitlines()
                    for m in [_COLLECTIVE_RE.search(l)]
                    if m and "[" + block + "]" in (m.group(1) or "")
                    + (m.group(2) or "")})
    print(f"CASE {i} " + json.dumps({"item": item, "shapes": shapes,
                                     "user": user, "user_grad": grads,
                                     "mlp": mlp}), flush=True)
'''


@pytest.fixture(scope="module")
def bst_lookup_reference(tmp_path_factory):
    """(mesh, microbatches) → the reference's BST train step's lookups
    (``make_train_step(model.loss, TCFG, microbatches=M)`` under
    ``bst_param_specs`` and the batch over "data", the SMOKE cell's 8
    users) read from its compiled HLO: the item table's ``jnp.take`` line
    by kind and axis a chip, a tuple collective's elements each counted,
    with their shapes; the user tables' ``take_along_axis`` line; the
    collectives that carry a user table block's gradient. One child
    process, four host devices."""
    import json
    import os
    import subprocess
    import sys
    import textwrap
    from test_torch_tp_train import HLO_AXES
    pytest.importorskip("jax")
    payload = tmp_path_factory.mktemp("bst_lookup") / "cases.json"
    payload.write_text(json.dumps({
        "batch": 8, "cases": [{"mesh": s, "micro": m} for s, m in BST_LOOKUP],
        "tcfg": {k: getattr(TCFG, k) for k in ("learning_rate",
                                                "warmup_steps",
                                                "total_steps")}}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(repo, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(HLO_AXES + _BST_CHILD),
                          str(payload)], env=env, capture_output=True,
                         text=True, cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    outs = {}
    for line in res.stdout.splitlines():
        if line.startswith("CASE "):
            i, body = line[5:].split(" ", 1)
            outs[BST_LOOKUP[int(i)]] = json.loads(body)
    assert len(outs) == len(BST_LOOKUP), res.stdout[-2000:]
    return outs


def _bst_lookup_bytes(shape, micro):
    """The port's BST train step on ``shape`` at ``micro`` microbatches
    (the SMOKE cell's 8 users over "data"): its lookup bytes by kind and
    axis a chip (``test_torch_tp_train.lookup_by_kind``) and its own moves
    by name, every ``emb_*`` byte checked against
    ``chip_smoke.bst_lookup_want``'s; and the rows a microbatch of a chip
    in the reference's layout."""
    import chip_smoke
    from test_torch_tp_train import lookup_by_kind
    arch = get_arch("bst", smoke=True)
    cfg = arch.model
    one = bst_cell(arch, "train_batch", "cpu", smoke=True)
    state, inputs = one.args
    mesh = _mesh(shape)
    specs = state_specs_like(bst_param_specs(state.params, cfg))
    step = make_sharded_train_step(one.model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=micro)
    step(new_sharded_train_state(_copy(state.params), mesh, specs), inputs)
    got, own = lookup_by_kind(mesh, mesh.moves)
    D, B = shape[0], inputs.labels.shape[0]
    per = micro // D if micro % D == 0 else 1
    homes = [(d, B // D // per) for d in range(D) for _ in range(per)]
    assert {k: v for k, v in mesh.bytes.items() if k.startswith("emb_")} \
        == chip_smoke.bst_lookup_want(cfg, shape, homes)
    b = B // max(D, micro) if micro == 1 or D == 1 else B // micro
    return cfg, got, own, b


def _bst_read_shapes(read, cfg, b):
    """The reference's lookup: both tables' partial rows all-reduced over
    "model" in one tuple collective at the item table's ``jnp.take``
    (elements (b, S + 1, e) and (b, F, 1, e)), nothing at the user
    tables' ``take_along_axis``."""
    e, F, S1 = cfg.embed_dim, cfg.n_user_feats, cfg.seq_len + 1
    assert read["shapes"] == {"all-reduce model": [f"{b},{S1},{e}",
                                                   f"{b},{F},1,{e}"]}
    assert not read["user"]


@pytest.mark.parametrize("shape,micro", BST_LOOKUP_SAME,
                         ids=[f"{d}x{k}-M{m}"
                              for (d, k), m in BST_LOOKUP_SAME])
def test_bst_lookup_moves_as_the_reference(bst_lookup_reference, shape,
                                           micro):
    """BST's train step (the SMOKE cell's 8 users over "data", the item
    table P("model", None), the user tables P(None, "model", None))
    against the reference's jitted step where the layouts agree (2 × 2 at
    1 microbatch, 1 × 4 at 1 and 2): the reference all-reduces the partial
    rows of both tables over "model" in one tuple collective at the item
    table's ``jnp.take`` (elements (b, S + 1, e) and (b, F, 1, e)),
    attributes nothing to the user tables' ``take_along_axis``, and sums
    a user table block's gradient over "data" only, where the batch
    shards hold different rows (the step's gradient sum over the batch
    shards, ``grad_psum`` in the port). The port's lookup bytes by kind
    and axis a chip equal the tuple's elements summed, to the byte;
    apart, its own moves of each batch shard's ids and gradient rows from
    its home to its group (``emb_ids_home``, ``emb_grad_home``). Every
    ``emb_*`` byte equals ``chip_smoke.bst_lookup_want``'s."""
    read = bst_lookup_reference[(shape, micro)]
    cfg, got, own, b = _bst_lookup_bytes(shape, micro)
    print(f"\nBST lookup ({shape}, {micro} microbatch(es)): reference HLO "
          f"{read}; the port {got}, its own moves {own}")
    _bst_read_shapes(read, cfg, b)
    assert read["user_grad"] == (["all-reduce data"] if shape[0] > 1
                                 else [])
    assert got == read["item"]
    assert set(own) == {"emb_ids_home", "emb_grad_home"}


@pytest.mark.parametrize("shape,micro", BST_LOOKUP_PORT,
                         ids=[f"{d}x{k}-M{m}"
                              for (d, k), m in BST_LOOKUP_PORT])
def test_bst_lookup_where_the_layout_differs(bst_lookup_reference, shape,
                                             micro):
    """BST's train step at 2 microbatches on 2 × 2, where the layouts
    differ: the reference gathers each microbatch's inputs along "data"
    and looks the whole microbatch up at every chip (its all-reduce of
    both tables' rows over "model", 3,328 B a chip, stated here), where
    the port keeps one microbatch a batch shard and looks it up at that
    shard's home (its bytes held to ``chip_smoke.bst_lookup_want``
    alone)."""
    read = bst_lookup_reference[(shape, micro)]
    cfg, got, own, b = _bst_lookup_bytes(shape, micro)
    print(f"\nBST lookup ({shape}, {micro} microbatch(es)): reference HLO "
          f"{read}; the port {got}, its own moves {own}")
    _bst_read_shapes(read, cfg, b)
    assert read["item"] == {"all-reduce model": 3328}
    assert not read["user_grad"]
    assert set(got) == {"all-reduce model"}
    assert set(own) == {"emb_ids_home", "emb_grad_home"}
MLP_FWD = {"mlp_sum": "all-reduce"}
MLP_BWD = {"mlp_grad_sum": "all-reduce"}
MLP_OWN = {"mlp_rows_home", "mlp_grad_home", "mlp_weights_home"}


def _bst_mlp_bytes(shape, micro):
    """The port's BST train step on ``shape`` at ``micro`` microbatches:
    ``mlp_w0``'s bytes by kind and axis a chip, forward and backward apart
    (``test_torch_tp_train.lookup_by_kind`` of ``MLP_FWD``, ``MLP_BWD``),
    its own moves by name; every ``mlp_*`` byte ``chip_smoke.
    bst_mlp_want``'s and no ``all_gather`` byte."""
    import chip_smoke
    from test_torch_tp_train import lookup_by_kind
    arch = get_arch("bst", smoke=True)
    cfg = arch.model
    one = bst_cell(arch, "train_batch", "cpu", smoke=True)
    state, inputs = one.args
    mesh = _mesh(shape)
    specs = state_specs_like(bst_param_specs(state.params, cfg))
    step = make_sharded_train_step(one.model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=micro)
    step(new_sharded_train_state(_copy(state.params), mesh, specs), inputs)
    fwd, own = lookup_by_kind(mesh, mesh.moves, MLP_FWD, MLP_OWN)
    bwd, _ = lookup_by_kind(mesh, mesh.moves, MLP_BWD, ())
    D, B = shape[0], inputs.labels.shape[0]
    per = micro // D if micro % D == 0 else 1
    homes = [(d, B // D // per) for d in range(D) for _ in range(per)]
    assert {k: v for k, v in mesh.bytes.items() if k.startswith("mlp_")} \
        == chip_smoke.bst_mlp_want(cfg, shape, homes)
    assert "all_gather" not in mesh.bytes
    return fwd, bwd, own


@pytest.mark.parametrize("shape,micro", BST_LOOKUP_SAME,
                         ids=[f"{d}x{k}-M{m}"
                              for (d, k), m in BST_LOOKUP_SAME])
def test_bst_mlp_moves_as_the_reference(bst_lookup_reference, shape, micro):
    """BST's ``mlp_w0`` (P(None, "model")) in the train step against the
    reference's jitted step where the layouts agree (2 × 2 at 1
    microbatch, 1 × 4 at 1 and 2): the reference keeps the column blocks
    where they lie and all-reduces over "model" the partial products of
    ``mlp_w1`` after them (b × mlp_dims[1] f32) and, in the backward, the
    dX partials of ``mlp_w0``'s input (b × F_in f32), both at the MLP's
    line; the port's bytes by kind and axis a chip, forward and backward
    apart, equal them to the byte; apart, its own moves (the rows to the
    group, the sum's gradient back, the slices of ``mlp_b0`` and
    ``mlp_w1`` from the home's copy: ``MLP_OWN``)."""
    read = bst_lookup_reference[(shape, micro)]["mlp"]
    fwd, bwd, own = _bst_mlp_bytes(shape, micro)
    print(f"\nBST mlp_w0 ({shape}, {micro} microbatch(es)): reference HLO "
          f"{read}; the port forward {fwd}, backward {bwd}, its own moves "
          f"{own}")
    assert fwd == read["fwd"] == {"all-reduce model": fwd["all-reduce model"]}
    assert bwd == read["bwd"] == {"all-reduce model": bwd["all-reduce model"]}
    assert set(own) == MLP_OWN


@pytest.mark.parametrize("shape,micro", BST_LOOKUP_PORT,
                         ids=[f"{d}x{k}-M{m}"
                              for (d, k), m in BST_LOOKUP_PORT])
def test_bst_mlp_where_the_layout_differs(bst_lookup_reference, shape,
                                          micro):
    """BST's ``mlp_w0`` at 2 microbatches on 2 × 2, where the layouts
    differ: the reference multiplies each microbatch's whole rows at every
    chip (its all-reduces over "model", 512 and 5,632 B a chip, stated
    here); the port keeps one microbatch a batch shard, whose rows it
    multiplies where the blocks lie (half of each, its bytes held to
    ``chip_smoke.bst_mlp_want``)."""
    read = bst_lookup_reference[(shape, micro)]["mlp"]
    assert read == {"fwd": {"all-reduce model": 512},
                    "bwd": {"all-reduce model": 5632}}
    fwd, bwd, own = _bst_mlp_bytes(shape, micro)
    assert fwd == {"all-reduce model": 256}
    assert bwd == {"all-reduce model": 2816}
    assert set(own) == MLP_OWN


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
def test_bst_mlp_one_block_is_the_plain_product(shape):
    """``collectives.column_row_product`` with ``mlp_w0`` in one column
    block (a mesh with one "model" position): ``act(x @ w0 + b0) @ w1``
    and its gradients bit for bit, nothing moved."""
    from repro_torch.distrib.collectives import column_row_product
    from repro_torch.models.recsys.bst import leaky_relu
    g = torch.Generator().manual_seed(5)
    x = torch.randn((6, 12), generator=g)
    w0, b0 = torch.randn((12, 8), generator=g), torch.randn((8,), generator=g)
    w1 = torch.randn((8, 4), generator=g)
    dy = torch.randn((6, 4), generator=g)
    act = lambda h: leaky_relu(h, 0.01)  # noqa: E731
    leaves = [t.clone().requires_grad_(True) for t in (x, w0, b0, w1)]
    want = act(leaves[0] @ leaves[1] + leaves[2]) @ leaves[3]
    want.backward(dy)
    mesh = _mesh(shape)
    views = [ShardView(device_put(t, mesh, spec), 0, [0])
             for t, spec in ((w0, P(None, "model")), (b0, P(None)),
                             (w1, P(None, None)))]
    xs = x.clone().requires_grad_(True)
    got = column_row_product(xs, *views, act)
    got.backward(dy)
    assert torch.equal(got, want)
    assert torch.equal(xs.grad, leaves[0].grad)
    for view, leaf in zip(views, leaves[1:]):
        (_, _, grad), = view.grads()
        assert torch.equal(grad, leaf.grad)
    assert not mesh.bytes


def _lookup_case(case):
    """(table, ids for two batch shards, split dim) of one edge case."""
    g = torch.Generator().manual_seed(3)
    if case == "fields":
        table = torch.randn((3, 16, 5), generator=g)
        ids = torch.tensor([[0, 3, 4], [15, -1, 8], [7, 12, -16]])
        return table, (ids, torch.tensor([[4, 4, 15], [0, 11, 3]])), 1
    table = torch.randn((16, 5), generator=g)
    table[4] = -0.0               # the first row of block 1
    table[11, 2] = -0.0
    ids = {"boundaries": torch.tensor([[0, 3, 4, 7], [8, 11, 12, 15]]),
           "negative": torch.tensor([[-1, -4, -5, -16], [-12, 2, -9, 9]]),
           "out_of_range": torch.tensor([[16, -17, 3, 40], [-100, 0, 15, 5]]),
           "negative_zero": torch.tensor([[4, 11, 4, 0], [11, 4, 4, 4]]),
           "repeated": torch.tensor([[5, 5, 12, 5], [12, 5, 5, 0]])}[case]
    other = ids.flip(0) if case != "repeated" else ids.clone()
    return table, (ids, other), 0


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", ["boundaries", "negative", "out_of_range",
                                  "negative_zero", "repeated", "fields"])
def test_row_sharded_lookup_is_the_plain_lookup_bitwise(case, device="cpu"):
    """Two batch shards of a 2 × 4 mesh look rows up in a table split 4
    ways along its rows (``fields``: along the vocab axis of (F, V, e)
    tables) and backpropagate seeded gradients; the values and the summed
    gradient equal the plain lookups' with the table's ``.grad``
    accumulating over the two, bit for bit (NaN rows included)."""
    table, ids, dim = _lookup_case(case)
    table, ids = table.to(device), [i.to(device) for i in ids]
    plain = take_rows if dim == 0 else take_along_fields
    g = torch.Generator().manual_seed(4)
    grads = [torch.randn(tuple(i.shape) + (table.shape[-1],), generator=g)
             .to(device) for i in ids]
    leaf = table.clone().requires_grad_(True)
    want = []
    for i, gr in zip(ids, grads):
        out = plain(leaf, i)
        out.backward(gr)
        want.append(out.detach())
    mesh = _mesh((2, 4), device)
    spec = P("model", None) if dim == 0 else P(None, "model", None)
    x = device_put(table, mesh, spec)
    total = {}
    for d, i, gr in zip(range(2), ids, grads):
        group = [p for p in range(8) if mesh.coords(p)["data"] == d]
        view = ShardView(x, group[0], group)
        lookup = view.take_rows if dim == 0 else view.take_along_fields
        with mesh.at(group[0]):
            out = lookup(i)
        assert torch.equal(_bits(out), _bits(want[d]))
        out.backward(gr)
        for block, src, gb in view.grads():
            total[block] = gb if block not in total else total[block] + gb
    whole = torch.cat([total[b] for b in sorted(total)], dim=dim)
    assert torch.equal(_bits(whole), _bits(leaf.grad))
    import chip_smoke
    assert dict(mesh.bytes) == chip_smoke.row_lookup_want(
        (2, 4), ("model",), [[(d, i.numel())] for d, i in enumerate(ids)],
        table.shape[-1], 4, ids[0].element_size(), True)


def _specs_in_ref_order(tree):
    """A spec tree's PartitionSpecs flattened as ``jax.tree.leaves``
    flattens the reference's: dict keys sorted, ``None`` fields left out."""
    if tree is None:
        return []
    if isinstance(tree, P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs_in_ref_order(tree[k])]
    return [s for v in tree for s in _specs_in_ref_order(v)]


CELLS = [(k, s) for k in KINDS for s in GNN_SHAPES] + \
    [("bst", s) for s in BST_SHAPES]


@pytest.mark.parametrize("arch_id,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cells_in_shardings_equal_the_reference_cells(arch_id, shape):
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh as JMesh
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell as rbuild
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    ref = rbuild(rget(arch_id, smoke=True), shape, mesh=jmesh, smoke=True)
    cell = build_cell(get_arch(arch_id, smoke=True), shape, "cpu",
                      smoke=True, mesh=make_host_mesh("cpu"), concrete=False)
    want = [tuple(s.spec) for s in jax.tree.leaves(ref.in_shardings)]
    assert _specs_in_ref_order(cell.in_shardings) == want


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_bst_serving_on_the_mesh_is_one_devices(shape):
    """The serve shapes on 2 × 2 (serve_bulk's batch splits over "data",
    retrieval's candidates always do; the user tables' rows are looked up
    where they lie) against one device: equal on the CPU."""
    arch = get_arch("bst", smoke=True)
    one = bst_cell(arch, shape, "cpu", smoke=True)
    mesh = _mesh((2, 2))
    cell = bst_cell(arch, shape, "cpu", smoke=True, mesh=mesh)
    with torch.no_grad():
        want = one.step_fn(*one.args)
        got = cell.step_fn(*cell.args)
    assert torch.equal(got, want)
    assert sum(mesh.bytes.values()) > 0


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_one_edge_block_is_the_one_card_step(kind, cuda_device):
    step1, state1, inputs1 = _one_device(kind, "cuda")
    step2, state2, inputs2 = _gnn_on(kind, (1, 2), _copy(state1.params),
                                     "cuda")
    state1, want = _run(step1, state1, inputs1)
    state2, got = _run(step2, state2, inputs2)
    assert got == want
    assert all(torch.equal(x, y) for x, y in
               zip(_leaves(state2), _leaves(state1)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_two_edge_blocks_repeat_bitwise(kind, cuda_device):
    runs = []
    for _ in range(2):
        params = _one_device(kind, "cuda")[1].params
        runs.append(_run(*_gnn_on(kind, (2, 2), params, "cuda"))[1])
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_bst_sharded_step_is_two_microbatches_bitwise(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("bst", smoke=True)
    one = bst_cell(arch, "train_batch", "cuda", smoke=True)
    state, inputs = one.args
    params = _copy(state.params)
    state, want = _run(make_train_step(one.model.loss, TCFG,
                                       microbatches=2), state, inputs)
    mesh = _mesh((2, 2), "cuda")
    specs = state_specs_like(bst_param_specs(params, arch.model))
    step = make_sharded_train_step(one.model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=2)
    sstate, got = _run(step, new_sharded_train_state(params, mesh, specs),
                       inputs)
    assert got == want
    assert all(torch.equal(gather(x), y) for x, y in
               zip(tree_leaves(sstate.params), tree_leaves(state.params)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["boundaries", "negative", "out_of_range",
                                  "negative_zero", "repeated", "fields"])
def test_cuda_row_sharded_lookup_is_the_plain_lookup_bitwise(case,
                                                             cuda_device):
    test_row_sharded_lookup_is_the_plain_lookup_bitwise(case, "cuda")
