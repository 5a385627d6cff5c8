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
weights. BST's sharded ``train_batch`` step on 2 × 2 must be
``make_train_step(..., microbatches=2)`` bit for bit, leaf for leaf, with
no ``all_gather`` byte of the item table. The row-sharded lookup
(``ShardView.take_rows`` / ``take_along_fields``) must give the plain
lookups' values and gradients bit for bit at block boundaries, negative
ids, ids out of range (NaN rows), a −0.0 row and ids repeated across batch
shards. The cells' spec trees must equal the reference cells' leaf for
leaf. The files call ``torch.set_num_threads(1)``: the CPU's accumulating
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
    assert got == want
    for tree, stree in ((state.params, sstate.params),
                        (state.opt.m, sstate.opt.m),
                        (state.opt.v, sstate.opt.v)):
        assert all(torch.equal(gather(x), y) for x, y in
                   zip(tree_leaves(stree), tree_leaves(tree)))
    # the only leaf gathered whole is mlp_w0 (split by column): half of it
    # to each of the 2 homes a step, none of the item table
    w0 = params["mlp_w0"]
    assert mesh.bytes["all_gather"] == \
        STEPS * 2 * w0.numel() * w0.element_size() // 2
    assert mesh.bytes["emb_rows"] > 0 and mesh.bytes["emb_grad"] > 0


def test_bst_sharded_step_at_one_microbatch():
    """The reference cell's one microbatch on 2 × 2, its rows over the two
    batch shards: one forward over both homes, the loss the batch's mean
    (each home's sum and count of terms added over the homes,
    ``loss_sum``), one backward. Against ``make_train_step`` at M = 1: the
    loss a mean of two half-batch sums rather than one, so f32 rounding
    alone: loss and grad norm within 1e-6 relative, every leaf after 3
    steps within rtol 1e-5, atol 2 · lr · steps; the same lookups' bytes
    as the two-microbatch step and ``mlp_w0`` gathered once a home."""
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
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=1e-6)
        assert n1 == pytest.approx(n0, rel=1e-6)
    flips = 2 * TCFG.learning_rate * STEPS
    for x, y in zip(tree_leaves(sstate.params), tree_leaves(state.params)):
        np.testing.assert_allclose(gather(x).numpy(), y.numpy(), rtol=1e-5,
                                   atol=flips)
    w0 = params["mlp_w0"]
    assert mesh.bytes["all_gather"] == \
        STEPS * 2 * w0.numel() * w0.element_size() // 2
    assert mesh.bytes["loss_sum"] == STEPS * 2 * 8
    assert mesh.bytes["emb_rows"] > 0 and mesh.bytes["emb_grad"] > 0


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
    assert mesh.bytes["emb_ids"] and mesh.bytes["emb_rows"] \
        and mesh.bytes["emb_grad"]


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
