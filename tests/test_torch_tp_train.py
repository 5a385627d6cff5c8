"""LM training on the device mesh under ``tp2d`` with the weights where they
lie (``distrib/collectives.py``: ``block_matmul``'s backward, the two-axis
lookup ``take_rows_two_axis``; ``models/layers.py``: the vocab-parallel
cross entropy;
``train/state.py``: ``make_tp2d_train_step``), on the CPU (meshes of
``["cpu"] * n``, f32 SMOKE configs).

* ``block_matmul``'s gradients of x, the weight and the bias against
  autograd of the unsharded ``x @ w + b``, on the meshes and specs of
  ``test_torch_tp_serve.test_block_matmul``: bitwise on one position
  (either layout of the weight), within ``GRAD_RTOL`` (1e-6 of the largest
  entry) otherwise, where the f32 partial sums and the homes' terms add in
  another order; the backward's bytes are the forward's with i and j
  swapped (``tp_grad_act`` = ``tp_partial``, ``tp_grad_partial`` =
  ``tp_act``).
* The two-axis lookup (``embed`` under P("model", "data")) in its three
  forms (pinned: the train step and a prefill; not pinned: a decode step;
  the batch whole): its rows bitwise one device's ``take_rows`` on 2 × 2
  and 2 × 1, in f32 and bf16, NaN rows and −0.0 entries included; its
  gradient bitwise the unsharded ``take_rows`` backward, ids out of range
  and repeated included, summed in one device's order (one pass over the
  microbatch in batch order, not per batch shard); the train step's
  lookup bytes by kind and axis a chip equal the reference's HLO
  collectives of the embedding's gather and its transpose, to the byte
  (``moe_shard`` "expert" and "ffn", 1 and 2 microbatches on 2 × 2; 1 on
  4 × 4 and 1 × 4), and on a meta mesh of 16 × 16, 2 × 4 and 4 × 2
  ``chip_smoke.lookup_want``'s; the batch-whole form's bytes worked out
  from the mesh's coordinates.
* The vocab-parallel loss and its gradients (hidden, head) against the
  one-device ``softmax_xent_sharded``, labels −1 included: a head split
  over V only and the tied head (``embed.T``, d and V split), on one
  position bitwise, otherwise within ``LOSS_RTOL`` (1e-6) and
  ``GRAD_RTOL``; ``xent_stats`` is per-row data only.
* The ``tp2d`` train step (Megatron over "model" × ZeRO over "data":
  ``collectives.TPView``, ``tp_linear``, ``split_heads``,
  ``tp_vocab_xent``, ``models/moe.py:_moe_over_model``) against
  ``make_train_step`` (the same model with ``act_spec``) for the SMOKE
  qwen3-moe (8 experts, whose spec degrades to replicated; 16, which split
  over "model"; and ``moe_shard="ffn"``, each expert's d_ff over "model")
  and smollm-135m (tied head): on one position bit for bit (loss, grad
  norm, every leaf), on (1, 2), (2, 1), (2, 2) and (1, 4) with the batch
  whole and split, loss and grad norm within 1e-5 relative and every leaf
  after 2 steps within rtol 1e-4, atol 2 · lr · steps
  (``test_torch_sharded_train``'s bound); none of ``block_matmul``'s
  bytes (``tp_act``, ``tp_partial``, ``tp_grad_act``,
  ``tp_grad_partial``); every collective's bytes a step equal to
  :func:`tp2d_step_bytes`, a formula from the config and the mesh; every
  weight byte moving between positions with one "model" coordinate and
  every activation sum between positions with one "data" coordinate; the
  three attention branches of ``split_heads`` against the unsplit
  attention, forward and backward; two runs bitwise; ``remat="full"`` and
  ``"dots"`` bitwise ``"none"`` on the mesh, with the dots recompute
  running no product again and both repeating the forward's gathers.
* In bf16 compute on 2 × 2 each leaf's AdamW first moment after 2 steps
  no farther from the unsharded bf16 step's than ``LEAF_FACTOR`` (2)
  times the unsharded f32 step's distance from it (``chip_smoke.py``'s
  leaf check at SMOKE widths).
* Microbatches as ``make_train_step``'s: M ∈ {1, 2, 4} on 2 × 2 and 2 × 1
  (each microbatch's rows split over "data", so M = 1 runs on a mesh with
  "data" > 1) within ``STEP_RTOL`` of the unsharded step, the weights
  gathered once a microbatch, and M = 1 on one position bit for bit; every
  collective's bytes equal to ``chip_smoke.tp2d_bytes_want`` on 2 × 2 with
  ``remat`` none, full and dots; a clip that bites (``grad_clip`` 0.05):
  the grad norm, one scalar all-reduce (``norm_sum``, no gradient moved),
  within 1e-5 of ``global_norm``'s on 2 × 2 and bit for bit on one
  position; a microbatch that does not split over the batch shards
  raises.
* Fault 8: a MoE group that spans the batch shards of a microbatch
  (``moe_group_size`` 64 over 2 shards of 32 tokens, 16 experts, both
  ``moe_shard`` values, every row row 0's and random rows) routed once over
  them (``models/moe.py:_moe_across_shards``, its backward through
  ``span_gather`` / ``span_select``): within ``STEP_RTOL`` of the
  unsharded step on 2 × 2 and 2 × 1, two runs bitwise, bytes by formula
  (``tp2d_step_bytes``, ``chip_smoke.tp2d_bytes_want`` with each remat),
  and within 1e-4 of the reference's jitted step.
* The step against the reference's ``jax.jit(make_train_step)`` under a
  2 × 2 JAX mesh with the ``tp2d`` ``in_shardings`` (one child process
  with four host devices for every reference case of the file), weights
  through ``params_from_jax``, to rtol 1e-4,
  for ``moe_shard`` "expert" and "ffn"; the child also reads the compiled
  HLO's collective bytes by kind and by the mesh axis of their replica
  groups (``repro.launch.roofline.collective_bytes``), printed beside the
  port's bytes by name and axis, its all-gathers along "data" by what
  they gather (weights, rows, ids) and its gradient all-reduces along
  "data" that a dynamic-slice reads: the port's ``tp_zero_gather`` a
  position equals the float all-gathers along "data" a chip, the weights'
  are each attention block's twice a microbatch.

JAX is imported only inside the tests that compare with it.
"""

import dataclasses
from fractions import Fraction
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config.base import TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.configs import qwen3_moe_30b_a3b as qcfg
from repro_torch.data.lm import TokenPipeline
from repro_torch.distrib.collectives import (Rows, ShardView,
                                             StationaryView, TPView,
                                             batch_groups, block_matmul,
                                             vocab_parallel_xent)
from repro_torch.distrib.sharding import (P, ShardedTensor, device_put,
                                          gather, lm_param_specs,
                                          state_specs_like)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sparse.segment import take_rows
from repro_torch.train.state import (make_train_step, make_tp2d_train_step,
                                     new_sharded_train_state,
                                     new_train_state)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 1e-6
LOSS_RTOL = 1e-6
STEP_RTOL = 1e-5
LEAF_FACTOR = 2.0
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
N_STEPS = 2
MOE16 = dataclasses.replace(
    qcfg.SMOKE, moe=dataclasses.replace(qcfg.SMOKE.moe, n_experts=16))
FFN = dataclasses.replace(
    qcfg.SMOKE, moe=dataclasses.replace(qcfg.SMOKE.moe, moe_shard="ffn"))
SMOL = get_arch("smollm-135m", smoke=True).model
MODELS = {"qwen3-moe": qcfg.SMOKE, "qwen3-moe-e16": MOE16,
          "qwen3-moe-ffn": FFN, "smollm-135m": SMOL}
GATHERS = {"all_gather", "all_gather_grad"}
# block_matmul's bytes, which the tp2d train step never moves
STATIONARY = {"tp_act", "tp_partial", "tp_grad_act", "tp_grad_partial"}
# the bytes of weights (gathered along "data") and of activation sums
WEIGHT_MOVES = {"tp_zero_gather", "tp_zero_scatter"}
SUM_MOVES = {"tp_model_sum"}


def _mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return Mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def _split(t, n):
    return [p.clone() for p in t.chunk(n)]


def _block_sum(view):
    """The whole gradient of a ``StationaryView``'s leaf: each block's
    holders' leaf gradients added."""
    lay = view.x.layout
    out = torch.zeros(view.x.shape)
    for block in lay.blocks():
        total = None
        for h in lay.holders(block):
            g = view.leaves[h].grad
            if g is not None:
                total = g if total is None else total + g
        if total is not None:
            out[lay.slices(block)] = total
    return out


def _close(got, want, rtol):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), (err, float(
        want.abs().max()))


# -- block_matmul's backward ---------------------------------------------------------

def _matmul_grads(shape, batch, spec, bias, seed):
    mesh = _mesh(shape)
    ba = ("pod", "data") if len(shape) == 3 else "data"
    homes, _ = batch_groups(mesh, ba if batch == "split" else None)
    rng = np.random.default_rng(seed)
    B, S, n_in, n_out = 8, 3, 32, 48
    x, w, dy = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((B, S, n_in), (n_in, n_out), (B, S, n_out)))
    b = torch.from_numpy(rng.standard_normal(n_out).astype(np.float32))
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = xr @ wr
    if bias:
        y = y + br
    (y * dy).sum().backward()
    view = StationaryView(device_put(w, mesh, spec), grad=True)
    bview = (StationaryView(device_put(b, mesh, P(spec[1])), grad=True)
             if bias else None)
    xs = [t.requires_grad_(True) for t in _split(x, len(homes))]
    out = block_matmul(Rows(xs, homes, mesh), view, torch.float32, bview)
    torch.autograd.backward(out.parts, _split(dy, len(homes)))
    got = [torch.cat([t.grad for t in xs]), _block_sum(view)]
    want = [xr.grad, wr.grad]
    if bias:
        got.append(_block_sum(bview))
        want.append(br.grad)
    return got, want, dict(mesh.bytes)


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("spec", [P("data", "model"), P("model", "data")],
                         ids=["wq", "wo"])
@pytest.mark.parametrize("batch", ["whole", "split"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1), (1, 4),
                                   (2, 2, 2)],
                         ids=["2x2", "1x2", "2x1", "1x4", "2x2x2"])
def test_block_matmul_gradients(shape, batch, spec, bias):
    got, want, nbytes = _matmul_grads(shape, batch, spec, bias,
                                      sum(shape) + len(batch))
    for g, w in zip(got, want):
        _close(g, w, GRAD_RTOL)
    again, _, _ = _matmul_grads(shape, batch, spec, bias,
                                sum(shape) + len(batch))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the backward moves the forward's bytes with i and j swapped (f32)
    assert nbytes.get("tp_grad_act", 0) == nbytes.get("tp_partial", 0)
    assert nbytes.get("tp_grad_partial", 0) == nbytes.get("tp_act", 0)
    assert not set(nbytes) & GATHERS


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "bias"])
@pytest.mark.parametrize("transposed", [False, True],
                         ids=["row-major", "column-major"])
def test_block_matmul_gradients_on_one_position_are_autograds(transposed,
                                                              bias):
    """One position, one home, one block: autograd's backward of ``x @ w +
    b`` bit for bit, the weight read as it lies or transposed (the tied
    head's layout, whose gradient autograd takes as (dyᵀ x)ᵀ)."""
    mesh = _mesh((1, 1))
    g = torch.Generator().manual_seed(5)
    x, dy = torch.randn((4, 5, 24), generator=g), torch.randn((4, 5, 40),
                                                              generator=g)
    w = torch.randn((40, 24) if transposed else (24, 40), generator=g)
    b = torch.randn((40,), generator=g)
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = xr @ (wr.T if transposed else wr)
    if bias:
        y = y + br
    (y * dy).sum().backward()
    view = StationaryView(device_put(w, mesh, P("data", "model")),
                          grad=True)
    bview = (StationaryView(device_put(b, mesh, P("model")), grad=True)
             if bias else None)
    xs = x.clone().requires_grad_(True)
    out = block_matmul(Rows([xs], [0], mesh), view.T if transposed else view,
                       torch.float32, bview)
    torch.autograd.backward(out.parts, [dy])
    assert torch.equal(xs.grad, xr.grad)
    assert torch.equal(view.leaves[0].grad, wr.grad)
    if bias:
        assert torch.equal(bview.leaves[0].grad, br.grad)
    assert not mesh.bytes


# -- the two-axis lookup's backward ---------------------------------------------------

IDS = torch.tensor([[0, 5, 23, -1, -24, 24, -25, 11],
                    [7, 12, 6, 18, 3, 5, 0, 100],
                    [-5, 1, 2, 22, 17, 9, 13, -100],
                    [4, 4, 19, 20, 21, 8, 10, 4]], dtype=torch.int32)


def _lookup(mesh, table, ids, form, grad=False):
    """The two-axis lookup of ``table`` (placed by P("model", "data")) at
    ``ids`` in one of its forms: "pinned" (the train step's
    ``TPView.take_rows``, the batch over "data"), "unpinned" (a decode
    step's ``TPView``) or "whole" (``StationaryView.take_rows``, the
    batch's ids at every position, the rows at the homes of the batch
    over "data"). (the view, each output's batch shard rows as Rows, each
    output's shard index)."""
    placed = device_put(table, mesh, P("model", "data"))
    homes, groups = batch_groups(mesh, "data")
    D = len(homes)
    if form == "whole":
        view = StationaryView(placed, grad=grad, ids=[ids] * mesh.size)
        rows = view.take_rows(Rows(list(ids.chunk(D)), homes, mesh))
        return view, rows, list(range(D))
    view = (TPView(placed, groups) if form == "pinned"
            else TPView.serving(placed, groups, "decode"))
    shard = [view.shard[p] for p in range(mesh.size)]
    rows = view.take_rows(Rows([ids.chunk(D)[d] for d in shard],
                               list(range(mesh.size)), mesh))
    return view, rows, shard


def _same_rows_as(got, want):
    "Bitwise, NaN rows and the sign of zeros included."
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def whole_lookup_bytes(mesh, lay, homes, n: int, c: int,
                       grad: bool = False) -> dict:
    """The bytes of the two-axis lookup with the batch whole
    (``StationaryView.take_rows``) of ``n`` ids, split evenly over the
    ``homes``, in a table of layout ``lay`` (P("model", "data")), the
    rows in a ``c``-byte dtype, worked out from the mesh's coordinates:
    on each "model" line of K vocab blocks the reduce-scatter and
    all-gather of every position's n · e/C partial entries, 2(K − 1)
    positions' worth in all (``emb_rows_model``); each home's rows of
    each column block it lacks, from its "data" line (``emb_rows_home``);
    with ``grad``, every position's column block of each home's gradient
    rows but its own (``emb_grad_home``)."""
    e = lay.block_shape[1]

    def line(p, axis):
        at = mesh.coords(p)
        return tuple(q for q in range(mesh.size)
                     if all(mesh.coords(q)[a] == at[a]
                            for a in mesh.axis_names if a != axis))
    lines = {line(p, "model") for p in range(mesh.size)}
    rows = n // len(homes) * e * c
    out = {"emb_rows_model": sum(
               2 * (len({lay.block_of(q)[0] for q in ln}) - 1)
               for ln in lines) * n * e * c,
           "emb_rows_home": sum(
               len({lay.block_of(q)[1] for q in line(h, "data")}) - 1
               for h in homes) * rows}
    if grad:
        out["emb_grad_home"] = sum(h != p for p in range(mesh.size)
                                   for h in homes) * rows
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "1x4", "4x1"])
def test_two_axis_lookup_gradient_is_take_rows_backward(shape):
    """The lookup's gradient bitwise ``take_rows``'s backward over the
    whole batch, ids out of range and repeated included: through the
    train step's ``TPView`` (each block's holder sums the gradient rows
    of every batch shard of its "data" line, moved there along "data",
    ``emb_grad_data``, the bytes of the forward's ``emb_rows_data``) and
    through ``StationaryView`` (the batch whole, its bytes
    :func:`whole_lookup_bytes`' to the byte)."""
    mesh = _mesh(shape)
    V, e = 24, 8
    g = torch.Generator().manual_seed(2)
    table = torch.randn((V, e), generator=g)
    ids = IDS
    dy = torch.randn(ids.shape + (e,), generator=g)
    tr = table.clone().requires_grad_(True)
    want = take_rows(tr, ids)
    (torch.nan_to_num(want) * dy).sum().backward()
    homes = batch_groups(mesh, "data")[0]
    D = len(homes)
    view, got, shard = _lookup(mesh, table, ids, "pinned")
    seeds = [p for p in range(mesh.size) if view.collects(p)]
    torch.autograd.backward([torch.nan_to_num(got.parts[p]) for p in seeds],
                            [dy.chunk(D)[shard[p]] for p in seeds])
    assert torch.equal(_block_sum(view), tr.grad)
    assert mesh.bytes.get("emb_grad_data", 0) == \
        mesh.bytes.get("emb_rows_data", 0)
    assert (mesh.bytes.get("emb_rows_data", 0) > 0) == (shape[0] > 1)
    mesh.reset_bytes()
    view, got, _ = _lookup(mesh, table, ids, "whole", grad=True)
    torch.autograd.backward([torch.nan_to_num(p) for p in got.parts],
                            list(dy.chunk(D)))
    assert torch.equal(_block_sum(view), tr.grad)
    assert dict(mesh.bytes) == whole_lookup_bytes(
        mesh, view.x.layout, homes, ids.numel(), 4, grad=True)


@pytest.mark.parametrize("form", ["pinned", "unpinned", "whole"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 1)], ids=["2x2", "2x1"])
def test_tp2d_lookup_rows_are_one_devices_take_rows(shape, form):
    """Each form's rows at every output position bitwise one device's
    ``take_rows`` of the table at that position's batch shard, NaN rows
    (ids outside [-V, V)) and −0.0 entries included, in f32 and cast to
    bf16 inside the lookup (the cast table's rows)."""
    mesh = _mesh(shape)
    table = torch.randn((24, 8), generator=torch.Generator().manual_seed(1))
    table[5] = -0.0
    table[11, :3] = -0.0
    D = len(batch_groups(mesh, "data")[0])
    for dtype in (torch.float32, torch.bfloat16):
        want = take_rows(table.to(dtype), IDS).chunk(D)
        view, got, shard = _lookup(mesh, table, IDS, form)
        if dtype != torch.float32:
            got = (view.take_rows(Rows(
                [IDS.chunk(D)[d] for d in shard], list(range(mesh.size)),
                mesh), dtype) if form != "whole" else
                view.take_rows(Rows(list(IDS.chunk(D)),
                                    batch_groups(mesh, "data")[0], mesh),
                               dtype))
        for part, d in zip(got.parts, shard):
            assert part.dtype == dtype
            _same_rows_as(part, want[d])


@pytest.mark.parametrize("form", ["pinned", "unpinned", "whole"])
def test_tp2d_lookup_keeps_negative_zero(form):
    """An entry of −0.0 stays −0.0 through each form on 2 × 2: the fold
    over "model" selects each row from the block that owns it, never adds
    it to the other blocks' masked zeros (the reference's all-reduce
    would give +0.0)."""
    mesh = _mesh((2, 2))
    table = torch.ones((8, 4))
    table[2] = -0.0
    table[6, 1] = -0.0
    ids = torch.tensor([[2, 6, 2, 1], [6, 6, 2, 0]], dtype=torch.int32)
    _, got, shard = _lookup(mesh, table, ids, form)
    for part, d in zip(got.parts, shard):
        rows = ids[d:d + 1]
        assert torch.equal(torch.signbit(part), torch.signbit(table[rows]))
        assert bool(torch.signbit(part[rows == 2]).all())


def test_tp2d_lookup_gradient_takes_one_devices_order():
    """The pinned form's backward sums each block's gradient rows in one
    pass over the whole microbatch in batch order, the order of one
    device's ``take_rows`` backward, not per batch shard with the shards'
    sums added afterwards (the parent form's order). Row 3 is looked up
    once in each of the four rows of the batch, the 2 × 2 mesh's two
    shards, with gradient rows 1, 2^24, 1 and −2^24: one pass gives
    ((1 + 2^24) + 1) − 2^24 = 0 in f32, the shards' sums (1 + 2^24) +
    (1 − 2^24) = 1. The ``embed`` gradient is bitwise one device's."""
    mesh = _mesh((2, 2))
    table = torch.randn((8, 4), generator=torch.Generator().manual_seed(3))
    ids = torch.tensor([[3, 0], [3, 1], [3, 4], [3, 7]], dtype=torch.int32)
    dy = torch.zeros(ids.shape + (4,))
    g = torch.tensor([1.0, 2.0 ** 24, 1.0, -2.0 ** 24])
    dy[:, 0] = g[:, None]
    tr = table.clone().requires_grad_(True)
    (take_rows(tr, ids) * dy).sum().backward()
    per_shard = (g[0] + g[1]) + (g[2] + g[3])
    assert float(tr.grad[3, 0]) == 0.0 and float(per_shard) == 1.0
    view, got, shard = _lookup(mesh, table, ids, "pinned")
    torch.autograd.backward(got.parts, [dy.chunk(2)[d] for d in shard])
    assert torch.equal(_block_sum(view), tr.grad)


# -- the vocab-parallel cross entropy -------------------------------------------------

def _labels(B, S, V, seed):
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    labels[0, :3] = -1
    labels[-1, -1] = -1
    return labels


@pytest.mark.parametrize("batch", ["whole", "split"])
@pytest.mark.parametrize("head", ["vocab", "tied"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 2), (2, 1), (1, 4)],
                         ids=["1x1", "2x2", "1x2", "2x1", "1x4"])
def test_vocab_parallel_loss(shape, head, batch):
    """``collectives.vocab_parallel_xent`` (the ``fsdp`` head where its
    blocks lie) over a head split over V on every position
    (P(None, ("data", "model"))), or a tied table ``embed`` under P(("data",
    "model"), None) read as its transpose, the batch at one home (whole)
    or split over "data": each home's loss within LOSS_RTOL, the hidden
    rows' and the head's gradients within GRAD_RTOL of the plain loss's;
    one block bit for bit, nothing moved; no gather, only the rows, the
    statistics and the dX partials cross positions."""
    mesh = _mesh(shape)
    homes, groups = batch_groups(mesh, "data" if batch == "split" else None)
    B, S, d, V = 4, 6, 32, 64
    g = torch.Generator().manual_seed(sum(shape))
    hidden = torch.randn((B, S, d), generator=g)
    labels = _labels(B, S, V, 3)
    if head == "tied":
        w = torch.randn((V, d), generator=g) * 0.3
        placed = device_put(w, mesh, P(("data", "model"), None))
    else:
        w = torch.randn((d, V), generator=g) * 0.3
        placed = device_put(w, mesh, P(None, ("data", "model")))
    views = [ShardView(placed, h, grp) for h, grp in zip(homes, groups)]
    hr, wr = hidden.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = [L.softmax_xent_sharded(part, wr.T if head == "tied" else wr, lab)
            for part, lab in zip(hr.chunk(len(homes)),
                                 labels.chunk(len(homes)))]
    torch.autograd.backward(want)
    hs = [t.requires_grad_(True) for t in _split(hidden, len(homes))]
    tots, counts = vocab_parallel_xent(
        Rows(hs, homes, mesh), Rows(list(labels.chunk(len(homes))), homes,
                                    mesh), views, head == "tied")
    got = [t / torch.clamp_min(c, 1) for t, c in zip(tots.parts,
                                                      counts.parts)]
    torch.autograd.backward(got)
    gh = torch.cat([t.grad for t in hs])
    gw = torch.zeros_like(w)
    for view in views:
        for block, _, grad in view.grads():
            if grad is not None:
                gw[placed.layout.slices(block)] += grad
    if mesh.size == 1:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(gh, hr.grad) and torch.equal(gw, wr.grad)
        assert not mesh.bytes
        return
    for a, b in zip(got, want):
        a, b = float(a.detach()), float(b.detach())
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    _close(gh, hr.grad, GRAD_RTOL)
    _close(gw, wr.grad, GRAD_RTOL)
    assert mesh.bytes["head_stats"] > 0
    assert not set(mesh.bytes) & GATHERS


# -- the tp2d train step ----------------------------------------------------------------

def _batches(cfg, B=8, S=16, n=N_STEPS):
    pipe = TokenPipeline(cfg.vocab_size, B, S, seed=0)
    return [[torch.as_tensor(a) for a in pipe.batch_at(i)] for i in range(n)]


def _run(cfg, shape, micro, bspec, steps=N_STEPS, reference=True,
         moves=None, tcfg=TCFG, group=16, batches=None):
    """(unsharded metrics, mesh metrics, unsharded state, mesh state, the
    bytes of each mesh step); each step's ``Mesh.moves`` appended to
    ``moves`` when it is a list."""
    model = TransformerLM(cfg, moe_group_size=group,
                          act_spec=P("data", None, None))
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    mesh = _mesh(shape)
    specs = state_specs_like(lm_param_specs(params, cfg, "tp2d"))
    state = new_sharded_train_state(params, mesh, specs)
    step = make_tp2d_train_step(model.loss, tcfg, mesh, specs, bspec,
                                microbatches=micro)
    ref = rstep = None
    if reference:
        ref = new_train_state(model.init(torch.Generator().manual_seed(0),
                                         dtype=torch.float32))
        rstep = make_train_step(model.loss, tcfg, microbatches=micro)
    want, got, nbytes = [], [], []
    for b in (batches or _batches(cfg))[:steps]:
        if reference:
            ref, rm = rstep(ref, *b)
            want.append((float(rm["loss"]), float(rm["grad_norm"])))
        mesh.reset_bytes()
        state, m = step(state, *b)
        got.append((float(m["loss"]), float(m["grad_norm"])))
        nbytes.append(dict(mesh.bytes))
        if moves is not None:
            moves.append(dict(mesh.moves))
    return want, got, ref, state, nbytes


def _whole(state):
    return [gather(x) if isinstance(x, ShardedTensor) else x
            for x in tree_leaves(state)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp2d_step_on_one_position_is_the_unsharded_step(name):
    want, got, ref, state, nbytes = _run(MODELS[name], (1, 1), 2,
                                         P("data", None))
    assert got == want
    for a, b in zip(tree_leaves(ref), _whole(state)):
        assert torch.equal(a, b)
    assert not any(nbytes)


@pytest.mark.parametrize("batch", ["whole", "split"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)],
                         ids=["1x2", "2x1", "2x2", "1x4"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp2d_step_against_the_unsharded_step(name, shape, batch):
    cfg = MODELS[name]
    bspec = P("data", None) if batch == "split" else P(None, None)
    want, got, ref, state, nbytes = _run(cfg, shape, 2, bspec)
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=STEP_RTOL)
        assert n1 == pytest.approx(n0, rel=STEP_RTOL)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), _whole(state.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)
    D, M = shape
    for step in nbytes:
        assert not set(step) & (GATHERS | STATIONARY), step
        # the weights gathered along "data", the sums over "model"
        assert (step.get("tp_zero_gather", 0) > 0) == (D > 1)
        assert (step.get("tp_model_sum", 0) > 0) == (M > 1)
        # the lookup's partial rows over "model", its rows along "data"
        assert (step.get("emb_rows_model", 0) > 0) == (M > 1)
        assert (step.get("emb_rows_data", 0) > 0) == (D > 1)
    if cfg.moe is not None and cfg.moe.n_experts % 16 == 0 and M > 1:
        assert all(step["expert_gather"] > 0 for step in nbytes)


@pytest.mark.parametrize("micro", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 2), (2, 1)], ids=["2x2", "2x1"])
@pytest.mark.parametrize("name", ["qwen3-moe-e16", "smollm-135m"])
def test_tp2d_microbatches_split_as_make_train_steps(name, shape, micro):
    """``microbatches`` M as ``make_train_step``'s: M rounds, microbatch i's
    rows split over the two batch shards (so M = 1 runs with "data" > 1),
    the MoE groups and aux loss over each microbatch's tokens, the loss
    each microbatch's mean over its tokens: loss and grad norm within
    ``STEP_RTOL`` of the unsharded step's, every leaf after 2 steps within
    rtol 1e-4, atol 2 · lr · steps; the weights gathered once a
    microbatch (``tp_zero_gather`` M times one round's)."""
    cfg = MODELS[name]
    want, got, ref, state, nbytes = _run(cfg, shape, micro, P("data", None))
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=STEP_RTOL)
        assert n1 == pytest.approx(n0, rel=STEP_RTOL)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), _whole(state.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)
    one = tp2d_step_bytes(cfg, shape, micro=1, B=8 // micro)
    assert nbytes[0]["tp_zero_gather"] == micro * one["tp_zero_gather"]
    assert nbytes[0] == tp2d_step_bytes(cfg, shape, micro=micro)


@pytest.mark.parametrize("name", ["qwen3-moe-e16", "smollm-135m"])
def test_tp2d_one_microbatch_on_one_position_is_the_unsharded_step(name):
    want, got, ref, state, nbytes = _run(MODELS[name], (1, 1), 1,
                                         P("data", None))
    assert got == want
    for a, b in zip(tree_leaves(ref), _whole(state)):
        assert torch.equal(a, b)
    assert not any(nbytes)


CLIP = dataclasses.replace(TCFG, grad_clip=0.05)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("name", ["qwen3-moe-e16", "smollm-135m"])
def test_tp2d_clip_norm_is_one_scalar_allreduce(name, shape):
    """A clip that bites (``grad_clip`` 0.05, below every step's norm): the
    grad norm within 1e-5 of ``global_norm``'s (the unsharded step's) on
    2 × 2, bit for bit on one position, and every leaf after 2 clipped
    steps as the unsharded step's; the norm moves no gradient, only each
    position's 4-byte scalar to every other (``norm_sum``)."""
    want, got, ref, state, nbytes = _run(MODELS[name], shape, 2,
                                         P("data", None), tcfg=CLIP)
    assert all(n > CLIP.grad_clip for _, n in want)
    N = shape[0] * shape[1]
    if N == 1:
        assert got == want
        for a, b in zip(tree_leaves(ref), _whole(state)):
            assert torch.equal(a, b)
        return
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=STEP_RTOL)
        assert n1 == pytest.approx(n0, rel=1e-5)
    flips = 2 * CLIP.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), _whole(state.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)
    for step in nbytes:
        assert step["norm_sum"] == N * (N - 1) * 4
        assert "norm_gather" not in step


def _same_rows(batches):
    """Every row of each batch row 0's: one token sequence, so every group
    routes alike and the experts' capacity overflows."""
    return [[t[:1].expand_as(t).clone() for t in b] for b in batches]


def _moe_shard(cfg, moe_shard):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, moe_shard=moe_shard))


@pytest.mark.parametrize("rows", ["same", "random"])
@pytest.mark.parametrize("moe_shard", ["expert", "ffn"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 1)], ids=["2x2", "2x1"])
def test_tp2d_group_across_batch_shards(shape, moe_shard, rows):
    """Fault 8: a MoE group that spans the batch shards of a microbatch in
    training (``moe_group_size`` 64 over 2 shards of 32 tokens, 16
    experts) is routed once over them, as the reference routes it: loss
    and grad norm within ``STEP_RTOL`` of the unsharded step at the same
    microbatches, every leaf after 2 steps within rtol 1e-4, atol
    2 · lr · steps; every row row 0's (capacity overflows, so per-shard
    groups would keep other slots) and random rows; two runs bitwise;
    every collective's bytes :func:`tp2d_step_bytes`'s."""
    cfg = _moe_shard(MOE16, moe_shard)
    batches = _batches(cfg)
    if rows == "same":
        batches = _same_rows(batches)
    runs = [_run(cfg, shape, 2, P("data", None), group=64, batches=batches,
                 reference=i == 0) for i in range(2)]
    want, got, ref, state, nbytes = runs[0]
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=STEP_RTOL)
        assert n1 == pytest.approx(n0, rel=STEP_RTOL)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), _whole(state.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)
    assert runs[1][1] == got and runs[1][4] == nbytes
    for a, b in zip(_whole(state), _whole(runs[1][3])):
        assert torch.equal(a, b)
    assert nbytes[0] == tp2d_step_bytes(cfg, shape, group=64)
    assert nbytes[0]["moe_group_probs_grad"] > 0


def test_tp2d_microbatch_that_does_not_split_raises():
    """A microbatch whose rows do not split over the batch shards (B/M
    not divisible by D) raises and says so."""
    model = TransformerLM(MOE16, moe_group_size=64,
                          act_spec=P("data", None, None))
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    mesh = _mesh((2, 2))
    specs = state_specs_like(lm_param_specs(params, MOE16, "tp2d"))
    state = new_sharded_train_state(params, mesh, specs)
    with pytest.raises(ValueError, match="B/M must divide by D"):
        make_tp2d_train_step(model.loss, TCFG, mesh, specs, P("data", None),
                             microbatches=8)(state, *_batches(MOE16)[0])


def tp2d_step_bytes(cfg, shape, micro=2, B=8, S=16, group=16):
    """Every collective's bytes of one ``make_tp2d_train_step`` step
    (``remat="none"``, the batch split over "data", the SMOKE widths, which
    divide every production axis size) on a (D, M) mesh, from the config
    alone: per microbatch (a round, each batch shard B/(micro·D) of its
    rows) the gathers along "data" (compute dtype) and their
    reduce-scatters (f32), the sums over "model" (reduce-scatter of the
    partial, all-gather of the rounded sum), the heads and experts over
    "model", the loss's statistics, its sum and count over "data" (4-byte
    scalars), the MoE aux loss's means and counts over "data" and the
    two-axis lookup; per step the replicas' sums, the norm's scalars over
    every position and AdamW's sends (f32)."""
    D, M = shape
    N = D * M
    rounds = micro
    R = B // micro // D * S                  # rows a position holds
    c = 4 if cfg.dtype == "float32" else 2   # the compute dtype's bytes
    d, H, KV, hd, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.n_layers, cfg.vocab_size)
    moe = cfg.moe
    attn = [d * H * hd, d * KV * hd, d * KV * hd, H * hd * d]
    spans = 1                                # batch shards a group spans
    if moe is None:
        mlp_col, mlp_row = [d * cfg.d_ff] * 2, [cfg.d_ff * d]
        experts = router = E = Ce = G = 0
    else:
        mlp_col, mlp_row = [], []
        E, k, fe = moe.n_experts, moe.top_k, moe.d_ff_expert
        experts, router = 3 * E * d * fe, d * E
        G = max(1, R // group)
        spans = max(1, group // R)
        Ce = max(8, -(-(int(R * spans // G * k * 1.25 / E) + 1) // 8) * 8)
    split = [*attn, *mlp_col, *mlp_row]      # over "data" and "model"
    out = {}
    # the weights gathered along "data" and reduce-scattered back; the
    # router is split over "data" only, so every "model" position gathers it
    gathered = L * sum(split) + V * d        # the layers and the head
    out["tp_zero_gather"] = rounds * (D - 1) * c * (gathered + M * L * router)
    # a batch shard's partials from each other shard, at every position
    out["loss_sum"] = rounds * N * (D - 1) * (4 + 4)
    out["moe_aux_sum"] = rounds * L * N * (D - 1) * (4 + 4) * E
    out["tp_zero_scatter"] = rounds * (D - 1) * 4 * (gathered + L * router)

    def allreduce(n, p):                     # over D groups of M
        return D * (M - 1) * n * (p + c)
    per_layer = allreduce(R * d, 4) * (1 + len(mlp_row))        # wo, wd
    per_layer += allreduce(R * d, 4) * (3 + len(mlp_col))       # dX: q k v g u
    if moe is not None and moe.moe_shard == "ffn" and M > 1:
        per_layer += 2 * allreduce(G * E * Ce * d, c)          # down, its dX
    out["tp_model_sum"] = rounds * (L * per_layer + allreduce(R * d, 4))
    out["xent_stats"] = rounds * N * (M - 1) * 12 * R
    heads = 0
    if M > 1 and not (H % M == 0 and KV % M == 0):
        per, g = H // M, H // KV
        if H % M == 0 and g % per == 0:      # k, v heads taken, both ways
            w = KV * hd // M
            for m in range(M):
                lo = m * per // g * hd
                mine = max(0, min(lo + hd, (m + 1) * w) - max(lo, m * w))
                heads += 2 * 2 * (hd - mine) * R * c
            heads *= D
        else:                                # q, k, v gathered, o's back
            heads = N * (M - 1) * R * (2 * H + 2 * KV) * hd * c // M
    out["tp_heads_gather"] = rounds * L * heads
    by_model = moe is not None and moe.moe_shard == "expert" and E % 16 == 0
    if by_model:
        out["expert_gather"] = (rounds * L * 2 * N * (M - 1) * G * E * Ce
                                * d * c // M)
    if spans > 1:
        # a group over the shards: its probabilities along "data" and their
        # gradients back, each position's dispatch rows from the others
        out["moe_group_probs"] = rounds * L * N * (spans - 1) * R * E * 4
        out["moe_group_probs_grad"] = out["moe_group_probs"]
        out["moe_group_dispatch"] = (rounds * L * N * (spans - 1) * E * Ce
                                     * d * c // (M if by_model else 1))
    # the lookup as the reference's partitioner forms it: on a square mesh
    # the ids permuted (d, m) -> (m, d) from the D (M - 1) positions off
    # the diagonal, then each position's ids of the D - 1 other shards
    # gathered; each position's partial rows of all D shards in its (V/M,
    # d/D) block reduce-scattered and all-gathered over its "model" line,
    # 2 (M - 1) / M of them into each position; its shard's rows of the
    # D - 1 column blocks it lacks along "data", and the gradient rows the
    # same way back (the compute dtype)
    if D == M > 1:
        out["emb_ids_permute"] = rounds * D * (M - 1) * R * 4
    out["emb_ids_gather"] = rounds * N * (D - 1) * R * 4
    out["emb_rows_model"] = rounds * D * 2 * (M - 1) * R * d * c
    out["emb_rows_data"] = rounds * N * (D - 1) * R * d // D * c
    out["emb_grad_data"] = out["emb_rows_data"]
    ex_blocks = 1 if moe is None else (
        M if moe.moe_shard == "ffn" or E % 16 == 0 else 1)
    out["grad_psum"] = (D - 1) * 4 * (L * (2 * d + experts) + d)
    # (numel, blocks) of every leaf, for AdamW's sends
    leaves = [(n, N) for n in split for _ in range(L)] + [(V * d, N)]
    leaves += [(router, D)] * L if moe else []
    leaves += [(experts, ex_blocks)] * L + [(d, 1)] * (2 * L + 1)
    if not cfg.tie_embeddings:
        leaves.append((V * d, N))            # the head beside the embed
    out["norm_sum"] = N * (N - 1) * 4
    out["grad_send"] = sum(n * 4 * (N - b) // b for n, b in leaves)
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)],
                         ids=["1x2", "2x1", "2x2", "1x4"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp2d_step_bytes_by_formula(name, shape):
    """Each collective's bytes a step, by name, equal to
    :func:`tp2d_step_bytes`; with MoE layers also where a group spans the
    batch shards (``moe_group_size`` 64: fault 8's routing)."""
    groups = [16] + ([64] if MODELS[name].moe and shape[0] > 1 else [])
    for group in groups:
        _, _, _, _, nbytes = _run(MODELS[name], shape, 2, P("data", None),
                                  steps=1, reference=False, group=group)
        assert nbytes[0] == tp2d_step_bytes(MODELS[name], shape,
                                            group=group), group


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("name", ["qwen3-moe-e16", "qwen3-moe-ffn",
                                  "smollm-135m"])
def test_tp2d_step_bytes_by_chip_smoke_formula(name, remat, micro):
    """On 2 × 2 every collective's bytes a step equal to
    ``chip_smoke.tp2d_bytes_want`` (the formula the card's
    train-sharded-tp2d runs are held to: the generic one from the ``tp2d``
    specs, with ``remat``'s recompute), one round per microbatch."""
    import chip_smoke
    cfg = dataclasses.replace(MODELS[name], remat=remat)
    _, _, _, _, nbytes = _run(cfg, (2, 2), micro, P("data", None), steps=1,
                              reference=False)
    assert nbytes[0] == chip_smoke.tp2d_bytes_want(
        cfg, (2, 2), 8 // micro // 2 * 16, micro, 16)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("moe_shard", ["expert", "ffn"])
def test_tp2d_spanning_bytes_by_chip_smoke_formula(moe_shard, remat):
    """Fault 8's routing on 2 × 2 (``moe_group_size`` 64 over the two batch
    shards' 32 tokens, 16 experts): every collective's bytes a step equal
    to ``chip_smoke.tp2d_bytes_want``, the formula train-sharded-tp2d (iv)
    is held to on the card (the group's probabilities and dispatch rows
    again in ``remat``'s recompute, the probabilities' gradients once)."""
    import chip_smoke
    cfg = dataclasses.replace(_moe_shard(MOE16, moe_shard), remat=remat)
    _, _, _, _, nbytes = _run(cfg, (2, 2), 2, P("data", None), steps=1,
                              reference=False, group=64)
    assert nbytes[0]["moe_group_probs"] > 0
    assert nbytes[0] == chip_smoke.tp2d_bytes_want(cfg, (2, 2), 32, 2, 64)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp2d_moves_run_along_their_axes(name):
    """On 2 × 2, every weight byte (``tp_zero_gather``, ``tp_zero_scatter``)
    moves between positions of one "model" coordinate (along "data") and
    every activation sum (``tp_model_sum``) between positions of one "data"
    coordinate (along "model"), as the reference's HLO groups its weight
    all-gathers and its activation all-reduces (``Mesh.moves`` names each
    move's source and receiver)."""
    moves = []
    _, _, _, _, nbytes = _run(MODELS[name], (2, 2), 2, P("data", None),
                              steps=1, reference=False, moves=moves)
    mesh = _mesh((2, 2))
    seen = dict.fromkeys(WEIGHT_MOVES | SUM_MOVES, 0)
    for (what, frm, to), n in moves[0].items():
        a, b = mesh.coords(frm), mesh.coords(to)
        if what in WEIGHT_MOVES:
            assert a["model"] == b["model"] and a["data"] != b["data"]
        if what in SUM_MOVES:
            assert a["data"] == b["data"] and a["model"] != b["model"]
        if what in seen:
            seen[what] += n
    assert seen == {w: nbytes[0][w] for w in seen}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp2d_step_with_the_head_whole_over_model(shape):
    """A vocab that splits over "data" but not over ("data", "model")
    (528 entries: qwen3-moe-30b-a3b's 151,936 on the production mesh
    likewise) degrades the head's spec to P(None, "data"): every "model"
    position then takes the loss over the whole vocab, folding only its
    own statistics (no ``xent_stats``), and the step still matches the
    unsharded one."""
    cfg = dataclasses.replace(qcfg.SMOKE, vocab_size=528)
    assert lm_param_specs(TransformerLM(cfg).init(
        torch.Generator(), dtype=torch.float32, device="meta"), cfg,
        "tp2d")["head"] == P(None, "data")
    want, got, ref, state, nbytes = _run(cfg, shape, 2, P("data", None))
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=STEP_RTOL)
        assert n1 == pytest.approx(n0, rel=STEP_RTOL)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), _whole(state.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)
    assert all("xent_stats" not in step for step in nbytes)


@pytest.mark.parametrize("name,shape,branch", [
    ("qwen3-moe", (1, 2), "heads"), ("qwen3-moe", (1, 4), "kv-taken"),
    ("smollm-135m", (1, 2), "all-gathered")])
def test_split_heads_branches(name, shape, branch):
    """``split_heads`` on the column blocks of q, k and v, attention at
    each position and each position's part of the output against the
    unsplit attention, forward and backward (f32, the CPU's plain
    versions): qwen3-moe's 4 / 2 heads split on (1, 2); on (1, 4) each
    position takes the key-value head of its one query head (gradients of
    a head two positions take added back); smollm-135m's 3 / 1 heads on
    (1, 2) gathered whole, every position attending over all of them."""
    from repro_torch.distrib.collectives import each, split_heads
    cfg = MODELS[name]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mesh = _mesh(shape)
    M = shape[1]
    g = torch.Generator().manual_seed(7)
    B, S = 2, 24
    q, k, v = (torch.randn((B, S, n * hd), generator=g)
               for n in (H, KV, KV))
    do = torch.randn((B, S, H * hd), generator=g)
    full = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def attend(qt, kt, vt):
        b, s = qt.shape[:2]
        o = L.blockwise_attention(*(t.reshape(b, s, -1, hd)
                                    for t in (qt, kt, vt)))
        return o.flatten(2)
    want = attend(*full)
    (want * do).sum().backward()
    homes = list(range(mesh.size))
    blocks = [[t.chunk(M, -1)[h].clone().requires_grad_(True)
               for h in homes] for t in (q, k, v)]
    qs, ks, vs, own = split_heads(*(Rows(b, homes, mesh) for b in blocks),
                                  H, KV, hd)
    o = each(attend, qs, ks, vs)
    if own is not None:
        o = own(o)
    got = torch.cat(o.parts, -1)
    torch.autograd.backward(o.parts, list(do.chunk(M, -1)))
    _close(got.detach(), want.detach(), 1e-6)
    for b, w in zip(blocks, full):
        _close(torch.cat([t.grad for t in b], -1), w.grad, 1e-6)
    moved = mesh.bytes.get("tp_heads_gather", 0)
    assert (moved > 0) == (branch != "heads")
    assert (own is not None) == (branch == "all-gathered")
    if branch == "kv-taken":
        # one key-value head a position, both ways, for k and v
        w = KV * hd // M
        assert all(t.shape[-1] == hd for t in ks.parts + vs.parts)
        assert moved == 2 * 2 * sum(hd - w for _ in range(M)) * B * S * 4


@pytest.mark.parametrize("name", ["qwen3-moe-e16", "smollm-135m"])
def test_tp2d_step_repeats_bitwise(name):
    runs = [_run(MODELS[name], (2, 2), 4, P("data", None), reference=False)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    assert runs[0][4] == runs[1][4]
    for a, b in zip(_whole(runs[0][3]), _whole(runs[1][3])):
        assert torch.equal(a, b)


def _moment_gaps(state, ref):
    """Per leaf: ||m - m_ref|| / ||m_ref|| of the AdamW first moments."""
    out = []
    for x, r in zip(tree_leaves(state.opt.m), tree_leaves(ref.opt.m)):
        whole = gather(x) if isinstance(x, ShardedTensor) else x
        out.append(float((whole - r).norm() / r.norm()))
    return out


@pytest.mark.parametrize("name", ["qwen3-moe", "smollm-135m"])
def test_tp2d_bf16_leaves_within_the_f32_control(name):
    """bf16 compute, the card's (a column block's dX partials and a row
    block's partials are f32 through ``_mm``, a branch the f32 tests never
    take): after 2 steps on 2 × 2 each leaf's AdamW first moment, a sum of
    both steps' gradients, is no farther from the unsharded bf16 step's
    than ``LEAF_FACTOR`` times the unsharded f32 step's distance from it
    (the control: what bf16 rounding alone does to that leaf)."""
    cfg = dataclasses.replace(MODELS[name], dtype="bfloat16")
    _, _, ref, state, _ = _run(cfg, (2, 2), 2, P("data", None))
    f32 = _run(dataclasses.replace(cfg, dtype="float32"), (1, 1), 2,
               P("data", None))[2]
    gaps, control = _moment_gaps(state, ref), _moment_gaps(f32, ref)
    ratio = [g / c for g, c in zip(gaps, control)]
    assert max(ratio) <= LEAF_FACTOR, (gaps, control)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["qwen3-moe-e16", "smollm-135m"])
def test_tp2d_remat_is_bitwise_none(name):
    """``remat="full"`` and ``"dots"`` on the 2 × 2 mesh: bitwise the
    ``"none"`` step; the full recompute runs the products again, the dots
    recompute does not (their outputs are saved, as on one device), and
    both repeat the forward's gathers along "data" (``tp_zero_gather``)."""
    out, counts = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(MODELS[name], remat=remat)
        with _CountMM() as mm:
            out[remat] = _run(cfg, (2, 2), 2, P("data", None), steps=1,
                              reference=False)
        counts[remat] = mm.n
    for remat in ("full", "dots"):
        assert out[remat][1] == out["none"][1]
        for a, b in zip(_whole(out[remat][3]), _whole(out["none"][3])):
            assert torch.equal(a, b)
        assert out[remat][4][0]["tp_zero_gather"] > \
            out["none"][4][0]["tp_zero_gather"]
    assert counts["dots"] == counts["none"] < counts["full"]


# -- against the reference's jitted tp2d step ---------------------------------------------

# the HLO's collective bytes a chip by kind and by the mesh axis of their
# groups (host devices as a (D, MODEL) ("data", "model") mesh, 2 x 2 unless
# a case sets MODEL); shared with ``test_torch_tp_serve.py``'s child
HLO_AXES = r'''
import re
import numpy as np
from repro.launch.roofline import _COLLECTIVE_RE, collective_bytes

MODEL = 2                       # the mesh's "model" size


def axis(line):
    # the mesh axis a collective's groups run along (device i at data
    # i // MODEL, model i % MODEL): "data", "model", "both" or "none"
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", line)
    if m:
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(x) for x in m.group(4).split(",")])
        groups = ids.reshape(int(m.group(1)), int(m.group(2))).tolist()
    else:
        m = re.search(r"(?:replica_groups|source_target_pairs)="
                      r"\{((?:\{[\d,]*\},?)*)\}", line)
        groups = [[int(x) for x in g.split(",") if x]
                  for g in re.findall(r"\{([\d,]*)\}", m.group(1))]
    same_d = all(len({i // MODEL for i in g}) == 1 for g in groups)
    same_m = all(len({i % MODEL for i in g}) == 1 for g in groups)
    if same_d and same_m:
        return "none"
    return "model" if same_d else "data" if same_m else "both"


def read_hlo(hlo):
    # {"kind axis": operand bytes a chip} of a compiled module's text
    lines = hlo.splitlines()
    tags = [axis(l) if _COLLECTIVE_RE.search(l) else None for l in lines]
    read = {}
    for ax in ("data", "model", "both", "none"):
        keep = "\n".join(l for l, t in zip(lines, tags) if t in (None, ax))
        for kind, n in collective_bytes(keep).items():
            if n:
                read[f"{kind} {ax}"] = n
    return read


LM_LOOKUP = ("models/transformer.py", '["embed"].astype(cd)[token')


LOOKUP_OPS = ("/gather", "transpose(jvp())/scatter-add")


def lookup_collectives(hlo, path, text, sum_tuples=False, ops=LOOKUP_OPS,
                       kinds=None, side=None):
    # {"kind axis": operand bytes a chip} of a table lookup's collectives:
    # those whose op ends in one of ``ops`` (LOOKUP_OPS: the gather, or its
    # transpose's scatter-add) and whose source line, from the module's
    # stack frame tables, is one of the file ending in ``path`` that holds
    # ``text`` (LM_LOOKUP: the LM's params["embed"][tokens]); only the
    # collectives of ``kinds`` where given, and of the forward ("fwd") or
    # the backward ("bwd": an op under ``transpose(``) where ``side`` is
    # given; with ``sum_tuples`` a tuple collective counts each element
    # (the operands one combined collective carries), else its largest, as
    # collective_bytes counts; and its shapes, {"kind axis": [shape, ...]}
    import linecache
    tables, cur = {}, None
    for l in hlo.splitlines():
        if l in ("FileNames", "FunctionNames", "FileLocations",
                 "StackFrames"):
            cur = tables.setdefault(l, {})
            continue
        m = re.match(r"^(\d+) (.*)$", l)
        if cur is not None and m:
            cur[int(m.group(1))] = m.group(2)
        else:
            cur = None

    def source(frame):
        loc = re.search(r"file_location_id=(\d+)",
                        tables["StackFrames"][frame])
        f = tables["FileLocations"][int(loc.group(1))]
        name = tables["FileNames"][int(re.search(r"file_name_id=(\d+)",
                                                 f).group(1))].strip('"')
        return name, int(re.search(r"line=(\d+)", f).group(1))

    def looks_up(line):
        op = re.search(r'op_name="([^"]*)"', line)
        frame = re.search(r"stack_frame_id=(\d+)", line)
        if not op or not frame or not any(op.group(1).endswith(o)
                                          for o in ops):
            return False
        if kinds and _COLLECTIVE_RE.search(line).group(3) not in kinds:
            return False
        if side and (side == "bwd") != ("transpose(" in op.group(1)):
            return False
        name, n = source(int(frame.group(1)))
        return name.endswith(path) and text in linecache.getline(name, n)
    lines = hlo.splitlines()
    tags = [axis(l) if _COLLECTIVE_RE.search(l) and looks_up(l) else
            "other" if _COLLECTIVE_RE.search(l) else None for l in lines]
    read, shapes = {}, {}
    for ax in ("data", "model", "both", "none"):
        keep = []
        for l, t in zip(lines, tags):
            m = _COLLECTIVE_RE.search(l) if t == ax else None
            if m and sum_tuples and m.group(1) and not m.group(4):
                # one line per element, each counted as a collective of
                # its own (the loop weights stay: same computation)
                for elem in re.findall(r"[a-z]+\d*\[[0-9,]*\]", m.group(1)):
                    keep.append(l.replace(m.group(0), "= " + elem + " "
                                          + m.group(3) + "("))
            elif t in (None, ax):
                keep.append(l)
            if m:
                shapes.setdefault(f"{m.group(3)} {ax}", []).extend(
                    re.findall(r"\[([0-9,]*)\]", m.group(1) or m.group(2)))
        for kind, n in collective_bytes("\n".join(keep)).items():
            if n:
                read[f"{kind} {ax}"] = n
    return (read, shapes) if sum_tuples else read


# the head's collectives in the vocab-parallel loss: the product
# ``hidden @ head_w`` (its forward and its transpose), the log-sum-exp's
# reductions (the row maxima, the sums of the exponentials), and an
# all-reduce the partitioner makes of the target logits' line where it
# fuses the sums into it (a tuple, counted by its largest element)
HEAD_SITES = (("models/layers.py", "logits = (hidden @ head_w",
               ("/dot_general",), None),
              ("models/layers.py", "lse = jax.scipy.special.logsumexp",
               ("/reduce_max", "/reduce_sum"), None),
              ("models/layers.py", 'tgt = jnp.einsum("bsv,bsv->bs"',
               ("/dot_general",), ("all-reduce",)))
# a prefill's logits: ``hidden @ self._head_w(params)``
PREFILL_HEAD = (("models/transformer.py",
                 "return hidden @ self._head_w(params)", ("/dot_general",),
                 None),)
# the chunked loss's head: ``xc @ w`` in the chunk scan
CHUNKED_HEAD = (("models/transformer.py", "lambda xc: xc @ w.astype",
                 ("/dot_general",), None),)


def head_collectives(hlo, sites=HEAD_SITES, side=None):
    # {"kind axis": operand bytes a chip} of ``sites``' collectives
    # (``lookup_collectives`` of each (path, text, ops, kinds)), added
    out = {}
    for path, text, ops, kinds in sites:
        for k, v in lookup_collectives(hlo, path, text, ops=ops,
                                       kinds=kinds, side=side).items():
            out[k] = out.get(k, 0) + v
    return out


def data_gathers(hlo):
    # operand bytes a chip of the all-gathers along "data" by what they
    # gather: "weights" (float operands of rank 2: weight blocks; the
    # routing's sorted ids (G, N) told apart by their op, top_k or sort),
    # "rows" (float operands of rank 3 or more: activations, the router's
    # probabilities), "ids" (integer operands: tokens, routing ids)
    kinds = []
    for l in hlo.splitlines():
        m = _COLLECTIVE_RE.search(l)
        kind = None
        if m and m.group(3) == "all-gather" and axis(l) == "data":
            shape = re.match(r"([a-z]+)\d*\[([0-9,]*)\]", m.group(2) or "")
            if shape and shape.group(1) in ("s", "u", "pred"):
                kind = "ids"
            elif shape and shape.group(2).count(",") == 1 and \
                    "top_k" not in l and "sort" not in l:
                kind = "weights"
            else:
                kind = "rows"
        kinds.append(kind if m else "")
    out = {}
    for want in ("weights", "rows", "ids"):
        keep = "\n".join(l for l, k in zip(hlo.splitlines(), kinds)
                         if k in ("", want))
        out[want] = collective_bytes(keep).get("all-gather", 0)
    return out


def weight_gathers(hlo):
    return data_gathers(hlo)["weights"]


def reduce_then_slice(hlo):
    # the all-reduces along "data" of tensors of rank 2 or more: how many
    # outputs, and how many of them a dynamic-slice reads (itself, or
    # inside the fusion that reads them): a reduce-scatter written as an
    # all-reduce and a slice
    bodies, cur = {}, None
    for l in hlo.splitlines():
        h = re.match(r"^(?:ENTRY )?(%[^ ]+) \(.*\{\s*$", l)
        if h:
            cur = h.group(1)
            bodies[cur] = []
        elif cur:
            bodies[cur].append(l)
    users = {}
    for l in hlo.splitlines():
        for v in re.findall(r"[(,] ?(%[\w.\-]+)(?=[,)])",
                            l.split(" = ", 1)[-1]):
            users.setdefault(v, []).append(l)
    outputs = sliced = 0
    for l in hlo.splitlines():
        m = _COLLECTIVE_RE.search(l)
        if not m or m.group(3) != "all-reduce" or axis(l) != "data":
            continue
        name = l.strip().split(" = ")[0]
        for i, dims in enumerate(re.findall(r"\[([0-9,]*)\]",
                                            m.group(1) or m.group(2))):
            if "," not in dims:
                continue
            outputs += 1
            vals = [name]
            if m.group(1):
                vals = [u.strip().split(" = ")[0] for u in users.get(name, [])
                        if "get-tuple-element(" in u
                        and re.search(r"index=%d\b" % i, u)]
            reads = [u for v in vals for u in users.get(v, [])]
            calls = [re.search(r"calls=(%[\w.\-]+)", u) for u in reads]
            if any(" dynamic-slice(" in u for u in reads) or any(
                    "dynamic-slice(" in "\n".join(bodies.get(c.group(1), []))
                    for c in calls if c):
                sliced += 1
    return {"outputs": outputs, "sliced": sliced}
'''

_CHILD = HLO_AXES + r'''
import json, sys
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.config.base import MoEConfig, TrainConfig, TransformerConfig
from repro.distrib.sharding import lm_param_specs, state_specs_like
from repro.models.transformer import TransformerLM
from repro.train.state import make_train_step, new_train_state

args = json.loads(open(sys.argv[1]).read())
steps = {}
for i, case in enumerate(args["cases"]):
    D, MODEL = case["mesh"]
    mesh = Mesh(np.array(jax.devices()[:D * MODEL]).reshape(D, MODEL),
                ("data", "model"))
    ns = lambda s: NamedSharding(mesh, s)
    bs = ns(P("data", None))
    kw = dict(case["cfg"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    cfg = TransformerConfig(**kw)
    model = TransformerLM(cfg, moe_group_size=case["group"],
                          act_spec=P("data", None, None))
    state = new_train_state(model.init(jax.random.PRNGKey(0)))
    key = json.dumps([case["cfg"], case["group"], case["micro"],
                      case["mesh"]])
    if key not in steps:
        specs = state_specs_like(lm_param_specs(state.params, cfg, "tp2d"))
        steps[key] = jax.jit(
            make_train_step(model.loss, TrainConfig(**args["tcfg"]),
                            microbatches=case["micro"]),
            in_shardings=(jax.tree.map(ns, specs), bs, bs))
    step = steps[key]
    out = {}
    if case["hlo"]:
        tokens, labels = (jnp.asarray(np.array(t, np.int32))
                          for t in case["batches"][0])
        with mesh:
            hlo = step.lower(state, tokens, labels).compile().as_text()
        out.update(kinds=read_hlo(hlo), gathers=data_gathers(hlo),
                   slices=reduce_then_slice(hlo),
                   lookup=lookup_collectives(hlo, *LM_LOOKUP))
    if not case["batches"][1:]:             # the HLO alone
        print(f"CASE {i} " + json.dumps(out), flush=True)
        continue
    metrics = []
    with mesh:
        for tokens, labels in case["batches"]:
            state, m = step(state, jnp.asarray(np.array(tokens, np.int32)),
                            jnp.asarray(np.array(labels, np.int32)))
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    out["metrics"] = metrics
    leaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = ":".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        leaves[key] = np.asarray(leaf, np.float32)
    np.savez(case["out"], **leaves)
    print(f"CASE {i} " + json.dumps(out), flush=True)
'''

# the reference runs of this file, one child process for all of them: the
# ``tp2d`` step for both ``moe_shard`` values (group 16, its HLO read, at
# 2 microbatches and, HLO alone, at 1) and fault 8's groups across the
# batch shards (group 64, both row kinds) on 2 x 2; the HLO alone at 1
# microbatch on 4 x 4 and 1 x 4 (16 host devices)
REFERENCE_CASES = ([("expert", 16, "random"), ("ffn", 16, "random")]
                   + [(ms, 64, rows) for ms in ("expert", "ffn")
                      for rows in ("same", "random")]
                   + [("expert", 16, "hlo-m1"), ("ffn", 16, "hlo-m1")]
                   + [("expert", 16, "hlo-4x4"), ("expert", 16, "hlo-1x4")])
HLO_MESH = {"hlo-4x4": (4, 4), "hlo-1x4": (1, 4)}


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    "(moe_shard, group, rows) → (the child's output, its leaves' file)."
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("tp2d_reference")
    cases = []
    for moe_shard, group, rows in REFERENCE_CASES:
        cfg = _moe_shard(MOE16, moe_shard)
        batches = _batches(cfg)
        if rows == "same":
            batches = _same_rows(batches)
        hlo_alone = rows.startswith("hlo-")
        if hlo_alone:
            batches = batches[:1]
        cases.append({"cfg": dataclasses.asdict(cfg),
                      "mesh": HLO_MESH.get(rows, (2, 2)),
                      "micro": 1 if hlo_alone else 2,
                      "group": group, "hlo": group == 16,
                      "out": str(tmp / f"{moe_shard}_{group}_{rows}.npz"),
                      "batches": [[t.tolist() for t in b] for b in batches]})
    payload = tmp / "cases.json"
    payload.write_text(json.dumps({"cases": cases, "tcfg": {
        k: getattr(TCFG, k) for k in ("learning_rate", "warmup_steps",
                                      "total_steps")}}))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_CHILD),
                          str(payload)], env=env, capture_output=True,
                         text=True, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    outs = {}
    for line in res.stdout.splitlines():
        if line.startswith("CASE "):
            i, body = line[5:].split(" ", 1)
            outs[REFERENCE_CASES[int(i)]] = (json.loads(body),
                                             cases[int(i)]["out"])
    assert len(outs) == len(REFERENCE_CASES), res.stdout[-2000:]
    return outs


def _leaves_against_reference(state, path):
    "Every leaf of the mesh state against the reference's saved ones."
    from test_torch_train import _leaves_ref_layout
    whole = {k: gather(v) if isinstance(v, ShardedTensor) else v
             for k, v in state.params.items() if k != "layers"}
    whole["layers"] = [{k: (gather(v) if isinstance(v, ShardedTensor)
                            else {n: gather(t) for n, t in v.items()})
                        for k, v in lay.items()}
                       for lay in state.params["layers"]]
    got = _leaves_ref_layout(whole)
    ref = np.load(path)
    flips = 2 * TCFG.learning_rate * N_STEPS
    assert sorted(k.replace(":", "/") for k in ref.files) == sorted(got)
    for key in ref.files:
        np.testing.assert_allclose(got[key.replace(":", "/")], ref[key],
                                   rtol=1e-4, atol=flips)


def _reference_params(cfg):
    "The reference's initial weights (its PRNG key 0) as the port's."
    import jax
    from repro.models.transformer import TransformerLM as RLM
    from repro_torch.models.transformer import params_from_jax
    from test_torch_lm import _jax_cfg
    rparams = RLM(_jax_cfg(cfg)).init(jax.random.PRNGKey(0))
    return params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, rparams),
                           device="cpu", dtype=torch.float32)


def _by_axis(mesh, moves):
    """A step's bytes by ``"name axis"``: each move's source and receiver
    along "data" (one "model" coordinate), "model" or "both"."""
    out = {}
    for (name, frm, to), n in moves.items():
        a, b = mesh.coords(frm), mesh.coords(to)
        ax = ("data" if a["model"] == b["model"] else
              "model" if a["data"] == b["data"] else "both")
        out[f"{name} {ax}"] = out.get(f"{name} {ax}", 0) + n
    return dict(sorted(out.items()))


# the port's lookup collectives by the HLO collective each stands for;
# its own re-layouts, which the reference does not run, stand for none
LOOKUP_KINDS = {"emb_ids_permute": "collective-permute",
                "emb_ids_gather": "all-gather",
                "emb_rows_model": "all-reduce",
                "emb_rows_data": "all-to-all",
                "emb_grad_data": "all-to-all",
                "emb_rows_fold": "all-reduce",
                "emb_rows_permute": "collective-permute",
                "emb_grad_permute": "collective-permute",
                "emb_grad_gather": "all-gather"}
PORT_ONLY_LOOKUP = {"emb_rows_relayout", "emb_rows_home", "emb_grad_home",
                    "emb_ids_home"}


def _axis_of(mesh, ends):
    """The mesh axes on which the (source, receiver) pairs ``ends``
    differ: "data", "model" or "both"."""
    axes = {x for frm, to in ends for x in ("data", "model")
            if mesh.coords(frm)[x] != mesh.coords(to)[x]}
    return axes.pop() if len(axes) == 1 else "both"


def lookup_by_kind(mesh, moves, kinds=None, own_names=None):
    """The port's lookup bytes by ``"kind axis"`` a chip, in the units in
    which ``lookup_collectives`` reads the HLO's (``collective_bytes``'
    operand bytes a chip): each move of a lookup collective by the HLO
    collective it stands for and the axis its ends differ on (an
    all-reduce's: the axes its moves of that name span, its group), the
    most one position receives, over what a position receives of one
    operand in a group of G along that axis (both axes: every position):
    G − 1 operands of an all-gather (each member's contribution; G one
    more than the most members a position receives from, as a gather in
    groups shorter than the axis has) and of an all-to-all (one piece from
    each other member), 2(G − 1)/G of an all-reduce's (its reduce-scatter
    and all-gather), one of a collective-permute's (its axis, as an
    all-reduce's, the span of all its pairs). (The HLO's operand bytes
    count a collective-permute's pairs from a device to itself; those
    positions move nothing.) Moves of any other name are left out, the
    port's own moves apart: (by kind, theirs by name). ``kinds`` and
    ``own_names`` name other collectives and own moves than the lookup's
    (``HEAD_KINDS``, ``HEAD_OWN``)."""
    kinds = LOOKUP_KINDS if kinds is None else kinds
    own_names = PORT_ONLY_LOOKUP if own_names is None else own_names
    got, own, senders = {}, {}, {}
    group = {name: _axis_of(mesh, [(f, t) for (m, f, t) in moves
                                   if m == name])
             for name, kind in kinds.items()
             if kind in ("all-reduce", "collective-permute")
             and any(m == name for m, _, _ in moves)}
    for (name, frm, to), n in moves.items():
        if name in own_names:
            own[name] = own.get(name, 0) + n
        if name not in kinds:
            continue
        ax = group.get(name) or _axis_of(mesh, [(frm, to)])
        at = got.setdefault((kinds[name], ax), {})
        at[to] = at.get(to, 0) + n
        senders.setdefault((kinds[name], ax, to), set()).add(frm)
    out = {}
    for (kind, ax), at in sorted(got.items()):
        G = mesh.axis_size(ax) if ax != "both" else mesh.size
        if kind == "all-gather":
            G = 1 + max(len(f) for (k, a, _), f in senders.items()
                        if (k, a) == (kind, ax))
        per = {"all-gather": G - 1, "all-to-all": G - 1,
               "all-reduce": Fraction(2 * (G - 1), G),
               "collective-permute": 1}[kind]
        n = Fraction(max(at.values())) / per
        assert n.denominator == 1, (kind, ax, max(at.values()), G)
        out[f"{kind} {ax}"] = int(n)
    return out, own


# the head's collectives where it stays where it lies
# (``collectives.vocab_parallel_xent``, ``head_logits``), forward and
# backward, by the HLO collective each stands for; the port's own moves
# apart
HEAD_FWD = {"head_rows_gather": "all-gather",
            "head_rows_permute": "collective-permute",
            "head_stats": "all-reduce"}
HEAD_BWD = {"head_grad_data": "all-reduce", "head_grad_model": "all-reduce",
            "head_block_permute": "collective-permute",
            "head_wgrad_permute": "collective-permute"}
HEAD_OWN = {"head_rows_home", "head_labels", "head_target", "head_scale",
            "head_grad_relayout"}


def head_by_kind(mesh, moves):
    """The port's head bytes a chip by ``"kind axis"``, forward and
    backward apart (:func:`lookup_by_kind` of ``HEAD_FWD``, ``HEAD_BWD``),
    and its own moves by name."""
    fwd, own = lookup_by_kind(mesh, moves, HEAD_FWD, HEAD_OWN)
    bwd, _ = lookup_by_kind(mesh, moves, HEAD_BWD, ())
    return fwd, bwd, own


# the lookup's reference cases: (moe_shard, microbatches, mesh)
LOOKUP_CASES = [("expert", 1, (2, 2)), ("expert", 2, (2, 2)),
                ("ffn", 1, (2, 2)), ("ffn", 2, (2, 2)),
                ("expert", 1, (4, 4)), ("expert", 1, (1, 4))]


@pytest.mark.parametrize("moe_shard,micro,shape", LOOKUP_CASES,
                         ids=[f"{ms}-{m}-{d}x{n}"
                              for ms, m, (d, n) in LOOKUP_CASES])
def test_tp2d_lookup_moves_as_the_reference(reference_runs, moe_shard,
                                            micro, shape):
    """The train step's lookup against the reference's jitted step
    (qwen3-moe SMOKE, 16 experts, 8 × 16 tokens) on the 2 × 2 mesh at 1
    and 2 microbatches, and on 4 × 4 and 1 × 4 at 1: the port's lookup
    bytes a step by kind and axis a chip (:func:`lookup_by_kind`) equal,
    to the byte, the HLO's collectives of the embedding's gather and its
    transpose (the child's ``lookup_collectives``): the ids'
    collective-permute between the off-diagonal positions and all-gather
    along "model", the partial rows' all-reduce over "model", and the
    all-to-all along "data" of the rows and of their gradients; on 1 × 4
    the all-reduce alone."""
    cfg = _moe_shard(MOE16, moe_shard)
    rows = ("random" if micro == 2 else
            next((k for k, v in HLO_MESH.items() if v == shape), "hlo-m1"))
    read, _ = reference_runs[(moe_shard, 16, rows)]
    moves = []
    _run(cfg, shape, micro, P("data", None), steps=1, reference=False,
         moves=moves)
    got, own = lookup_by_kind(_mesh(shape), moves[0])
    print(f"\nlookup ({moe_shard}, {micro} microbatch(es), {shape}): "
          f"reference HLO {read['lookup']}; the port {got}")
    assert got == read["lookup"]
    assert set(read["lookup"]) == (
        {"all-reduce model"} if shape[0] == 1 else
        {"collective-permute both", "all-gather model", "all-reduce model",
         "all-to-all data"})
    assert not own


@pytest.mark.parametrize("shape,B,S", [((16, 16), 256, 4096),
                                       ((2, 4), 8, 64), ((4, 2), 8, 64)],
                         ids=["16x16", "2x4", "4x2"])
def test_tp2d_lookup_bytes_by_chip_smoke_formula(shape, B, S):
    """The train step's lookup, forward and backward, of smollm-135m's
    table (49,152 × 576, rows in bf16) on a meta mesh: on the production
    16 × 16 at train_4k's one microbatch of 256 × 4,096 tokens split over
    "data", and on two meshes that are not square (the ids gathered along
    "data"): its bytes equal ``chip_smoke.lookup_want``'s to the byte, the
    fold over "model" 2(M − 1)/M of the partial rows into each position."""
    import chip_smoke
    D, M = shape
    mesh = Mesh(shape, ("data", "model"), ["meta"] * (D * M))
    placed = device_put(torch.empty((49152, 576), device="meta"), mesh,
                        P("model", "data"))
    view = TPView(placed, batch_groups(mesh, "data")[1])
    ids = [torch.empty((B // D, S), dtype=torch.int32, device="meta")
           for _ in range(D)]
    got = view.take_rows(Rows([ids[view.shard[p]] for p in range(mesh.size)],
                              list(range(mesh.size)), mesh), torch.bfloat16)
    seeds = [p for p in range(mesh.size) if view.collects(p)]
    torch.autograd.backward([got.parts[p] for p in seeds],
                            [torch.empty_like(got.parts[p]) for p in seeds])
    assert dict(mesh.bytes) == chip_smoke.lookup_want(
        shape, placed.layout.counts, B // D * S, 576, 2, 4, "train")


@pytest.mark.parametrize("moe_shard", ["expert", "ffn"])
def test_tp2d_step_matches_the_reference_jitted_step(reference_runs,
                                                     moe_shard):
    """The reference's jitted step under a 2 × 2 JAX mesh with the ``tp2d``
    ``in_shardings`` (XLA's partitioner places each product) against the
    port's ``make_tp2d_train_step`` on 2 × 2, the qwen3-moe SMOKE model
    with 16 experts split over "model" (``moe_shard="expert"``) or their
    d_ff split (``"ffn"``), 2 steps of 2 microbatches, each split over
    "data", one set of weights: losses, grad norms and every leaf to rtol
    1e-4. The child reads its compiled HLO's collective bytes by kind and
    the axis of their groups: its weight all-gathers run along "data" and
    its activation all-reduces along "model", as the port's gathers and
    sums do; both printed (``-s``) by name and axis.

    The port gathers each weight once a microbatch (its ``tp_zero_gather``
    as :func:`tp2d_step_bytes` counts it). The HLO gathers each attention
    weight's block twice a microbatch (the forward's product and the
    backward's), never the router or the head, whose products take the
    rows instead (the head's input rows and the router's probabilities,
    gathered along "data"); each kind is held to its own count. Only at
    these widths do the totals agree: the port's a position equals the
    HLO's float all-gathers along "data" a chip (122,880 B). Its weights'
    gradients along "data" are all-reduced and then dynamic-sliced to each
    chip's block (the CPU pipeline forms no reduce-scatter), where the
    port reduce-scatters (``tp_zero_scatter``)."""
    cfg = _moe_shard(MOE16, moe_shard)
    micro = 2
    batches = _batches(cfg)
    read, out = reference_runs[(moe_shard, 16, "random")]
    want = read["metrics"]
    hlo, gathers, slices = read["kinds"], read["gathers"], read["slices"]
    assert hlo.get("all-gather data", 0) > 0
    assert hlo.get("all-reduce model", 0) > 0
    # the attention weights' blocks (f32, whole along "data" at each of
    # the 2 x 2 positions), forward and backward, every microbatch
    attn = 4 * (2 * cfg.d_model * cfg.n_heads * cfg.head_dim
                + 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim) // 4
    assert gathers["weights"] == 2 * micro * cfg.n_layers * attn, gathers
    assert slices["sliced"] >= 4 and "reduce-scatter data" not in hlo
    params = _reference_params(cfg)
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None))
    mesh = _mesh((2, 2))
    specs = state_specs_like(lm_param_specs(params, cfg, "tp2d"))
    state = new_sharded_train_state(params, mesh, specs)
    step = make_tp2d_train_step(model.loss, TCFG, mesh, specs,
                                P("data", None), microbatches=micro)
    for i, (b, (loss, gnorm)) in enumerate(zip(batches, want)):
        mesh.reset_bytes()
        state, m = step(state, *b)
        assert float(m["loss"]) == pytest.approx(loss, rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(gnorm, rel=1e-4)
        if i == 0:
            print(f"\nreference HLO ({moe_shard}), bytes a chip by kind and "
                  f"axis: {hlo}; all-gathers along \"data\" by what they "
                  f"gather: {gathers}; gradients all-reduced along "
                  f"\"data\", then sliced: {slices}\nthe port's step, bytes "
                  f"by name and axis: {_by_axis(mesh, mesh.moves)}")
            assert not set(mesh.bytes) & (GATHERS | STATIONARY)
            # each side by what it gathers: the port every weight's
            # "model" block once a microbatch (the formula) ...
            port = mesh.bytes["tp_zero_gather"]
            assert port == tp2d_step_bytes(cfg, (2, 2), micro)[
                "tp_zero_gather"]
            # ... the HLO, besides the attention blocks above, a chip's
            # rows: each microbatch's head input and each layer's router
            # probabilities
            R = 8 // micro // 2 * 16
            assert gathers["rows"] == micro * 4 * R * (
                cfg.d_model + cfg.n_layers * cfg.moe.n_experts)
            # the totals agree at these SMOKE widths only: the HLO gathers
            # rows where the port gathers the router's and the head's
            # weights, so at other widths they differ
            assert port // 4 == gathers["weights"] + gathers["rows"] \
                == 122_880
            assert "norm_gather" not in mesh.bytes
    _leaves_against_reference(state, out)


@pytest.mark.parametrize("rows", ["same", "random"])
@pytest.mark.parametrize("moe_shard", ["expert", "ffn"])
def test_tp2d_group_across_batch_shards_matches_the_reference(
        reference_runs, moe_shard, rows):
    """Fault 8 against the reference's jitted ``tp2d`` step (the same
    child): a MoE group of 64 tokens over the 2 shards of 32 of each
    microbatch, routed once over them, 2 steps on 2 × 2 from the
    reference's weights; losses, grad norms and every leaf to rtol
    1e-4."""
    cfg = _moe_shard(MOE16, moe_shard)
    batches = _batches(cfg)
    if rows == "same":
        batches = _same_rows(batches)
    read, out = reference_runs[(moe_shard, 64, rows)]
    params = _reference_params(cfg)
    model = TransformerLM(cfg, moe_group_size=64,
                          act_spec=P("data", None, None))
    mesh = _mesh((2, 2))
    specs = state_specs_like(lm_param_specs(params, cfg, "tp2d"))
    state = new_sharded_train_state(params, mesh, specs)
    step = make_tp2d_train_step(model.loss, TCFG, mesh, specs,
                                P("data", None), microbatches=2)
    for b, (loss, gnorm) in zip(batches, read["metrics"]):
        state, m = step(state, *b)
        assert float(m["loss"]) == pytest.approx(loss, rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(gnorm, rel=1e-4)
    assert mesh.bytes["moe_group_probs_grad"] > 0
    _leaves_against_reference(state, out)
