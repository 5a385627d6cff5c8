"""The sharded LM train step (``train.state.make_sharded_train_step``),
expert parallelism in ``moe_block`` and the LM cells' shardings, on the
CPU (meshes of ``["cpu"] * 4``).

Bitwise wherever the step's sums run in ``make_train_step``'s order: with
one batch shard (D = 1), or one microbatch per batch shard (M / D = 1),
losses, grad norms and every gathered leaf equal the unsharded step's.
Where M / D > 1 the gradient sums run in another order, and the test
holds the step to ``test_torch_train.py``'s tolerances for the port
against JAX: losses and grad norms to rtol 1e-4, parameters within 1e-4
relative plus 2·lr per step absolute. Where D / M > 1 (the reference
cell's one microbatch, its rows over the batch shards) the loss's sums and
the MoE aux statistics cross the homes: within 1e-5 of the unsharded step
at the same M, and within 1e-4 of the reference's jitted cell step under
the ``fsdp`` specs (a child process with four host devices), labels
masked in one shard and one shard's rows all row 0's included, which the
parent's one-microbatch-a-shard step gets wrong by more than rounding; a
MoE group that spans the shards runs at its first home, bitwise the
unsharded step. ``moe_block`` with its experts on
other mesh positions is bitwise the unsharded block, forward and
backward. The host-mesh step with ``act_spec`` is held against the
reference's step of that model under a one-device mesh to the same
tolerances. The table, split along its rows, is looked up where the rows
lie: its rows bitwise ``take_rows``, its gradient in one device's order,
and its collectives a chip by kind and axis equal to the reference's
jitted ``fsdp`` step's compiled HLO (a child with eight host devices).
The JAX package is imported only inside the tests that need it, so the
card tests (``cuda`` marker) run where JAX is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config.base import TrainConfig, TransformerConfig
from repro_torch.config.registry import get_arch
from repro_torch.configs import qwen3_moe_30b_a3b as qcfg
from repro_torch.data.lm import TokenPipeline
from repro_torch.distrib.collectives import Blocks
from repro_torch.distrib.fault import reshard
from repro_torch.distrib.sharding import (P, ShardedTensor, gather,
                                          lm_param_specs, state_specs_like)
from repro_torch.launch.cells import build_cell, input_specs
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import moe as TM
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.compression import compress_grads, compression_init
from repro_torch.train.state import (load_stacked, make_sharded_train_step,
                                     make_train_step,
                                     new_sharded_train_state,
                                     new_train_state, stack_layers)

torch.set_num_threads(1)

CPU4 = ["cpu"] * 4
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
N_STEPS = 3
DENSE = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=128, dtype="float32",
                          remat="none")
# the SMOKE MoE with 16 experts: the rules' production "model" size (16)
# divides E, so the experts shard over "model" (8 experts replicate)
MOE16 = dataclasses.replace(
    qcfg.SMOKE, moe=dataclasses.replace(qcfg.SMOKE.moe, n_experts=16))
MODELS = {"qwen3-moe-smoke": qcfg.SMOKE, "dense-smoke": DENSE,
          "qwen3-moe-smoke-e16": MOE16}


def _batches(cfg, n=N_STEPS, B=4, S=16):
    pipe = TokenPipeline(cfg.vocab_size, B, S, seed=0)
    return [[torch.as_tensor(a) for a in pipe.batch_at(i)] for i in range(n)]


def _run(cfg, mesh, micro, act_spec=None, batches=None, steps=N_STEPS,
         group=16, nbytes=None):
    """(unsharded losses+norms, sharded losses+norms, unsharded state,
    sharded state) over ``steps`` steps from one seed; each mesh step's
    bytes appended to ``nbytes`` when it is a list."""
    model = TransformerLM(cfg, moe_group_size=group, act_spec=act_spec)
    batches = batches or _batches(cfg, steps)
    ref = new_train_state(model.init(torch.Generator().manual_seed(0),
                                     dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    specs = state_specs_like(lm_param_specs(params, cfg, "fsdp"))
    state = new_sharded_train_state(params, mesh, specs)
    ref_step = make_train_step(model.loss, TCFG, microbatches=micro)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=micro,
                                   moe_span=model.moe_span)
    want, got = [], []
    for b in batches[:steps]:
        ref, rm = ref_step(ref, *b)
        mesh.reset_bytes()
        state, m = step(state, *b)
        if nbytes is not None:
            nbytes.append(dict(mesh.bytes))
        want.append((float(rm["loss"]), float(rm["grad_norm"]),
                     float(rm["lr"])))
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    float(m["lr"])))
    return want, got, ref, state


def _assert_state_equal(ref, state):
    for a, b in zip(tree_leaves(ref), tree_leaves(state)):
        whole = gather(b) if isinstance(b, ShardedTensor) else b
        assert torch.equal(a, whole)
        assert a.dtype == whole.dtype


# -- expert parallelism in moe_block -------------------------------------------

@pytest.mark.parametrize("n_model,E,k,G", [(2, 8, 2, 2), (4, 8, 2, 1),
                                          (4, 16, 4, 4)])
def test_moe_block_with_exp_spec_is_bitwise_the_unsharded_block(n_model, E,
                                                                k, G):
    """Experts on ``n_model`` other mesh positions (the dispatch buffer's
    E slices sent there, the outputs sent back): y and aux bitwise,
    and the gradients of x, the router and every expert block bitwise
    the unsharded block's (a block's gradient is its slice)."""
    from repro_torch.config.base import MoEConfig
    cfg = MoEConfig(n_experts=E, top_k=k, d_ff_expert=24)
    g = torch.Generator().manual_seed(E + k)
    params = TM.init_moe_params(g, cfg, 16)
    x = torch.randn((G * 24, 16), generator=g)
    dy = torch.randn((G * 24, 16), generator=g)

    def run(wrap):
        xs = x.clone().requires_grad_(True)
        ps = {n: t.clone().requires_grad_(True) for n, t in params.items()}
        y, aux = TM.moe_block(xs, wrap(ps), cfg, G)
        (y * dy).sum().add(aux).backward()
        return y.detach(), aux.detach(), xs.grad, ps

    y0, a0, gx0, p0 = run(lambda ps: ps)
    mesh = Mesh((1, n_model), ("data", "model"), ["cpu"] * n_model)
    blocks = {}

    def wrap(ps):
        out = {"router": ps["router"]}
        for n in ("wg", "wu", "wd"):
            parts = [t.detach().clone().requires_grad_(True)
                     for t in ps[n].chunk(n_model)]
            blocks[n] = parts
            out[n] = Blocks(parts, list(range(n_model)), 0, mesh)
        return out
    y1, a1, gx1, p1 = run(wrap)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert torch.equal(gx0, gx1)
    assert torch.equal(p0["router"].grad, p1["router"].grad)
    for n in ("wg", "wu", "wd"):
        for part, want in zip(blocks[n], p0[n].grad.chunk(n_model)):
            assert torch.equal(part.grad, want), n
    assert mesh.bytes["expert_send"] > 0


# -- the sharded step ------------------------------------------------------------

@pytest.mark.parametrize("shape,micro", [((2, 2), 2), ((1, 4), 2),
                                         ((1, 4), 1), ((4, 1), 4)])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_sharded_step_is_bitwise_the_unsharded_step(name, shape, micro):
    cfg = MODELS[name]
    mesh = Mesh(shape, ("data", "model"), CPU4)
    want, got, ref, state = _run(cfg, mesh, micro)
    assert got == want
    _assert_state_equal(ref, state)
    assert int(state.opt.step.shards[0]) == N_STEPS


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sharded_step_with_two_microbatches_per_batch_shard(name):
    """M / D = 2: each batch shard adds its two microbatches, then the
    shards add: another order than the unsharded step's."""
    cfg = MODELS[name]
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    want, got, ref, state = _run(cfg, mesh, 4)
    for (l0, n0, lr0), (l1, n1, lr1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=1e-4)
        assert n1 == pytest.approx(n0, rel=1e-4)
        assert lr1 == lr0
    flips = 2 * TCFG.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), tree_leaves(state.params)):
        np.testing.assert_allclose(gather(b).numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)


def _within_flips(want, got, ref, state):
    """Losses and grad norms within rel 1e-4 of the unsharded step's, lr
    equal, every leaf within rtol 1e-4 and atol 2 · lr · steps
    (``test_sharded_step_with_two_microbatches_per_batch_shard``'s
    form)."""
    _close_to(want, got, 1e-4)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), tree_leaves(state.params)):
        np.testing.assert_allclose(gather(b).numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_expert_parallel_step_is_bitwise_the_unsharded_step(shape):
    """``act_spec`` on the 16-expert SMOKE model: the experts stay on
    their "model" shard and the loss takes the vocab-parallel cross
    entropy over the head's blocks where they lie (the reference's form:
    the log-sum-exp folded over several blocks, the dX partials summed
    over them), so the step is no longer the unsharded step's bits but
    within its rounding (the form of
    ``test_sharded_step_with_two_microbatches_per_batch_shard``); on one
    block it is (``test_vocab_parallel_head_one_block_is_the_plain_loss``).
    """
    mesh = Mesh(shape, ("data", "model"), CPU4)
    want, got, ref, state = _run(MOE16, mesh, 2,
                                 act_spec=P("data", None, None))
    _within_flips(want, got, ref, state)
    assert mesh.bytes["expert_send"] > 0


@pytest.mark.parametrize("name", ["moe16", "smollm", "dense"])
@pytest.mark.parametrize("micro", [1, 2])
def test_vocab_parallel_head_one_block_is_the_plain_loss(name, micro):
    """The head where its blocks lie (``collectives.vocab_parallel_xent``)
    with one block, on a mesh of one position with ``act_spec``: the fold
    of one block's statistics is ``torch.logsumexp``'s own, so the step is
    the unsharded step bit for bit (losses, grad norms, every leaf), the
    tied table's two gradients included (smollm)."""
    cfg = {"moe16": MOE16, "smollm": SMOL, "dense": DENSE}[name]
    mesh = Mesh((1, 1), ("data", "model"), ["cpu"])
    want, got, ref, state = _run(cfg, mesh, micro,
                                 act_spec=P("data", None, None))
    assert got == want
    _assert_state_equal(ref, state)
    assert not any(k.startswith("head_") for k in mesh.bytes)


# -- the reference cell's one microbatch, its rows over the batch shards -----------

def _close_to(want, got, rtol):
    for (l0, n0, lr0), (l1, n1, lr1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=rtol)
        assert n1 == pytest.approx(n0, rel=rtol)
        assert lr1 == lr0


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 1), (4, 1)],
                         ids=["1x1", "2x2", "2x1", "4x1"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_microbatch_over_the_batch_shards(name, shape):
    """M = 1, the reference cell's step, with D = 2 or 4 batch shards: one
    forward over the shards' homes, each on its own rows, the loss the
    batch's mean (each home's cross entropy sum and count added over the
    homes, ``loss_sum``: two 4-byte scalars from each other home) and the
    MoE aux loss over all the groups (``moe_aux_sum``: E f32 means and E
    int32 counts a layer from each other home). Loss and grad norm within
    1e-5 of ``make_train_step`` at M = 1, every leaf after 3 steps within
    rtol 1e-4, atol 2 · lr · steps; each home gathers each layer once, the
    ``all_gather`` bytes of the M = D step. On one position bit for
    bit."""
    cfg = MODELS[name]
    n = shape[0] * shape[1]
    mesh = Mesh(shape, ("data", "model"), CPU4[:n])
    nbytes = []
    want, got, ref, state = _run(cfg, mesh, 1, nbytes=nbytes)
    if n == 1:
        assert got == want
        _assert_state_equal(ref, state)
        return
    _close_to(want, got, 1e-5)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for a, b in zip(tree_leaves(ref.params), tree_leaves(state.params)):
        np.testing.assert_allclose(gather(b).numpy(), a.numpy(), rtol=1e-4,
                                   atol=flips)
    D = shape[0]
    per_d = []
    _run(cfg, Mesh(shape, ("data", "model"), CPU4[:n]), D, steps=1,
         nbytes=per_d)
    L = cfg.n_layers
    E = cfg.moe.n_experts if cfg.moe else 0
    for step in nbytes:
        assert step["all_gather"] == per_d[0]["all_gather"]
        assert step["loss_sum"] == D * (D - 1) * 8
        assert step.get("moe_aux_sum", 0) == L * D * (D - 1) * 8 * E
        assert "train_span" not in step
    assert "loss_sum" not in per_d[0]


@pytest.mark.parametrize("shape,micro", [((2, 2), 1), ((2, 1), 1),
                                         ((4, 1), 1), ((4, 1), 2)],
                         ids=["2x2-M1", "2x1-M1", "4x1-M1", "4x1-M2"])
def test_group_across_batch_shards_runs_at_its_first_home(shape, micro):
    """A MoE group that spans the batch shards of a microbatch
    (``moe_group_size`` 64; shards of 32 or 16 tokens): the shards it spans
    are computed at the first one's home over all their rows, the others'
    rows sent there (``train_span``), so the step is ``make_train_step``'s
    at the same M bit for bit without ``act_spec``; with it the head's
    blocks stay where they lie (the log-sum-exp folded over the blocks),
    and the step is within the unsharded step's rounding
    (:func:`_within_flips`)."""
    n = shape[0] * shape[1]
    for act in (None, P("data", None, None)):
        mesh = Mesh(shape, ("data", "model"), CPU4[:n])
        nbytes = []
        want, got, ref, state = _run(MOE16, mesh, micro, act_spec=act,
                                     group=64, nbytes=nbytes)
        if act is None:
            assert got == want
            _assert_state_equal(ref, state)
        else:
            _within_flips(want, got, ref, state)
        rows = 4 // shape[0]                 # a shard's rows of B = 4
        others = shape[0] - micro            # shards whose rows move
        assert all(st["train_span"] == others * rows * 16 * 4 * 2
                   for st in nbytes)
        assert "loss_sum" not in nbytes[0]


@pytest.mark.parametrize("D,M", [(2, 3), (4, 3), (4, 6)])
def test_microbatches_that_neither_split_nor_gather_shards_raise(D, M):
    """M must divide by D or D by M; otherwise the step refuses, naming
    both."""
    model = TransformerLM(DENSE)
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    specs = state_specs_like(lm_param_specs(params, DENSE, "fsdp"))
    mesh = Mesh((D, 4 // D), ("data", "model"), CPU4)
    with pytest.raises(ValueError, match=f"{M} microbatches do not split "
                                         f"over {D} batch shards"):
        make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                P("data", None), microbatches=M)


_REF_CHILD = r'''
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.config.base import MoEConfig, TrainConfig, TransformerConfig
from repro.distrib.sharding import lm_param_specs, state_specs_like
from repro.models.transformer import TransformerLM
from repro.train.state import make_train_step, new_train_state

args = json.loads(open(sys.argv[1]).read())
kw = dict(args["cfg"])
kw["moe"] = MoEConfig(**kw["moe"]) if kw.get("moe") else None
cfg = TransformerConfig(**kw)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
ns = lambda s: NamedSharding(mesh, s)
bs = ns(P("data", None))
model = TransformerLM(cfg, moe_group_size=args["group"],
                      act_spec=P("data", None, None))
params = model.init(jax.random.PRNGKey(0))
specs = state_specs_like(lm_param_specs(params, cfg, "fsdp"))
step = jax.jit(make_train_step(model.loss, TrainConfig(**args["tcfg"])),
               in_shardings=(jax.tree.map(ns, specs), bs, bs))
for i, case in enumerate(args["cases"]):
    state = new_train_state(params)
    metrics = []
    with mesh:
        for tokens, labels in case["batches"]:
            state, m = step(state, jnp.asarray(np.array(tokens, np.int32)),
                            jnp.asarray(np.array(labels, np.int32)))
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    leaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = ":".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        leaves[key] = np.asarray(leaf, np.float32)
    np.savez(case["out"], **leaves)
    print(f"CASE {i} " + json.dumps(metrics), flush=True)
'''

# the reference cell's step on the fsdp specs against the port's: random
# batches, and two that a mean of per-shard means gets wrong
FSDP_CASES = ("random", "masked", "skewed")


def _fsdp_batches(kind):
    """``_batches(MOE16)`` with, for "masked", labels −1 past position 4 in
    batch shard 1's rows (2 and 3) only, and for "skewed", shard 1's rows
    row 0's (its router sees one sequence twice)."""
    out = []
    for tokens, labels in _batches(MOE16):
        tokens, labels = tokens.clone(), labels.clone()
        if kind == "masked":
            labels[2:, 4:] = -1
        if kind == "skewed":
            tokens[2:], labels[2:] = tokens[0], labels[0]
        out.append([tokens, labels])
    return out


@pytest.fixture(scope="module")
def fsdp_reference(tmp_path_factory):
    """kind → (the reference's losses and grad norms, its leaves' file):
    ``jax.jit(make_train_step(model.loss, TCFG))`` under the ``fsdp``
    ``in_shardings`` on a 2 × 2 mesh of host devices, one child process."""
    import json
    import os
    import subprocess
    import sys
    import textwrap
    import dataclasses as dc
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("fsdp_reference")
    cases = [{"out": str(tmp / f"{k}.npz"),
              "batches": [[t.tolist() for t in b]
                          for b in _fsdp_batches(k)]} for k in FSDP_CASES]
    payload = tmp / "cases.json"
    payload.write_text(json.dumps({
        "cfg": dc.asdict(MOE16), "group": 16, "cases": cases,
        "tcfg": {k: getattr(TCFG, k) for k in ("learning_rate",
                                                "warmup_steps",
                                                "total_steps")}}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(repo, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_CHILD),
                          str(payload)], env=env, capture_output=True,
                         text=True, cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    outs = {}
    for line in res.stdout.splitlines():
        if line.startswith("CASE "):
            i, body = line[5:].split(" ", 1)
            outs[FSDP_CASES[int(i)]] = (json.loads(body),
                                        cases[int(i)]["out"])
    assert len(outs) == len(FSDP_CASES), res.stdout[-2000:]
    return outs


def _fsdp_from_reference(micro, kind):
    """The port's ``fsdp`` step on 2 × 2 at ``micro`` microbatches from the
    reference's weights (MOE16, ``act_spec``, groups of 16): per step
    (loss, grad norm), and the final state."""
    import jax
    from repro.models.transformer import TransformerLM as RLM
    from repro_torch.models.transformer import params_from_jax
    from test_torch_lm import _jax_cfg
    rparams = RLM(_jax_cfg(MOE16)).init(jax.random.PRNGKey(0))
    params = params_from_jax(MOE16, jax.tree_util.tree_map(np.asarray,
                                                           rparams),
                             device="cpu", dtype=torch.float32)
    model = TransformerLM(MOE16, moe_group_size=16,
                          act_spec=P("data", None, None))
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    specs = state_specs_like(lm_param_specs(params, MOE16, "fsdp"))
    state = new_sharded_train_state(params, mesh, specs)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=micro,
                                   moe_span=model.moe_span)
    got = []
    for b in _fsdp_batches(kind):
        state, m = step(state, *b)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    return got, state


@pytest.mark.parametrize("kind", FSDP_CASES)
def test_one_microbatch_matches_the_reference_cell_step(fsdp_reference,
                                                        kind):
    """The reference's jitted cell step (``make_train_step(model.loss,
    TCFG)``, one microbatch) under the ``fsdp`` ``in_shardings`` on a 2 × 2
    JAX mesh, against the port's step at M = 1 on 2 × 2, MOE16 with
    ``act_spec`` from one set of weights, 3 steps: losses, grad norms and
    every leaf within 1e-4 (atol 2 · lr · steps on the leaves). "masked"
    (labels −1 in one shard only) and "skewed" (one shard's rows all row
    0's) are cases that the parent's cell step, one microbatch per batch
    shard (M = D = 2), gets wrong by more than rounding: a mean of the
    shards' cross entropy means, and a mean of the shards' aux losses, are
    not the batch's; the test shows that difference too (``-s`` prints
    it)."""
    from test_torch_train import _leaves_ref_layout
    want, path = fsdp_reference[kind]
    got, state = _fsdp_from_reference(1, kind)
    for (l0, n0), (l1, n1) in zip(want, got):
        assert l1 == pytest.approx(l0, rel=1e-4)
        assert n1 == pytest.approx(n0, rel=1e-4)
    whole = {k: gather(v) if isinstance(v, ShardedTensor) else v
             for k, v in state.params.items() if k != "layers"}
    whole["layers"] = [{k: (gather(v) if isinstance(v, ShardedTensor)
                            else {n: gather(t) for n, t in v.items()})
                        for k, v in lay.items()}
                       for lay in state.params["layers"]]
    leaves = _leaves_ref_layout(whole)
    ref = np.load(path)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for key in ref.files:
        np.testing.assert_allclose(leaves[key.replace(":", "/")], ref[key],
                                   rtol=1e-4, atol=flips)
    per_shard, _ = _fsdp_from_reference(2, kind)

    def gaps(run):       # step 0's relative loss and grad-norm gaps
        return [abs(a / b - 1) for a, b in zip(run[0], want[0])]
    print(f"\n{kind}: the reference's (loss, grad norm) {want}; M = 1 "
          f"{got}, step 0's gaps {gaps(got)}; M = D = 2 (the parent's cell "
          f"step) {per_shard}, step 0's gaps {gaps(per_shard)}")
    if kind != "random":
        assert max(gaps(per_shard)) > max(1e-5, 20 * max(gaps(got)))


# -- the table looked up as the reference's partitioner forms it -------------

SMOL = get_arch("smollm-135m", smoke=True).model     # a tied table
# MOE16 at 528 rows: 256 does not divide them, so fit_spec splits the table
# over "data" alone, as qwen3's 151,936 rows at its published widths
LOOKUP_MODELS = {"moe16": MOE16, "smollm": SMOL,
                 "moe16-v528": dataclasses.replace(MOE16, vocab_size=528)}
# (model, microbatches, mesh) of the reference's fsdp train step read, B 8 x
# 16 over "data": the cases where the port's lookup is the reference's
# (the table P(("data", "model"), None), or P("data", None) at 528 rows) ...
FSDP_LOOKUP_SAME = ([("moe16", 1, s) for s in ((2, 2), (1, 4), (4, 2))]
                    + [("moe16", 2, (1, 4))]
                    + [("moe16-v528", 1, s) for s in ((2, 2), (4, 2),
                                                      (2, 4))]
                    + [("moe16-v528", 2, (2, 2))]
                    + [("smollm", 1, s) for s in ((2, 2), (1, 4), (4, 2))])
# ... and where the port's layout differs: M > 1 microbatches on D > 1
# batch shards (the port keeps whole microbatches on each shard)
FSDP_LOOKUP_PORT = [("moe16", 2, s) for s in ((2, 2), (4, 2))]
FSDP_LOOKUP = FSDP_LOOKUP_SAME + FSDP_LOOKUP_PORT
# the chunked route (no ``act_spec``): the head's reading alone
FSDP_CHUNKED = [("moe16", 1, (2, 2)), ("smollm", 1, (2, 2)),
                ("moe16-v528", 1, (2, 2))]


def _lookup_batch(cfg):
    return _batches(cfg, 1, B=8)[0]


def _fsdp_lookups(shape, micro, B=8, S=16):
    """The lookups of one ``fsdp`` step: per lookup its batch shards' (d,
    ids) — each shard's own microbatches where D divides M, else each
    microbatch's shards at once."""
    D = shape[0]
    if micro % D == 0:
        return [[(d, B // micro * S)] for d in range(D)
                for _ in range(micro // D)]
    per = D // micro
    return [[(i * per + k, B // D * S) for k in range(per)]
            for i in range(micro)]


@pytest.fixture(scope="module")
def fsdp_lookup_reference(tmp_path_factory):
    """(model, microbatches, mesh) → the lookup's collectives a chip by
    kind and axis in the compiled HLO of the reference's jitted ``fsdp``
    train step (``make_train_step(model.loss, TCFG, microbatches=M)``
    under the ``fsdp`` ``in_shardings``, the batch over "data"), read by
    ``lookup_collectives``: one child process, eight host devices."""
    import json
    import os
    import subprocess
    import sys
    import textwrap
    import dataclasses as dc
    from test_torch_tp_train import HLO_AXES
    pytest.importorskip("jax")
    tokens, _ = _lookup_batch(MOE16)
    cases = [{"cfg": dc.asdict(LOOKUP_MODELS[n]), "micro": m, "mesh": s,
              "shape": list(tokens.shape), "act": act}
             for act, keys in ((True, FSDP_LOOKUP), (False, FSDP_CHUNKED))
             for n, m, s in keys]
    keys = FSDP_LOOKUP + [("chunked",) + k for k in FSDP_CHUNKED]
    payload = tmp_path_factory.mktemp("fsdp_lookup") / "cases.json"
    payload.write_text(json.dumps({"cases": cases, "tcfg": {
        k: getattr(TCFG, k) for k in ("learning_rate", "warmup_steps",
                                      "total_steps")}}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(repo, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(HLO_AXES + _LOOKUP_CHILD),
                          str(payload)], env=env, capture_output=True,
                         text=True, cwd=repo, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    outs = {}
    for line in res.stdout.splitlines():
        if line.startswith("CASE "):
            i, body = line[5:].split(" ", 1)
            outs[keys[int(i)]] = json.loads(body)
    assert len(outs) == len(keys), res.stdout[-2000:]
    return outs


_LOOKUP_CHILD = r'''
import json, sys
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.config.base import MoEConfig, TrainConfig, TransformerConfig
from repro.distrib.sharding import lm_param_specs, state_specs_like
from repro.models.transformer import TransformerLM
from repro.train.state import make_train_step, new_train_state

args = json.loads(open(sys.argv[1]).read())
for i, case in enumerate(args["cases"]):
    D, MODEL = case["mesh"]
    mesh = Mesh(np.array(jax.devices()[:D * MODEL]).reshape(D, MODEL),
                ("data", "model"))
    ns = lambda s: NamedSharding(mesh, s)
    bs = ns(P("data", None))
    kw = dict(case["cfg"])
    kw["moe"] = MoEConfig(**kw["moe"]) if kw.get("moe") else None
    cfg = TransformerConfig(**kw)
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None) if case["act"]
                          else None)
    state = new_train_state(model.init(jax.random.PRNGKey(0)))
    specs = state_specs_like(lm_param_specs(state.params, cfg, "fsdp"))
    step = jax.jit(make_train_step(model.loss, TrainConfig(**args["tcfg"]),
                                   microbatches=case["micro"]),
                   in_shardings=(jax.tree.map(ns, specs), bs, bs))
    tokens = jnp.zeros(case["shape"], jnp.int32)
    with mesh:
        hlo = step.lower(state, tokens, tokens).compile().as_text()
    # the ids' collectives alone: those of an integer operand
    ids = "\n".join(l for l in hlo.splitlines()
                    if not _COLLECTIVE_RE.search(l)
                    or re.search(r"= \(?[su]\d+\[", l))
    # the head's: the vocab-parallel loss's, or the chunked loss's
    sites = HEAD_SITES if case["act"] else CHUNKED_HEAD
    print(f"CASE {i} " + json.dumps({
        "all": lookup_collectives(hlo, *LM_LOOKUP),
        "ids": lookup_collectives(ids, *LM_LOOKUP),
        "head": {side: head_collectives(hlo, sites, side)
                 for side in ("fwd", "bwd")}}), flush=True)
'''


def _fsdp_lookup_moves(cfg, shape, micro, act=True):
    """One ``fsdp`` step of ``cfg`` (``act_spec`` unless not ``act``,
    groups of 16) on a ("data", "model") mesh of ``shape`` at ``micro``
    microbatches: the mesh's moves and bytes."""
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None) if act else None)
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    specs = state_specs_like(lm_param_specs(params, cfg, "fsdp"))
    mesh = Mesh(shape, ("data", "model"), ["cpu"] * (shape[0] * shape[1]))
    state = new_sharded_train_state(params, mesh, specs)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=micro,
                                   moe_span=model.moe_span)
    step(state, *_lookup_batch(cfg))
    return mesh, dict(mesh.moves), dict(mesh.bytes)


def _fsdp_lookup_bytes(name, micro, shape):
    """The port's ``fsdp`` step of ``LOOKUP_MODELS[name]``: the mesh, its
    lookup bytes by kind and axis a chip (``lookup_by_kind``), the ids'
    apart, its own moves by name, and every ``emb_*`` byte, checked
    against ``chip_smoke.fsdp_lookup_want``'s."""
    import chip_smoke
    from test_torch_tp_train import lookup_by_kind
    cfg = LOOKUP_MODELS[name]
    mesh, moves, nbytes = _fsdp_lookup_moves(cfg, shape, micro)
    ids, own = lookup_by_kind(mesh, {k: v for k, v in moves.items()
                                     if k[0].startswith("emb_ids_")})
    rows, own_rows = lookup_by_kind(mesh, {
        k: v for k, v in moves.items() if not k[0].startswith("emb_ids_")})
    own.update(own_rows)
    tokens = _lookup_batch(cfg)[0]
    assert {k: v for k, v in nbytes.items() if k.startswith("emb_")} == \
        chip_smoke.fsdp_lookup_want(cfg, shape, _fsdp_lookups(shape, micro),
                                    True, tokens.element_size())
    return mesh, ids, rows, own


def _read_rows(read):
    """The reference's lookup collectives but the ids'."""
    return {k: v - read["ids"].get(k, 0) for k, v in read["all"].items()
            if v != read["ids"].get(k, 0)}


@pytest.mark.parametrize("name,micro,shape", FSDP_LOOKUP_SAME,
                         ids=[f"{n}-{m}-{d}x{k}"
                              for n, m, (d, k) in FSDP_LOOKUP_SAME])
def test_fsdp_lookup_moves_as_the_reference(fsdp_lookup_reference, name,
                                            micro, shape):
    """The ``fsdp`` train step's lookup of its table against the
    reference's jitted step (B 8 × 16 over "data"), where the port's
    layout is the reference's: the port's lookup bytes a step by kind and
    axis a chip (``lookup_by_kind``) equal, to the byte, the HLO's
    collectives of the embedding's gather and its transpose, the ids' and
    the rows' read apart. MOE16's table, P(("data", "model"), None) (1
    microbatch on 2 × 2, 1 × 4 and 4 × 2; 2 on 1 × 4): the ids' all-gather
    along "data", the partial rows' all-reduce over the blocks' positions
    (both axes; "model" on 1 × 4), the gradient rows' all-gather along
    "data". At 528 rows the table lies P("data", None) (1 microbatch on 2
    × 2, 4 × 2 and 2 × 4; 2 on 2 × 2): the ids' collective-permute to each
    batch shard's "model" column (and all-gather along "data" on 4 × 2),
    the partial rows' all-reduce along "data" within the column, the rows'
    and the gradient rows' collective-permute; the block gradient's
    all-reduce over "model" (one block of V/D rows, once a microbatch) is
    the step's gradient sum (``grad_psum`` in the port, once a step, of
    the microbatches' sum at each shard). Apart: the port's own moves
    (``emb_ids_home``, ``emb_grad_home``: the batch shard's ids and
    gradient rows from its home to its group). Every ``emb_*`` byte equals
    ``chip_smoke.fsdp_lookup_want``'s."""
    cfg = LOOKUP_MODELS[name]
    read = fsdp_lookup_reference[(name, micro, shape)]
    mesh, ids, rows, own = _fsdp_lookup_bytes(name, micro, shape)
    read_rows = _read_rows(read)
    print(f"\nlookup ({name}, {micro} microbatch(es), {shape}): reference "
          f"HLO {read}; the port: ids {ids}, rows {rows}, its own moves "
          f"{own}")
    assert ids == read["ids"]
    if cfg.vocab_size % 256:
        D = shape[0]
        assert read_rows.pop("all-reduce model") == \
            micro * cfg.vocab_size // D * cfg.d_model * 4
        kinds = {"collective-permute both", "all-reduce data"}
        assert set(read["ids"]) == ({"collective-permute both",
                                     "all-gather data"} if D > shape[1]
                                    else {"collective-permute both"})
    else:
        kinds = ({"all-reduce model"} if shape[0] == 1 else
                 {"all-reduce both", "all-gather data"})
    assert rows == read_rows
    assert kinds <= set(read_rows)
    assert set(own) <= {"emb_ids_home", "emb_grad_home"} and own
    if (name, micro, shape) in FSDP_LOOKUP_READ:
        assert {k: read[k] for k in ("all", "ids")} == \
            FSDP_LOOKUP_READ[(name, micro, shape)]


# the reference's readings stated: where the port's layout differs (its
# moves held to its formula), and smollm's tied table (looked up where it
# lies, as the head's blocks stay where they lie: its reading compared as
# it was when the port gathered the table)
FSDP_LOOKUP_READ = {
    ("moe16", 2, (2, 2)): {"all": {"all-gather data": 16640,
                                   "all-reduce both": 32768},
                           "ids": {"all-gather data": 256}},
    ("moe16", 2, (4, 2)): {"all": {"all-gather data": 8448,
                                   "all-reduce both": 32768},
                           "ids": {"all-gather data": 256}},
    ("smollm", 1, (2, 2)): {"all": {"all-gather data": 24832,
                                    "all-reduce both": 49152},
                            "ids": {"all-gather data": 256}},
    ("smollm", 1, (1, 4)): {"all": {"all-reduce model": 49152}, "ids": {}},
    ("smollm", 1, (4, 2)): {"all": {"all-gather data": 12416,
                                    "all-reduce both": 49152},
                            "ids": {"all-gather data": 128}}}


@pytest.mark.parametrize("name,micro,shape", FSDP_LOOKUP_PORT,
                         ids=[f"{n}-{m}-{d}x{k}"
                              for n, m, (d, k) in FSDP_LOOKUP_PORT])
def test_fsdp_lookup_where_the_layout_differs(fsdp_lookup_reference, name,
                                              micro, shape):
    """The ``fsdp`` train step's lookup where the port's layout is not the
    reference's, the reference's reading stated (``FSDP_LOOKUP_READ``) and
    the port's bytes held to ``chip_smoke.fsdp_lookup_want`` alone: M > 1
    microbatches on D > 1 batch shards, where the port keeps whole
    microbatches on each shard (one lookup a shard's microbatch, folded to
    its home) and the reference splits each over all of "data", its
    all-reduce delivering every microbatch's rows to every chip."""
    read = fsdp_lookup_reference[(name, micro, shape)]
    assert {k: read[k] for k in ("all", "ids")} == \
        FSDP_LOOKUP_READ[(name, micro, shape)]
    mesh, ids, rows, own = _fsdp_lookup_bytes(name, micro, shape)
    print(f"\nlookup ({name}, {micro} microbatch(es), {shape}): reference "
          f"HLO {read}; the port: ids {ids}, rows {rows}, its own moves "
          f"{own}")
    assert rows and own


# the head's reference cases: (model, microbatches, mesh), the vocab-parallel
# route, where the port's head stays where it lies ...
FSDP_HEAD = ([("moe16", 1, s) for s in ((2, 2), (1, 4), (4, 2))]
             + [("moe16", 2, (1, 4)), ("moe16-v528", 1, (2, 2))]
             + [("smollm", 1, s) for s in ((2, 2), (1, 4), (4, 2))])
# ... and the fallback head on meshes that are not square, which the port
# gathers whole at each home (the reference's readings stated)
FSDP_HEAD_GATHERED = {
    ("moe16-v528", 1, (4, 2)): {
        "fwd": {"all-gather data": 8192, "all-reduce data": 1024},
        "bwd": {"all-gather data": 33792}},
    ("moe16-v528", 1, (2, 4)): {
        "fwd": {"collective-permute both": 8192, "all-gather model": 8192,
                "all-reduce data": 1024},
        "bwd": {"collective-permute both": 101376,
                "all-reduce model": 16384}}}


def _fsdp_step_bytes(cfg, shape, micro, nbytes, act=True):
    """Every ``head_*``, ``emb_*`` and ``all_gather*`` byte of one ``fsdp``
    step equal to ``chip_smoke.head_want``, ``fsdp_lookup_want`` and
    ``fsdp_gather_want``'s (the gathers the head's and a tied table's
    bytes left out where the head stays where it lies)."""
    import chip_smoke
    calls = _fsdp_lookups(shape, micro)
    want = dict(chip_smoke.fsdp_gather_want(cfg, shape, calls, act))
    want.update(chip_smoke.fsdp_lookup_want(cfg, shape, calls, True,
                                            lies=act))
    if act:
        want.update(chip_smoke.head_want(cfg, shape, calls, True))
    got = {k: v for k, v in nbytes.items()
           if k.startswith(("head_", "emb_", "all_gather"))}
    assert got == want


@pytest.mark.parametrize("name,micro,shape", FSDP_HEAD,
                         ids=[f"{n}-{m}-{d}x{k}"
                              for n, m, (d, k) in FSDP_HEAD])
def test_fsdp_head_moves_as_the_reference(fsdp_lookup_reference, name,
                                          micro, shape):
    """The ``fsdp`` train step's head on the vocab-parallel route against
    the reference's jitted step (B 8 × 16 over "data"): the port's head
    bytes a step by kind and axis a chip
    (``test_torch_tp_train.head_by_kind``), forward and backward apart,
    equal, to the byte, the HLO's collectives of the product ``hidden @
    head_w`` and of the log-sum-exp's reductions (``HEAD_SITES``). One
    vocab block a position (MOE16's P(None, ("data", "model")), smollm's
    tied table P(("data", "model"), None) read as its transpose): the
    hidden rows all-gathered along "data", the row maxima and sums
    all-reduced over every position, the dX partials all-reduced along
    "data" and then over "model" (1 × 4: over "model" alone). The fallback
    at 528 rows, P(None, "data") on 2 × 2: the rows collective-permuted and
    all-gathered along "model", the statistics all-reduced along "data";
    the backward's block and its dW collective-permuted, the dX partials
    all-reduced over "model". Apart: the port's own moves (``HEAD_OWN``).
    No byte of the head, nor of a tied table, is gathered: every
    ``head_*``, ``emb_*`` and ``all_gather*`` byte is the formulas'
    (:func:`_fsdp_step_bytes`)."""
    from test_torch_tp_train import HEAD_OWN, head_by_kind
    cfg = LOOKUP_MODELS[name]
    read = fsdp_lookup_reference[(name, micro, shape)]["head"]
    mesh, moves, nbytes = _fsdp_lookup_moves(cfg, shape, micro)
    fwd, bwd, own = head_by_kind(mesh, moves)
    print(f"\nhead ({name}, {micro} microbatch(es), {shape}): reference "
          f"HLO {read}; the port: forward {fwd}, backward {bwd}, its own "
          f"moves {own}")
    assert fwd == read["fwd"] and bwd == read["bwd"]
    assert own and set(own) <= HEAD_OWN
    _fsdp_step_bytes(cfg, shape, micro, nbytes)


@pytest.mark.parametrize("name,micro,shape", sorted(FSDP_HEAD_GATHERED),
                         ids=[f"{n}-{m}-{d}x{k}" for n, m, (d, k)
                              in sorted(FSDP_HEAD_GATHERED)])
def test_fsdp_head_where_the_layout_differs(fsdp_lookup_reference, name,
                                            micro, shape):
    """The fallback head P(None, "data") on 4 × 2 and 2 × 4, where the
    port's form is not the reference's: the reference's readings stated
    (``FSDP_HEAD_GATHERED``: on 4 × 2 the rows all-gathered along "data"
    and the dW blocks all-gathered along "data" in the backward, on 2 × 4
    the rows' and the block's permutes at another split); the port gathers
    the head whole at each home, its bytes the formulas'."""
    cfg = LOOKUP_MODELS[name]
    read = fsdp_lookup_reference[(name, micro, shape)]["head"]
    assert read == FSDP_HEAD_GATHERED[(name, micro, shape)]
    mesh, moves, nbytes = _fsdp_lookup_moves(cfg, shape, micro)
    assert not any(k.startswith("head_") for k in nbytes)
    _fsdp_step_bytes(cfg, shape, micro, nbytes)


# the chunked route's readings (no ``act_spec``): the head gathered whole
# for the chunk scan, forward and again in the backward
FSDP_CHUNKED_READ = {
    ("moe16", 1, (2, 2)): {"fwd": {"all-gather both": 32768},
                           "bwd": {"all-gather both": 32768}},
    ("smollm", 1, (2, 2)): {"fwd": {"all-gather both": 49152},
                            "bwd": {"all-gather both": 49152,
                                    "all-reduce data": 196608}},
    ("moe16-v528", 1, (2, 2)): {
        "fwd": {"collective-permute both": 67584, "all-gather model": 67584},
        "bwd": {"collective-permute both": 135168,
                "all-gather model": 67584}}}


@pytest.mark.parametrize("name,micro,shape", FSDP_CHUNKED,
                         ids=[f"{n}-{m}-{d}x{k}"
                              for n, m, (d, k) in FSDP_CHUNKED])
def test_fsdp_chunked_head_is_gathered(fsdp_lookup_reference, name, micro,
                                       shape):
    """The chunked route (no ``act_spec``: train-sharded (a)'s ZeRO-3
    step) keeps its gathered head on purpose: the reference gathers the
    head whole for the chunk scan, in the forward and again in the
    backward (its readings stated, ``FSDP_CHUNKED_READ``); the port
    gathers it whole at each home once and sends each block's gradient
    back (``all_gather``, ``all_gather_grad``: the formula's with the head
    and a tied table read whole), and moves no ``head_*`` byte."""
    cfg = LOOKUP_MODELS[name]
    read = fsdp_lookup_reference[("chunked", name, micro, shape)]["head"]
    print(f"\nchunked head ({name}, {micro}, {shape}): reference HLO "
          f"{read}")
    assert read == FSDP_CHUNKED_READ[(name, micro, shape)]
    mesh, moves, nbytes = _fsdp_lookup_moves(cfg, shape, micro, act=False)
    assert not any(k.startswith("head_") for k in nbytes)
    _fsdp_step_bytes(cfg, shape, micro, nbytes, act=False)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 4)],
                         ids=["2x2", "4x1", "2x4"])
def test_fsdp_lookup_rows_are_take_rows(shape, dtype):
    """A (16, 5) table placed P(("data", "model"), None), −0.0 in a row
    and in an entry, looked up over two batch shards' homes at once
    (``HomeViews.take_rows``), the ids at block boundaries, negative,
    outside [-n, n) and repeated by both shards: each home's rows in
    ``dtype`` bit for bit ``take_rows`` of the cast table (−0.0 kept,
    negative ids from the end, NaN rows), and, from seeded gradient rows,
    the table's gradient bitwise one device's ``take_rows`` backward over
    the two shards' ids in batch order, all of it in the first home's
    view's blocks. (In f32: on the CPU the one-device backward's
    accumulating ``index_put_`` and ``segment_sum``'s ``index_add`` round
    bf16 sums differently; on the card both are the sorted
    ``index_put_``.)"""
    from repro_torch.distrib.collectives import (HomeViews, Rows,
                                                 ShardView, batch_groups)
    from repro_torch.distrib.sharding import device_put
    from repro_torch.sparse.segment import take_rows
    g = torch.Generator().manual_seed(11)
    table = torch.randn((16, 5), generator=g)
    table[4] = -0.0
    table[9, 3] = -0.0
    ids = [torch.tensor([[0, 3, 4, 7, 5, 5], [8, -1, 16, -17, 4, 9]]),
           torch.tensor([[5, 12, 15, -16, 5, 5], [40, 9, 11, 4, 5, -100]])]
    grads = [torch.randn(tuple(i.shape) + (5,), generator=g).to(dtype)
             for i in ids]
    mesh = Mesh(shape, ("data", "model"), ["cpu"] * (shape[0] * shape[1]))
    x = device_put(table, mesh, P(("data", "model"), None))
    homes, groups = batch_groups(mesh, "data")
    views = [ShardView(x, h, grp) for h, grp in zip(homes[:2], groups[:2])]
    out = HomeViews(views, homes[:2], mesh).take_rows(
        Rows(ids, homes[:2], mesh), dtype)
    leaf = table.clone().requires_grad_(True)
    want = take_rows(leaf.to(dtype), torch.cat(ids))
    for d in range(2):
        assert torch.equal(_bits(out.parts[d]), _bits(want[2 * d:2 * d + 2]))
    assert mesh.bytes["emb_rows_fold"] > 0
    if dtype != torch.float32:
        return
    want.backward(torch.cat(grads))
    torch.autograd.backward(out.parts, grads)
    got = torch.cat([views[0].proxies[b].grad
                     for b in sorted(views[0].proxies)])
    assert torch.equal(_bits(got), _bits(leaf.grad))
    assert all(p.grad is None for p in views[1].proxies.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4)],
                         ids=["2x2", "4x2", "2x4"])
def test_column_lookup_rows_are_take_rows(shape, dtype):
    """A (16, 5) table placed P("data", None) (each block repeated along
    "model"), −0.0 in a row and in an entry, looked up over every batch
    shard's home at once (``HomeViews.take_rows``), the ids at block
    boundaries, negative, outside [-n, n) and repeated: each home's rows in
    ``dtype`` bit for bit ``take_rows`` of the cast table, looked up on
    each shard's "model" column (``emb_rows_fold`` within it, the rows
    sent home by ``emb_rows_permute``); from seeded gradient rows, each
    column's blocks, at the first of its homes' views, take one device's
    ``take_rows`` backward over that column's homes' ids in batch order,
    bit for bit, the other views none; the columns' blocks together are
    the table's gradient."""
    from repro_torch.distrib.collectives import (HomeViews, Rows,
                                                 ShardView, batch_groups)
    from repro_torch.distrib.sharding import device_put
    from repro_torch.sparse.segment import take_rows
    g = torch.Generator().manual_seed(12)
    table = torch.randn((16, 5), generator=g)
    table[4] = -0.0
    table[9, 3] = -0.0
    mesh = Mesh(shape, ("data", "model"), ["cpu"] * (shape[0] * shape[1]))
    x = device_put(table, mesh, P("data", None))
    homes, groups = batch_groups(mesh, "data")
    pool = torch.tensor([0, 3, 4, 7, 8, -1, 16, -17, 15, -16, 40, 9, 11,
                         5, -100])
    ids = [pool[torch.randint(0, len(pool), (2, 6), generator=g)]
           for _ in homes]
    grads = [torch.randn((2, 6, 5), generator=g) for _ in homes]
    views = [ShardView(x, h, grp) for h, grp in zip(homes, groups)]
    out = HomeViews(views, homes, mesh).take_rows(Rows(ids, homes, mesh),
                                                  dtype)
    want = take_rows(table.to(dtype), torch.cat(ids))
    for d in range(len(homes)):
        assert torch.equal(_bits(out.parts[d]),
                           _bits(want[2 * d:2 * d + 2]))
    assert mesh.bytes["emb_rows_fold"] > 0
    assert mesh.bytes["emb_rows_permute"] > 0
    if dtype != torch.float32:
        return
    torch.autograd.backward(out.parts, grads)
    columns = {}
    for d, v in enumerate(views):
        columns.setdefault(tuple(sorted(v.sources.values())), []).append(d)
    assert len(columns) == min(shape)
    total = torch.zeros_like(table)
    for members in columns.values():
        leaf = table.clone().requires_grad_(True)
        take_rows(leaf, torch.cat([ids[d] for d in members])).backward(
            torch.cat([grads[d] for d in members]))
        first = views[members[0]]
        got = torch.cat([first.proxies[b].grad
                         for b in sorted(first.proxies)])
        assert torch.equal(_bits(got), _bits(leaf.grad))
        assert all(p.grad is None for d in members[1:]
                   for p in views[d].proxies.values())
        total += got
    one = table.clone().requires_grad_(True)
    take_rows(one, torch.cat(ids)).backward(torch.cat(grads))
    torch.testing.assert_close(total, one.grad, rtol=1e-6, atol=1e-6)


def test_fsdp_lookup_gradient_takes_one_devices_order():
    """Rows both batch shards hit many times: the joint lookup's table
    gradient is one device's backward over the whole batch bit for bit,
    and that order is not the per-shard order (each shard's sum, then the
    two added), which differs here: the test tells them apart."""
    from repro_torch.distrib.collectives import (HomeViews, Rows,
                                                 ShardView, batch_groups)
    from repro_torch.distrib.sharding import device_put
    from repro_torch.sparse.segment import take_rows
    g = torch.Generator().manual_seed(13)
    table = torch.randn((16, 8), generator=g)
    ids = [torch.randint(0, 3, (4, 32), generator=g) for _ in range(2)]
    grads = [torch.randn((4, 32, 8), generator=g) for _ in range(2)]
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    x = device_put(table, mesh, P(("data", "model"), None))
    homes, groups = batch_groups(mesh, "data")
    views = [ShardView(x, h, grp) for h, grp in zip(homes, groups)]
    out = HomeViews(views, homes, mesh).take_rows(Rows(ids, homes, mesh))
    torch.autograd.backward(out.parts, grads)
    got = torch.cat([views[0].proxies[b].grad
                     for b in sorted(views[0].proxies)])
    one = table.clone().requires_grad_(True)
    take_rows(one, torch.cat(ids)).backward(torch.cat(grads))
    assert torch.equal(got, one.grad)
    per_shard = []
    for i, gr in zip(ids, grads):
        t = table.clone().requires_grad_(True)
        take_rows(t, i).backward(gr)
        per_shard.append(t.grad)
    assert not torch.equal(per_shard[0] + per_shard[1], one.grad)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_tied_table_block_gradient_takes_one_devices_order(shape):
    """A tied table on the vocab-parallel route, split along its rows over
    both axes: each block is looked up where it lies
    (``take_rows_where_they_lie``) and serves as the head's block
    transposed where it lies (``collectives.vocab_parallel_xent``), both
    through the same leaf. Over two microbatches its gradient is each
    microbatch's head dW plus its lookup's ``segment_sum``, then the
    microbatches added in order: the order in which one device's autograd
    accumulates the two uses of ``embed`` (their sum in the leaf's input
    buffer, then the ``.grad`` accumulation), bit for bit, against the two
    uses run apart through separate leaves."""
    from repro_torch.distrib.collectives import LyingHead, ShardView
    from repro_torch.distrib.sharding import device_put
    g = torch.Generator().manual_seed(11)
    mesh = Mesh(shape, ("data", "model"), CPU4)
    placed = device_put(torch.randn((64, 8), generator=g), mesh,
                        P(("data", "model"), None))
    ids = torch.randint(0, 64, (2, 2, 6), generator=g)
    ids[:, 1, :3] = ids[:, 0, :3]                  # rows hit twice
    labels = torch.randint(-1, 64, (2, 2, 6), generator=g)
    group = list(range(shape[1]))

    def run(lookup, head, mb):
        rows = lookup.take_rows(ids[mb])
        return LyingHead(head, transposed=True).xent(rows * 1.5, labels[mb])

    tied = ShardView(placed, 0, group)
    for mb in range(2):
        run(tied, tied, mb).backward()
    parts = []
    for mb in range(2):
        lookup, head = ShardView(placed, 0, group), ShardView(placed, 0, group)
        run(lookup, head, mb).backward()
        parts.append((dict((b, gr) for b, _, gr in head.grads()),
                      dict((b, gr) for b, _, gr in lookup.grads())))
    for block, _, got in tied.grads():
        (h0, l0), (h1, l1) = ((h[block], lk[block]) for h, lk in parts)
        assert torch.equal(got, (h0 + l0) + (h1 + l1))


def test_lm_train_cell_runs_one_microbatch():
    """The ``fsdp`` train cell on a 2 × 2 meta mesh at its published batch
    (256 rows over the 2 "data" shards) runs the reference cell's one
    microbatch."""
    mesh = Mesh((2, 2), ("data", "model"), ["meta"] * 4)
    cell = build_cell(get_arch("smollm-135m"), "train_4k", "cpu",
                      mesh=mesh, concrete=False)
    assert cell.args[1].shape[0] >= 16
    assert cell.meta["microbatches"] == 1


def test_step_refuses_a_state_of_another_mesh_and_uneven_microbatches():
    cfg = DENSE
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    specs = state_specs_like(lm_param_specs(params, cfg, "fsdp"))
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    with pytest.raises(ValueError, match="do not split"):
        make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                P("data", None), microbatches=3)
    other = Mesh((2, 2), ("data", "model"), CPU4)
    state = new_sharded_train_state(params, other, specs)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=2)
    with pytest.raises(ValueError, match="not placed on the step's mesh"):
        step(state, *_batches(cfg, 1)[0])


def test_restored_checkpoint_resharded_and_stepped(tmp_path):
    """Two unsharded steps, a checkpoint in the reference's layout, the
    restored whole state resharded onto a 2 × 2 mesh and onto (1, 2) after
    an elastic re-mesh: each further step bitwise the unsharded one's."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distrib.fault import plan_elastic
    cfg = MOE16
    model = TransformerLM(cfg, moe_group_size=16)
    batches = _batches(cfg, 4)
    ref = new_train_state(model.init(torch.Generator().manual_seed(0),
                                     dtype=torch.float32))
    ref_step = make_train_step(model.loss, TCFG, microbatches=2)
    for b in batches[:2]:
        ref, _ = ref_step(ref, *b)
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(2, stack_layers(ref))
    fresh = new_train_state(model.init(torch.Generator().manual_seed(9),
                                       dtype=torch.float32))
    tree, step_no = ckpt.restore(stack_layers(fresh, values=False))
    load_stacked(fresh, tree)
    assert step_no == 2
    specs = state_specs_like(lm_param_specs(fresh.params, cfg, "fsdp"))
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    state = reshard(fresh, mesh, specs)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=2)
    ref, rm = ref_step(ref, *batches[2])
    state, m = step(state, *batches[2])
    assert (float(m["loss"]), float(m["grad_norm"])) == \
        (float(rm["loss"]), float(rm["grad_norm"]))
    plan = plan_elastic(mesh.shape, mesh.axis_names, failed_devices=2)
    small = Mesh(plan.new_shape, plan.axes, CPU4[:2])
    state = reshard(state, small, specs, donate=True)
    step = make_sharded_train_step(model.loss, TCFG, small, specs,
                                   P("data", None), microbatches=2)
    ref, rm = ref_step(ref, *batches[3])
    state, m = step(state, *batches[3])
    assert (float(m["loss"]), float(m["grad_norm"])) == \
        (float(rm["loss"]), float(rm["grad_norm"]))
    _assert_state_equal(ref, state)


def test_host_mesh_step_with_act_spec_matches_the_reference_step():
    """The reference's model with ``act_spec`` (its vocab-parallel loss,
    ``exp_spec`` on the MoE) stepped under a one-device mesh, against the
    port's sharded step on ``make_host_mesh``, from one set of weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as RP
    from repro.models.transformer import TransformerLM as RLM
    from repro.train.state import make_train_step as rmake
    from repro.train.state import new_train_state as rnew
    from repro_torch.models.transformer import params_from_jax
    from test_torch_lm import _jax_cfg
    from test_torch_train import _leaves_jax, _leaves_ref_layout
    cfg = MOE16
    rmodel = RLM(_jax_cfg(cfg), moe_group_size=16,
                 act_spec=RP(("data",), None, None))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    rstep = jax.jit(rmake(rmodel.loss, TCFG, microbatches=2))
    rstate = rnew(rparams)
    model = TransformerLM(cfg, moe_group_size=16,
                          act_spec=P("data", None, None))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                         rparams),
                             device="cpu", dtype=torch.float32)
    mesh = make_host_mesh("cpu")
    specs = state_specs_like(lm_param_specs(params, cfg, "fsdp"))
    state = new_sharded_train_state(params, mesh, specs)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=2)
    for b in _batches(cfg):
        with jmesh:
            rstate, rm = rstep(rstate, *(jnp.asarray(t.numpy()) for t in b))
        state, m = step(state, *b)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
    whole = {k: gather(v) if isinstance(v, ShardedTensor) else v
             for k, v in state.params.items() if k != "layers"}
    whole["layers"] = [{k: (gather(v) if isinstance(v, ShardedTensor)
                            else {n: gather(t) for n, t in v.items()})
                        for k, v in lay.items()}
                       for lay in state.params["layers"]]
    got = _leaves_ref_layout(whole)
    want = _leaves_jax(rstate.params)
    flips = 2 * TCFG.learning_rate * N_STEPS
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=flips)


# -- the LM cells' shardings (ports of tests/test_cells_contract.py) ----------------

def _structure(tree):
    """A tree's shape with every leaf (tensor, sharded tensor or spec) as
    one mark."""
    if isinstance(tree, P) or not isinstance(tree, (dict, list, tuple)):
        return "leaf"
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return (type(tree).__name__, [_structure(v) for v in tree])


def test_full_specs_no_allocation():
    """input_specs of the 72B config are meta tensors at published
    shapes."""
    arch = get_arch("qwen2-72b")
    args = input_specs(arch, "train_4k")
    for leaf in tree_leaves(args):
        assert leaf.device.type == "meta"
    state, tokens, labels = args
    assert tokens.shape == (256, 4096) and tokens.dtype == torch.int32
    assert state.params["embed"].shape == (152064, 8192)
    assert len(state.params["layers"]) == 80
    assert state.opt.m["embed"].dtype == torch.float32


@pytest.mark.parametrize("concrete", [False, True])
def test_shardings_cover_args_on_mesh(concrete):
    mesh = make_host_mesh("cpu")
    arch = get_arch("smollm-135m", smoke=True)
    cell = build_cell(arch, "train_4k", "cpu", smoke=True, mesh=mesh,
                      concrete=concrete)
    assert _structure(cell.args) == _structure(cell.in_shardings)
    state, tokens, labels = cell.args
    if concrete:   # the train cell with a mesh: its state placed, stepped
        assert all(isinstance(x, ShardedTensor)
                   for x in tree_leaves(state))
        state, m = cell.step_fn(state, tokens, labels)
        assert np.isfinite(float(m["loss"]))
    for shape in ("prefill_32k", "decode_32k"):
        c = build_cell(arch, shape, "cpu", smoke=True, mesh=mesh,
                       concrete=False)
        assert _structure(c.args) == _structure(c.in_shardings)


def test_decode_cache_published_geometry():
    arch = get_arch("qwen2-72b")
    _, token, (k_cache, v_cache), cache_len = input_specs(arch, "long_500k")
    assert token.shape == (1, 1)
    assert k_cache.shape == (80, 1, 524288, 8, 128)
    assert k_cache.dtype == torch.bfloat16 and k_cache.device.type == "meta"
    assert int(cache_len.numel()) == 1


def test_cells_in_shardings_equal_the_reference_cells():
    """The LM cells' spec trees (train, prefill, decode; smoke dims, a
    one-device mesh) equal the reference cells' leaf for leaf."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh as JMesh
    from repro.config.registry import get_arch as rget
    from repro.launch.cells import build_cell as rbuild
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        ref = rbuild(rget("qwen3-moe-30b-a3b", smoke=True), shape,
                     mesh=jmesh, smoke=True)
        cell = build_cell(get_arch("qwen3-moe-30b-a3b", smoke=True), shape,
                          "cpu", smoke=True, mesh=make_host_mesh("cpu"),
                          concrete=False)
        want = [tuple(s.spec) for s in jax.tree.leaves(ref.in_shardings)]
        got = _port_specs_in_ref_order(cell.in_shardings)
        assert got == want, shape


def _port_specs_in_ref_order(tree):
    """The port's spec tree flattened as the reference's (dict keys
    sorted; a "layers" list as the stacked leaf: one spec with the
    leading layer axis)."""
    if isinstance(tree, P):
        return [tuple(tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            v = tree[k]
            if k == "layers" and isinstance(v, list):
                out += [(None,) + s for s in _port_specs_in_ref_order(v[0])]
            else:
                out += _port_specs_in_ref_order(v)
        return out
    return [s for v in tree for s in _port_specs_in_ref_order(v)]


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sharded_step_on_one_card_as_four(cuda_device):
    """The SMOKE MoE's sharded step on ``cuda:0`` × 4 (2 × 2, one
    microbatch per batch shard) against the unsharded step on the card,
    bitwise, and with ``act_spec`` (experts where they live)."""
    for act in (None, P("data", None, None)):
        model = TransformerLM(MOE16, moe_group_size=16, act_spec=act)
        batches = [[t.to(cuda_device) for t in b] for b in _batches(MOE16)]
        ref = new_train_state(model.init(
            torch.Generator(device=cuda_device).manual_seed(0),
            dtype=torch.float32))
        params = model.init(torch.Generator(device=cuda_device)
                            .manual_seed(0), dtype=torch.float32)
        specs = state_specs_like(lm_param_specs(params, MOE16, "fsdp"))
        mesh = Mesh((2, 2), ("data", "model"), [cuda_device] * 4)
        state = new_sharded_train_state(params, mesh, specs)
        ref_step = make_train_step(model.loss, TCFG, microbatches=2)
        step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                       P("data", None), microbatches=2)
        for b in batches:
            ref, rm = ref_step(ref, *b)
            state, m = step(state, *b)
            assert (float(m["loss"]), float(m["grad_norm"])) == \
                (float(rm["loss"]), float(rm["grad_norm"]))
        _assert_state_equal(ref, state)
    with pytest.raises(ValueError, match="more than one type"):
        Mesh((2, 1), ("data", "model"), [cuda_device, "cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [0.01, 0.3, 1.0])
def test_cuda_compress_grads_equals_the_cpu(cuda_device, ratio):
    g = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn((256, 64), generator=g),
             "e": torch.randint(-3, 4, (8, 16, 4), generator=g).float()}
    cpu = compression_init(grads)
    card = compression_init({k: v.to(cuda_device) for k, v in grads.items()})
    for _ in range(2):
        s_cpu, cpu = compress_grads(grads, cpu, ratio)
        s_card, card = compress_grads(
            {k: v.to(cuda_device) for k, v in grads.items()}, card, ratio)
        for k in grads:
            assert torch.equal(s_card[k].cpu(), s_cpu[k])
            assert torch.equal(card.residual[k].cpu(), cpu.residual[k])
