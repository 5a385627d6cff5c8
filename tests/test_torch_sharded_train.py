"""The sharded LM train step (``train.state.make_sharded_train_step``),
expert parallelism in ``moe_block`` and the LM cells' shardings, on the
CPU (meshes of ``["cpu"] * 4``).

Bitwise wherever the step's sums run in ``make_train_step``'s order: with
one batch shard (D = 1), or one microbatch per batch shard (M / D = 1),
losses, grad norms and every gathered leaf equal the unsharded step's.
Where M / D > 1 the gradient sums run in another order, and the test
holds the step to ``test_torch_train.py``'s tolerances for the port
against JAX: losses and grad norms to rtol 1e-4, parameters within 1e-4
relative plus 2·lr per step absolute. ``moe_block`` with its experts on
other mesh positions is bitwise the unsharded block, forward and
backward. The host-mesh step with ``act_spec`` is held against the
reference's step of that model under a one-device mesh to the same
tolerances. The JAX package is imported only inside the tests that need
it, so the card tests (``cuda`` marker) run where JAX is not installed.
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


def _run(cfg, mesh, micro, act_spec=None, batches=None, steps=N_STEPS):
    """(unsharded losses+norms, sharded losses+norms, unsharded state,
    sharded state) over ``steps`` steps from one seed."""
    model = TransformerLM(cfg, moe_group_size=16, act_spec=act_spec)
    batches = batches or _batches(cfg, steps)
    ref = new_train_state(model.init(torch.Generator().manual_seed(0),
                                     dtype=torch.float32))
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    specs = state_specs_like(lm_param_specs(params, cfg, "fsdp"))
    state = new_sharded_train_state(params, mesh, specs)
    ref_step = make_train_step(model.loss, TCFG, microbatches=micro)
    step = make_sharded_train_step(model.loss, TCFG, mesh, specs,
                                   P("data", None), microbatches=micro)
    want, got = [], []
    for b in batches[:steps]:
        ref, rm = ref_step(ref, *b)
        state, m = step(state, *b)
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


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_expert_parallel_step_is_bitwise_the_unsharded_step(shape):
    """``act_spec`` on the 16-expert SMOKE model: the experts stay on
    their "model" shard and the loss takes the vocab-parallel cross
    entropy; bitwise the same model's unsharded step."""
    mesh = Mesh(shape, ("data", "model"), CPU4)
    want, got, ref, state = _run(MOE16, mesh, 2,
                                 act_spec=P("data", None, None))
    assert got == want
    _assert_state_equal(ref, state)
    assert mesh.bytes["expert_send"] > 0


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
