"""The port's distributed layers (``repro_torch.distrib``,
``repro_torch.launch.mesh``, ``repro_torch.optim.compression``) against
the JAX package, on the CPU.

The sharding rules are held leaf for leaf against the reference's on the
five LM configs at their FULL widths (shapes only: the reference's
``jax.eval_shape`` tree against the port's meta tensors), BST and the
GNNs; the port states each per-layer leaf's spec without the reference's
leading layer axis. Placement runs on a mesh of ``["cpu"] * 4``; the
blocks each mesh position holds are compared with JAX's
``NamedSharding`` in a child process that forces four host devices, where
the reference's ``sparse_allreduce`` and ``hierarchical_psum`` run under
``shard_map`` too. Tolerances: the rules, plans, placements and the
compression bitwise; the two collectives bitwise on inputs of a dyadic
grid (every partial sum exact), and to 1e-6 relative on seeded floats
(sums in another order).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.distrib import collectives as TC  # noqa: E402
from repro_torch.distrib import sharding as TS  # noqa: E402
from repro_torch.distrib.fault import plan_elastic, reshard  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.optim.compression import (compress_grads,  # noqa: E402
                                           compression_init)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * 4
LMS = ("qwen3-moe-30b-a3b", "smollm-135m", "deepseek-7b", "qwen2-72b",
       "dbrx-132b")


def _flat_specs(tree, prefix=""):
    """{path: tuple(spec)} of a spec tree (dicts; a port "layers" list by
    layer index)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat_specs(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tuple(tree)
    return out


def _ref_flat(tree):
    from jax.sharding import PartitionSpec
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(spec)
    return out


def _meta_like(tree):
    """The reference's ``eval_shape`` tree as meta tensors."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


# -- the rules -----------------------------------------------------------------

@pytest.mark.parametrize("policy", ["tp2d", "fsdp"])
@pytest.mark.parametrize("arch_id", LMS)
def test_lm_param_specs_equal_the_reference_at_full_width(arch_id, policy):
    from repro.config.registry import get_arch as rget
    from repro.distrib.sharding import lm_param_specs as rspecs
    from repro.models.transformer import TransformerLM as RLM
    rcfg = rget(arch_id).model
    rshape = jax.eval_shape(lambda: RLM(rcfg).init(jax.random.PRNGKey(0)))
    want = _ref_flat(rspecs(rshape, rcfg, policy=policy))
    cfg = get_arch(arch_id).model
    params = TransformerLM(cfg).init(torch.Generator(), dtype=torch.float32,
                                     device="meta")
    assert params["embed"].device.type == "meta"
    got = _flat_specs(TS.lm_param_specs(params, cfg, policy=policy))
    rshapes = {k: v.shape for k, v in _ref_flat_shapes(rshape).items()}
    seen = set()
    for key, spec in got.items():
        parts = key.split("/")
        if parts[0] == "layers":     # layers/<i>/...: the stacked leaf
            rkey = "/".join(["layers"] + parts[2:])
            assert want[rkey][0] is None
            assert spec == want[rkey][1:], key
            assert tuple(_leaf(params, parts).shape) == rshapes[rkey][1:]
        else:
            rkey = key
            assert spec == want[key], key
            assert tuple(_leaf(params, parts).shape) == rshapes[key]
        seen.add(rkey)
    assert seen == set(want)


def _leaf(tree, parts):
    for p in parts:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def _ref_flat_shapes(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", p)) for p in path)] = leaf
    return out


@pytest.mark.parametrize("multi_pod,batch", [(False, 0), (False, 8),
                                             (False, 16), (False, 128),
                                             (True, 16), (True, 32)])
def test_lm_cache_specs_equal_the_reference(multi_pod, batch):
    from repro.distrib.sharding import lm_cache_specs as rcache
    assert tuple(TS.lm_cache_specs(multi_pod, batch)) == \
        tuple(rcache(multi_pod, batch))


@pytest.mark.parametrize("shape,spec", [
    ((151936, 2048), (("data", "model"), None)),     # qwen3 vocab
    ((2048, 151936), (None, ("data", "model"))),
    ((8192, 29568), (None, ("data", "model"))),      # qwen2 d_ff
    ((576, 192), ("data", "model")),                 # smollm kv width
    ((576, 192), (None, ("model", "data"))),
    ((7, 48), (("pod", "data"), "model")),
    ((64,), (("pod", "data", "model"),)),
])
def test_fit_spec_equals_the_reference(shape, spec):
    from jax.sharding import PartitionSpec as RP
    from repro.distrib.sharding import fit_spec as rfit
    assert tuple(TS.fit_spec(shape, TS.P(*spec))) == \
        tuple(rfit(shape, RP(*spec)))


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("smoke", [False, True])
def test_bst_param_specs_equal_the_reference(serve, smoke):
    from repro.config.registry import get_arch as rget
    from repro.distrib.sharding import bst_param_specs as rspecs
    from repro.models.recsys.bst import BST as RBST
    rcfg = rget("bst", smoke=smoke).model
    rshape = jax.eval_shape(lambda: RBST(rcfg).init(jax.random.PRNGKey(0)))
    want = _ref_flat(rspecs(rshape, rcfg, serve=serve))
    cfg = get_arch("bst", smoke=smoke).model
    if smoke:   # the port's own tree
        from repro_torch.models.recsys.bst import BST
        params = BST(cfg).init(torch.Generator().manual_seed(0))
    else:
        params = _meta_like(rshape)
    assert _flat_specs(TS.bst_param_specs(params, cfg, serve=serve)) == want


@pytest.mark.parametrize("kind", ["schnet", "dimenet", "meshgraphnet",
                                  "graphcast"])
def test_gnn_param_specs_equal_the_reference(kind):
    from repro.distrib.sharding import gnn_param_specs as rspecs
    from repro.models.gnn.common import make_model as rmake
    from repro_torch.models.gnn.common import make_model
    cfg = get_arch(kind, smoke=True).model
    rshape = jax.eval_shape(
        lambda: rmake(cfg).init(jax.random.PRNGKey(0), d_feat=16))
    params = make_model(cfg).init(torch.Generator().manual_seed(0),
                                  d_feat=16)
    assert _flat_specs(TS.gnn_param_specs(params)) == \
        _ref_flat(rspecs(rshape))


def test_state_specs_like_matches_the_reference():
    from jax.sharding import PartitionSpec as RP
    from repro.distrib.sharding import state_specs_like as rlike
    pspec = {"embed": TS.P("data", None), "ln_f": TS.P(None)}
    got = TS.state_specs_like(pspec)
    want = rlike({"embed": RP("data", None), "ln_f": RP(None)})
    assert type(got).__name__ == type(want).__name__ == "TrainState"
    assert tuple(got.opt.step) == tuple(want.opt.step) == ()
    for tree in (got.params, got.opt.m, got.opt.v):
        assert _flat_specs(tree) == _ref_flat(want.params)


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as RP
    for entries in [(), (None,), (("data",), None), (("data", "model"),),
                    ("model", None, None)]:
        assert tuple(TS.P(*entries)) == tuple(RP(*entries))
    assert repr(TS.P("data", None)) == "P('data', None)"


# -- the mesh and the elastic plan ----------------------------------------------

def test_mesh_shapes_and_refusals():
    host = make_host_mesh("cpu")
    assert (host.shape, host.axis_names) == ((1, 1), ("data", "model"))
    prod = make_production_mesh(devices=["meta"] * 256)
    assert (prod.shape, prod.axis_names) == ((16, 16), ("data", "model"))
    pods = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert pods.axis_names == ("pod", "data", "model")
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    assert [mesh.coords(p) for p in range(4)] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    with pytest.raises(ValueError, match="does not divide"):
        Mesh((3, 1), ("data", "model"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="production axes"):
        Mesh((2,), ("rows",), ["cpu"] * 2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="more than one type"):
        Mesh((2, 1), ("data", "model"), ["cpu", "meta"])


@pytest.mark.parametrize("shape,axes,failed", [
    ((16, 16), ("data", "model"), 3),
    ((2, 16, 16), ("pod", "data", "model"), 40),
    ((2, 2), ("data", "model"), 2),
    ((4, 1), ("data", "model"), 3),
    ((2, 2), ("data", "model"), 64),
])
def test_plan_elastic_matches_the_reference(shape, axes, failed):
    from repro.distrib.fault import plan_elastic as rplan
    try:
        want = rplan(shape, axes, failed)
    except RuntimeError as exc:
        with pytest.raises(RuntimeError, match=str(exc)):
            plan_elastic(shape, axes, failed)
        return
    got = plan_elastic(shape, axes, failed)
    assert (got.old_shape, got.new_shape, got.axes,
            got.lost_batch_fraction) == (want.old_shape, want.new_shape,
                                         want.axes,
                                         want.lost_batch_fraction)


# -- placement against JAX's NamedSharding, and the two collectives ----------------

PLACEMENTS = [
    ((2, 2), ("data", "model"), (("data", "model"), None), (8, 6)),
    ((2, 2), ("data", "model"), (None, ("model", "data")), (3, 8)),
    ((2, 2), ("data", "model"), ("model", None, None), (4, 3, 2)),
    ((2, 2), ("data", "model"), ("data",), (4, 5)),
    ((2, 2), ("data", "model"), (), (6,)),
    ((1, 4), ("data", "model"), (None, "model"), (2, 8)),
    ((4, 1), ("data", "model"), (("data", "model"), None), (8, 2)),
    ((2, 1, 2), ("pod", "data", "model"), (("pod", "data"), "model"),
     (4, 4)),
]

_CHILD = r'''
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distrib.collectives import hierarchical_psum, sparse_allreduce
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

args = json.loads(sys.argv[1])
devs = jax.devices()[:4]
out = {"placements": []}
for shape, axes, spec, tshape in args["placements"]:
    mesh = Mesh(np.array(devs).reshape(shape), tuple(axes))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(tshape))
    out["placements"].append([
        [[s.start or 0, s.stop if s.stop is not None else n]
         for s, n in zip(idx[d], tshape)]
        for d in mesh.devices.reshape(-1)])

mesh = Mesh(np.array(devs).reshape(2, 2), ("data", "model"))
def run(fn, x, in_specs):
    f = shard_map(fn, mesh=mesh, in_specs=in_specs,
                  out_specs=P(("data", "model")))
    return np.asarray(jax.jit(f)(*x)).tolist()

for name, vals, idx, size in args["sparse"]:
    v = jnp.asarray(np.array(vals, np.float32))
    i = jnp.asarray(np.array(idx, np.int32))
    out[name] = run(lambda v, i: sparse_allreduce(v[0], i[0], size,
                                                  "data")[None],
                    (v, i), (P(("data", "model")), P(("data", "model"))))
for name, xs in args["hier"]:
    x = jnp.asarray(np.array(xs, np.float32))
    out[name] = run(lambda x: hierarchical_psum(x[0], "model",
                                                "data")[None],
                    (x,), (P(("data", "model")),))
print(json.dumps(out))
'''


def _dyadic(rng, shape):
    return (rng.integers(-64, 64, size=shape) / 8.0).astype(np.float32)


def _collective_inputs():
    rng = np.random.default_rng(3)
    sparse = []
    for name, vals in (("sparse_dyadic", _dyadic(rng, (4, 5))),
                       ("sparse_float", rng.standard_normal((4, 5))
                        .astype(np.float32))):
        idx = rng.integers(0, 9, size=(4, 5)).astype(np.int32)
        idx[0, 1] = idx[0, 0]           # one index twice in one position
        sparse.append((name, vals.tolist(), idx.tolist(), 9))
    hier = [("hier_dyadic", _dyadic(rng, (4, 6, 2)).tolist()),
            ("hier_float", rng.standard_normal((4, 6, 2))
             .astype(np.float32).tolist())]
    return sparse, hier


@pytest.fixture(scope="module")
def jax_child():
    sparse, hier = _collective_inputs()
    payload = json.dumps({"placements": [
        [list(s), list(a), [list(e) if isinstance(e, tuple) else e
                            for e in sp], list(t)]
        for s, a, sp, t in PLACEMENTS], "sparse": sparse, "hier": hier})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(_CHILD),
                          payload], env=env, capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(PLACEMENTS)))
def test_blocks_are_jax_named_sharding_blocks(case, jax_child):
    shape, axes, spec, tshape = PLACEMENTS[case]
    mesh = Mesh(shape, axes, CPU4)
    x = torch.arange(int(np.prod(tshape)), dtype=torch.float32) \
        .reshape(tshape)
    st = TS.device_put(x, mesh, TS.P(*spec))
    want = jax_child["placements"][case]
    for pos in range(mesh.size):
        sl = st.layout.slices(st.layout.block_of(pos))
        got = [[s.start, s.stop] for s in sl]
        assert got == want[pos], (pos, got, want[pos])
        assert torch.equal(st.shards[pos], x[sl])
    # gather is the inverse, bitwise
    assert torch.equal(TS.gather(st), x)


@pytest.mark.parametrize("kind", ["dyadic", "float"])
def test_sparse_allreduce_and_hierarchical_psum_match_shard_map(kind,
                                                                jax_child):
    sparse, hier = _collective_inputs()
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    (name, vals, idx, size), = [s for s in sparse if s[0].endswith(kind)]
    got = TC.sparse_allreduce(mesh, [torch.tensor(v) for v in vals],
                              [torch.tensor(i) for i in idx], size, "data")
    want = np.array(jax_child[name], np.float32).reshape(4, size)
    (hname, xs), = [h for h in hier if h[0].endswith(kind)]
    hgot = TC.hierarchical_psum(mesh, [torch.tensor(x) for x in xs],
                                "model", "data")
    hwant = np.array(jax_child[hname], np.float32).reshape(4, 6, 2)
    for pos in range(4):
        if kind == "dyadic":
            np.testing.assert_array_equal(got[pos].numpy(), want[pos])
            np.testing.assert_array_equal(hgot[pos].numpy(), hwant[pos])
        else:
            np.testing.assert_allclose(got[pos].numpy(), want[pos],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(hgot[pos].numpy(), hwant[pos],
                                       rtol=1e-6, atol=1e-6)
    assert mesh.bytes["sparse_allreduce"] > 0
    assert mesh.bytes["hierarchical_psum"] > 0


def test_reshard_round_trips_bitwise():
    """A whole state onto a 2 × 2 mesh, onto (1, 2) and back onto 4 × 1:
    every leaf gathers to the original bits, each shard of the step
    counter is the scalar, and donating releases the old shards."""
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((8, 6), generator=g),
             "e": torch.randn((4, 3, 2), generator=g),
             "step": torch.tensor(7, dtype=torch.int32)}
    specs = {"w": TS.P(("data", "model"), None),
             "e": TS.P("model", None, None), "step": TS.P()}
    square = Mesh((2, 2), ("data", "model"), CPU4)
    a = reshard(state, square, specs)
    assert square.bytes == {}               # whole leaves: no collective
    b = reshard(a, Mesh((1, 2), ("data", "model"), CPU4[:2]), specs,
                donate=True)
    assert all(not x.shards for x in a.values())
    # bytes counted on the old mesh: the blocks position 0 did not hold
    assert square.bytes["reshard"] == 4 * (3 * 8 * 6 // 4 + 4 * 3 * 2 // 2)
    assert b["e"].mesh.bytes == {}
    c = reshard(b, Mesh((4, 1), ("data", "model"), CPU4), specs)
    for k in state:
        assert torch.equal(TS.gather(c[k]), state[k])
        assert torch.equal(TS.gather(b[k]), state[k])
    assert [int(s) for s in c["step"].shards] == [7] * 4
    # 4 × 1: w in 4 blocks of (2, 6), e whole (model is 1), the step
    assert TS.position_bytes(c) == [4 * 12 + 4 * 24 + 4] * 4


def test_uneven_or_unknown_axes_are_refused():
    mesh = Mesh((2, 2), ("data", "model"), CPU4)
    with pytest.raises(ValueError, match="does not split"):
        TS.device_put(torch.zeros((3, 2)), mesh, TS.P("data"))
    with pytest.raises(ValueError, match="has no axis"):
        TS.device_put(torch.zeros((4, 2)), mesh, TS.P("pod"))
    with pytest.raises(ValueError, match="twice"):
        TS.device_put(torch.zeros((4, 2)), mesh, TS.P("data", "data"))


# -- compression --------------------------------------------------------------------

def _grad_trees(seed, ties):
    rng = np.random.default_rng(seed)
    draw = ((lambda s: rng.integers(-3, 4, size=s).astype(np.float32))
            if ties else
            (lambda s: rng.standard_normal(s).astype(np.float32)))
    return {"w": draw((32, 16)), "b": draw((16,)),
            "moe": {"wg": draw((4, 8, 6)), "router": draw((8, 4))}}


@pytest.mark.parametrize("ratio,ties", [(0.01, False), (0.1, False),
                                        (0.5, False), (0.1, True),
                                        (0.37, True), (1.0, False)])
def test_compress_grads_is_bitwise_the_reference(ratio, ties):
    from repro.optim.compression import compress_grads as rcompress
    from repro.optim.compression import compression_init as rinit
    g0 = _grad_trees(0, ties)
    rstate = rinit(jax.tree.map(jnp.asarray, g0))
    tstate = compression_init(jax.tree.map(torch.from_numpy, g0))
    for step in range(3):
        g = _grad_trees(10 + step, ties)
        rsent, rstate = rcompress(jax.tree.map(jnp.asarray, g), rstate,
                                  ratio)
        tsent, tstate = compress_grads(jax.tree.map(torch.from_numpy, g),
                                       tstate, ratio)
        for a, b in zip(jax.tree.leaves(tsent), jax.tree.leaves(rsent)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(jax.tree.leaves(tstate.residual),
                        jax.tree.leaves(rstate.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if ties:   # ties with the k-th value are all kept, as the reference
        kept = sum(int((t != 0).sum()) for t in jax.tree.leaves(tsent))
        size = sum(t.numel() for t in jax.tree.leaves(tsent))
        assert kept > ratio * size
