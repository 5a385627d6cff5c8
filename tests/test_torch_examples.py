"""The port's three example entry points (``src/repro_torch/examples``)
against the JAX package's scripts (``examples/``), each side built from
its package's library calls in the script's order at a reduced size, on
the CPU:

* quickstart (the friends2008 twin at scale 0.002, 3 measured steps after
  a warm pass of 3): Batch, Inc and Adaptive, each step's new, total and
  exact pattern counts and recompute set size, and the store's keys and
  exact flags after every step (warm pass included), bitwise. Adaptive
  under the two things that cannot cross the frameworks pinned as
  ``tests/test_torch_adaptive.py`` pins them: the port's DQN starts from
  the reference agent's ``state_dict``, and both PEMs' rewards read one
  seeded time schedule (the example's ``reward_time``).
* dynamic_gnn_serving (512 nodes, 4,096 edges, 3 steps; the encoder's
  weights from ``gnn_params_from_jax``, the reference's features): the
  recompute masks and community sizes bitwise, the served embeddings
  within 1e-5 of their largest entry, the staleness within 1e-4.
* train_lm (smollm-135m cut to 2 layers, d 64, vocab 256, seq 16, batch 4;
  8 steps, ``checkpoint_every`` 4; weights from ``params_from_jax``):
  losses within rtol 1e-5 of the reference's ``TrainLoop``; a run killed
  after step 3 and started again on its directory resumes at step 4, and
  its steps 4–7 and final weights are bitwise an uninterrupted run's.
* A child process imports the three modules and finds neither ``jax``
  nor ``repro`` in ``sys.modules``.

JAX is imported inside the tests that need it.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import dynamic_gnn_serving as TG
from repro_torch.examples import quickstart as TQ
from repro_torch.examples import train_lm as TT

from test_torch_adaptive import seeded_elapsed

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SCALE = 0.002          # the quickstart's twin: 449 vertices, 7,743 edges
QS_STEPS = 3
EMB_RTOL = 1e-5
DRIFT_RTOL = 1e-4
LOSS_RTOL = 1e-5


def _seeded_time(seed=3):
    """``seeded_elapsed``'s schedule as the examples' ``reward_time``."""
    rng = np.random.default_rng(seed)
    return lambda elapsed: float(rng.uniform(0.02, 0.2))


def _record_stores(matcher):
    """Keep the store's (key, exact) set after every ``step`` call."""
    seen, step = [], matcher.step

    def recorded(g, upd):
        out = step(g, upd)
        seen.append(sorted((k, e) for k, (_, e)
                           in matcher.store._patterns.items()))
        return out
    matcher.step = recorded
    return seen


def _reference_quickstart(name):
    """The reference script's matcher loop at ``SCALE``: the matcher, its
    DQN's state before the warm pass (adaptive), each measured step's
    stats and the stores after each step."""
    from repro.config.base import IGPMConfig
    from repro.core.matcher import (AdaptiveMatcher, BatchMatcher,
                                    NaiveIncrementalMatcher)
    from repro.core.query import square
    from repro.data.temporal import generate_stream, scaled_twin
    spec = scaled_twin("friends2008", scale=SCALE, n_steps=200)
    cfg = IGPMConfig(n_max=spec.n_vertices,
                     e_max=int(2.4 * spec.n_edges) + 4096,
                     rwr_iters=15, rwr_iters_incremental=4,
                     top_k_patterns=10, init_community_size=64)
    cls = {"batch": BatchMatcher, "inc": NaiveIncrementalMatcher,
           "adaptive": AdaptiveMatcher}[name]
    matcher = cls(square(), cfg)
    agent = None
    if name == "adaptive":
        agent = matcher.pem.agent.state_dict()
        seeded_elapsed(matcher.pem)
    stores = _record_stores(matcher)
    stream = generate_stream(spec, n_measured_steps=QS_STEPS)
    g = stream.graph
    for upd in stream.updates:
        g, _ = matcher.step(g, upd)
    matcher.reset()
    stream = generate_stream(spec, n_measured_steps=QS_STEPS)
    g = stream.graph
    steps = []
    for upd in stream.updates:
        g, st = matcher.step(g, upd)
        steps.append(st)
    return matcher, agent, steps, stores


def _counts(st):
    return (st.n_new_patterns, st.n_patterns_total, st.n_exact_total,
            st.n_recompute, st.community_size)


@pytest.mark.parametrize("name", ["batch", "inc", "adaptive"])
def test_quickstart_matches_the_reference_script(name):
    pytest.importorskip("jax")
    ref, agent, ref_steps, ref_stores = _reference_quickstart(name)
    spec, cfg, query = TQ.stream_config(scale=SCALE)
    adaptive = name == "adaptive"
    # both agents start from the reference's state before its warm pass
    # and learn alike under one reward schedule
    matcher = TQ.build(name, query, cfg, CPU, agent=agent,
                       reward_time=_seeded_time() if adaptive else None)
    stores = _record_stores(matcher)
    res = TQ.run(matcher, spec, CPU, n_measured=QS_STEPS)
    assert spec.n_vertices == ref.cfg.n_max
    assert [_counts(s) for s in res["steps"]] == \
        [_counts(s) for s in ref_steps]
    assert stores == ref_stores
    assert (res["patterns"], res["exact"]) == (ref.store.total,
                                                ref.store.exact)
    assert res["patterns"] > 0
    if adaptive:
        assert len({s.community_size for s in res["steps"]}) > 1


def test_dynamic_gnn_serving_matches_the_reference_script():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.config.base import GNNConfig, IGPMConfig
    from repro.core.graph import apply_update, updated_vertices
    from repro.core.pem import PartialExecutionManager
    from repro.data.temporal import TemporalGraphSpec, generate_stream
    from repro.models.gnn.common import GraphInputs
    from repro.models.gnn.meshgraphnet import MeshGraphNet
    from repro_torch.models.gnn.common import gnn_params_from_jax
    n, e, steps = 512, 4096, 3
    # the reference script at 512 nodes
    spec = TemporalGraphSpec("serving", "sparse_dense", n_vertices=n,
                             n_edges=e, n_steps=200, seed=3)
    stream = generate_stream(spec, n_measured_steps=steps)
    model = MeshGraphNet(GNNConfig(kind="meshgraphnet", n_layers=3,
                                   d_hidden=32, mlp_layers=2, d_out=1))
    params = model.init(jax.random.PRNGKey(0), d_feat=16, d_edge=4)
    feats = jax.random.normal(jax.random.PRNGKey(1), (n, 16))
    pem = PartialExecutionManager(
        IGPMConfig(n_max=n, e_max=stream.graph.e_max,
                   init_community_size=64), adaptive=True, seed=0)
    agent = pem.agent.state_dict()
    seeded_elapsed(pem)

    def encode(g):
        em = np.asarray(g.edge_mask)
        inputs = GraphInputs(
            node_feat=feats, senders=jnp.asarray(np.asarray(g.senders)[em]),
            receivers=jnp.asarray(np.asarray(g.receivers)[em]),
            targets=jnp.zeros((n, 1)))
        return model.forward(params, inputs)
    g = stream.graph
    emb = encode(g)
    want = []
    for upd in stream.updates:
        g = apply_update(g, upd)
        ids, mask = updated_vertices(g, upd, 4096)
        full = encode(g)
        rec_mask, frac = pem.recompute_mask(
            g, np.asarray(jnp.where(mask, ids, -1)))
        stale = jnp.where(jnp.asarray(rec_mask)[:, None], encode(g), emb)
        drift = float(jnp.linalg.norm(full - stale, axis=1).max())
        emb = stale
        c, _ = pem.feedback(g, frac, 0.0)
        want.append((rec_mask, c, np.asarray(emb), drift))
    # the port's example on the same weights, features and agent
    inputs = TG.build(CPU, params=gnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device=CPU),
        feats=torch.from_numpy(np.array(feats)), agent=agent,
        n_vertices=n, n_edges=e, n_measured=steps)
    got = TG.run(inputs, reward_time=_seeded_time(), print_fn=lambda *a: 0)
    assert len(got) == steps
    for rec, (mask, c, emb, drift) in zip(got, want):
        np.testing.assert_array_equal(rec["mask"], mask)
        assert rec["c"] == c
        err = float(np.abs(rec["emb"].numpy() - emb).max())
        assert err <= EMB_RTOL * float(np.abs(emb).max()), err
        assert rec["drift"] == pytest.approx(drift, rel=DRIFT_RTOL)
    assert len({rec["c"] for rec in got}) > 1


def _lm_cfgs():
    from repro.config.registry import get_arch as r_get_arch
    from repro_torch.config.registry import get_arch
    cut = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab_size=256, dtype="float32", remat="none")
    return (dataclasses.replace(r_get_arch("smollm-135m").model, **cut),
            dataclasses.replace(get_arch("smollm-135m").model, **cut))


def test_train_lm_matches_the_reference_script_and_restarts(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.config.base import TrainConfig
    from repro.data.lm import TokenPipeline
    from repro.models.transformer import TransformerLM
    from repro.train.loop import TrainLoop
    from repro.train.state import make_train_step, new_train_state
    from repro_torch.models.transformer import params_from_jax
    rcfg, cfg = _lm_cfgs()
    steps, batch, seq = 8, 4, 16
    # the reference script's loop
    rmodel = TransformerLM(rcfg)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=20,
                       total_steps=steps, checkpoint_every=4,
                       checkpoint_dir=str(tmp_path / "ref"))
    pipe = TokenPipeline(rcfg.vocab_size, batch, seq, seed=0)

    def batch_fn(step):
        t, l = pipe.batch_at(step)
        return jnp.asarray(t), jnp.asarray(l)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    # the loop donates the state: keep the weights for the port first
    start = jax.tree_util.tree_map(np.array, rparams)
    loop = TrainLoop(make_train_step(rmodel.loss, tcfg),
                     new_train_state(rparams), batch_fn, tcfg,
                     log_every=10, print_fn=lambda *a: 0)
    want = loop.run(n_steps=steps).losses

    def port_loop(where):
        params = params_from_jax(cfg, start, device=CPU,
                                 dtype=torch.float32)
        return TT.build(cfg, steps, batch, seq, str(tmp_path / where), CPU,
                        params=params, checkpoint_every=4,
                        print_fn=lambda *a: 0)
    whole = port_loop("whole")
    got = TT.run(whole, steps).losses
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # killed after step 3 (its checkpoint committed), then run again
    first = port_loop("restart")
    assert TT.run(first, 4).steps == [0, 1, 2, 3]
    again = port_loop("restart")
    assert again.start_step == 4
    rest = TT.run(again, steps)
    assert rest.steps == [4, 5, 6, 7]
    assert rest.losses == got[4:]
    from repro_torch.optim.adamw import tree_leaves
    for a, b in zip(tree_leaves(whole.state), tree_leaves(again.state)):
        assert torch.equal(a, b)


def test_examples_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.dynamic_gnn_serving\n"
            "import repro_torch.examples.train_lm\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
