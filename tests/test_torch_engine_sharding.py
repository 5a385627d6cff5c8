"""The port's device mesh end to end: buckets, engines and servers over
``["cpu"] * 2`` and ``["cpu"] * 4`` against its own replicated path, and
against the JAX package's sharded server.

Within the port every result is held bitwise: the 2-D ``(q, g)`` bucket
match (all five ``GRayResult`` fields), and whole streams — batch mode,
incremental mode with every step a storm (full-graph label RWR and match
on the graph axis) and incremental mode on induced subgraphs — with edge
partitioning off and on: per-step deltas, graphs, final stores (matched
ids, goodness, exact flags) and the warm-start label table. The JAX
package's sharded ``MatchServer`` runs in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (never set in this
process); the port's run on ``["cpu"] * 4`` must give its deltas, store
keys and exact flags exactly, the stored goodness within 1e-5 relative
(``test_torch_serving.py``'s tolerance) and the label table within 1e-6
relative (``test_torch_rwr.py``'s: float sums in another order). Also:
the watchdog's partition-pressure signal against a numpy recount,
checkpoints across mesh layouts and packages, and the executor pool on a
graph-sharded engine.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.data.temporal as tdata
from repro_torch.config.base import EngineConfig as TEngCfg
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.config.base import ServingConfig as TServCfg
from repro_torch.core.graph import ell_from_graph, new_graph, to_numpy
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.core.rwr import label_rwr
from repro_torch.engine import Engine as TEngine
from repro_torch.engine.buckets import QueryBucket
from repro_torch.serving.server import MatchServer as TServer

torch.set_num_threads(1)
CPU = "cpu"
N, K = 256, 8
GOOD_RTOL = 1e-5
RWR_RTOL = 1e-6
SPEC = dict(name="toy", kind="sparse_dense", n_vertices=N, n_edges=2048,
            n_steps=24, seed=5, churn=0.2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(backend):
    return TCfg(n_max=N, e_max=8192, ell_width=K, rwr_iters=8,
                rwr_iters_incremental=3, top_k_patterns=6,
                init_community_size=32, backend=backend)


def _stream(n_steps=3):
    return tdata.generate_stream(tdata.TemporalGraphSpec(**SPEC),
                                 n_measured_steps=n_steps, u_max=128,
                                 device=CPU)


# -- the bucket match on the mesh ---------------------------------------------

MESHES = {  # name → (shard, g_shards, q_budget) for nd devices
    "q": lambda nd: ("auto", 1, nd),
    "qg": lambda nd: ("auto", 2, nd // 2),
    "g": lambda nd: ("off", nd, 1),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("backend", ["coo", "ell", "part"])
@pytest.mark.parametrize("nd", [2, 4])
def test_bucket_mesh_match_equals_replicated(nd, backend, mesh):
    from repro_torch.core.graph import EdgePartition, EllCache
    rng = np.random.default_rng(1)
    g = new_graph(N, 4096, labels=rng.integers(0, 4, N).astype(np.int32),
                  senders=rng.integers(0, N, 500),
                  receivers=rng.integers(0, N, 500), device=CPU)
    cfg = _cfg("coo" if backend == "part" else backend)
    shard, g_shards, q_budget = MESHES[mesh](nd)
    devs = [CPU] * nd
    ell = ell_from_graph(g, K) if backend == "ell" else None
    mesh_ell = part = None
    if backend == "ell" and g_shards > 1:
        cache = EllCache(N, 4096, K, n_shards=g_shards,
                         devices=devs[:g_shards])
        cache.rebuild(g)
        mesh_ell = cache.ell
    elif backend == "ell":
        mesh_ell = ell
    if backend == "part" and g_shards > 1:
        ep = EdgePartition(N, 4096, g_shards, devices=devs[:g_shards])
        ep.rebuild(g)
        part = ep.part
    sharded = QueryBucket(cfg, 8, 8, 4, shard=shard, g_shards=g_shards,
                          q_budget=q_budget, device=CPU, devices=devs)
    plain = QueryBucket(cfg, 8, 8, 4, shard="off", device=CPU)
    assert (sharded.n_shards, sharded.g_shards) == (
        min(4, q_budget) if shard == "auto" else 1, g_shards)
    assert sharded._sharded is not None and plain._sharded is None
    for i, q in enumerate(t_zoo(4)):
        sharded.register(f"q{i}", q)
        plain.register(f"q{i}", q)
    r_lab = label_rwr(g, cfg.n_labels, iters=cfg.rwr_iters, ell=ell)
    got = sharded.match(g, r_lab, ell=mesh_ell, graph_sharded=True,
                        part=part)
    want = plain.match(g, r_lab, ell=ell)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# -- whole streams ------------------------------------------------------------

LAYOUTS = {  # name → (n devices, ServingConfig/EngineConfig knobs)
    "q4": (4, dict(shard="auto")),
    "g2": (2, dict(shard="off", graph_shard="auto")),
    "g4": (4, dict(shard="off", graph_shard="auto")),
    "g4-part": (4, dict(shard="off", graph_shard="auto",
                        edge_partition="on")),
    "q2g2": (4, dict(shard="auto", graph_shard="auto")),
    "q2g2-part": (4, dict(shard="auto", graph_shard="auto",
                          edge_partition="on")),
}
# the induced-subgraph path keeps the graph replicated (only the query
# axis splits it), so it runs the layouts that differ there
MODE_LAYOUTS = {"batch": ("g2", "g4-part", "q2g2"),
                "storm": tuple(LAYOUTS),
                "induced": ("q4", "q2g2-part")}


def _run_batch(backend, nd, knobs):
    eng = TEngine(_cfg(backend), TEngCfg(mode="batch", **knobs),
                  device=CPU, devices=[CPU] * nd)
    for q in t_zoo(8):
        eng.register(q)
    st = _stream()
    state = eng.init_state(st.graph)
    deltas = []
    for upd in st.updates:
        state, out = eng.step(state, upd)
        deltas.append(out.deltas)
    return eng, deltas, state.graph, state.r_lab, [
        dict(eng.stores[q]._patterns) for q in eng.qids]


def _run_server(backend, nd, knobs, storm):
    frac = -1.0 if storm else 0.5
    srv = TServer(_cfg(backend), t_zoo(8),
                  TServCfg(microbatch_window=256, adaptive=False,
                           full_graph_frac=frac, **knobs),
                  seed=0, device=CPU, devices=[CPU] * nd)
    st = _stream()
    g, stats = srv.run(st.graph, st.updates)
    assert all(s.n_recompute > 0 for s in stats)
    return srv.engine, [s.deltas for s in stats], g, srv._state.r_lab, [
        dict(s._patterns) for s in srv.stores]


@pytest.mark.parametrize("mode", ["batch", "storm", "induced"])
@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_streams_on_the_mesh_equal_replicated(backend, mode):
    def run(nd, knobs):
        if mode == "batch":
            return _run_batch(backend, nd, knobs)
        return _run_server(backend, nd, knobs, storm=mode == "storm")

    want = run(1, {})
    assert sum(len(s) for s in want[4]) > 0
    for name in MODE_LAYOUTS[mode]:
        nd, knobs = LAYOUTS[name]
        eng, deltas, g, r_lab, stores = run(nd, knobs)
        if "g" in name:
            assert eng.g_shards == (2 if "q2" in name or nd == 2 else 4)
            assert eng.partitioned == name.endswith("part")
        if name.startswith("q"):
            assert any(b.n_shards > 1 for b in eng.buckets.values()), name
        assert deltas == want[1], name
        for a, b in zip(g, want[2]):
            assert torch.equal(a, b), name
        assert (r_lab is None) == (want[3] is None), name
        assert r_lab is None or torch.equal(r_lab, want[3]), name
        assert stores == want[4], name


def test_pooled_executors_on_a_partitioned_mesh_equal_serial():
    """Two executors drain a flash-crowd workload on a graph-sharded,
    partitioned engine with stores equal to the single-executor run (the
    dispatch lock keeps each bucket's mesh sweeps whole)."""
    from repro_torch.config.base import RuntimeConfig
    from repro_torch.runtime import (ServingRuntime, VirtualClock,
                                     build_workload, flash_crowd)
    wl = build_workload(flash_crowd(rate=2500.0, tick_s=0.01, n_ticks=5,
                                    n_vertices=N, seed=3), u_max=256,
                        device=CPU)
    stores = {}
    for n in (1, 2):
        # a flash crowd piles receivers onto a few hot slices: headroom 4
        # lets any one slice hold every live arc
        srv = TServer(_cfg("coo"), t_zoo(4),
                      TServCfg(microbatch_window=64, shard="off",
                               graph_shard="auto", edge_partition="on",
                               partition_headroom=4.0, full_graph_frac=-1.0),
                      seed=0, device=CPU, devices=[CPU] * 4)
        assert srv.engine.g_shards == 4 and srv.engine.partitioned
        rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep",
                                               n_executors=n),
                            clock=VirtualClock())
        rt.serve(wl)
        assert srv.engine._exec_pool is None  # torn down after the drain
        stores[n] = [dict(s._patterns) for s in srv.stores]
    assert stores[1] == stores[2] and any(stores[1])


# -- the watchdog's partition signal ------------------------------------------

@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_partition_occupancy_recount_and_pressure(backend):
    from repro_torch.obs.health import DEGRADED, OK, HealthMonitor
    srv = TServer(_cfg(backend), t_zoo(4),
                  TServCfg(microbatch_window=256, adaptive=False,
                           shard="off", graph_shard="auto",
                           edge_partition="on", full_graph_frac=-1.0),
                  seed=0, device=CPU, devices=[CPU] * 4)
    eng = srv.engine
    st = _stream()
    g, _ = srv.run(st.graph, st.updates)
    occ = eng.partition_occupancy()
    if backend == "coo":
        live = to_numpy(g.receivers)[to_numpy(g.edge_mask)]
        per_slice = np.bincount(live // (N // 4), minlength=4)
        assert occ == per_slice.max() / eng.part_cache.e_cap_slice
    else:
        cache = eng.ell_cache
        rows = [sum(len(cache._rows[v]) for v in range(d * N // 4,
                                                      (d + 1) * N // 4))
                for d in range(4)]
        assert occ == max(rows) / cache.r_cap_block
    assert 0 < occ < 1
    for near, want in ((occ, DEGRADED), (occ + 1e-3, OK)):
        mon = HealthMonitor(partition_near_frac=near)
        mon.attach_partition(eng.partition_occupancy)
        assert mon.check(now=0.0) == want
        assert [e.kind for e in mon.events] == (
            ["partition_pressure"] if want == DEGRADED else [])
    replicated = TServer(_cfg(backend), t_zoo(1),
                         TServCfg(adaptive=False, shard="off",
                                  graph_shard="auto"),
                         device=CPU, devices=[CPU] * 4)
    assert replicated.engine.partition_occupancy() is None


# -- checkpoints across mesh layouts and packages -----------------------------

MESH4 = dict(shard="off", graph_shard="auto", edge_partition="on")


def _ckpt_server(devices, knobs, backend="coo"):
    return TServer(_cfg(backend), t_zoo(4),
                   TServCfg(microbatch_window=256, adaptive=False,
                            full_graph_frac=-1.0, **knobs),
                   seed=0, device=CPU, devices=devices)


def _resume(srv, graph, ckpt, updates):
    srv.load(graph, str(ckpt))
    srv.run(srv.graph, updates)
    return [dict(s._patterns) for s in srv.stores]


def test_checkpoints_cross_mesh_layouts_and_packages(tmp_path):
    """A checkpoint saved by a partitioned g = 4 server resumes under g = 1
    and in the JAX package (one device) as it resumes under g = 4; one
    saved under g = 1, or by the JAX package, resumes under g = 4 as under
    g = 1. The mirrors are caches rebuilt from the restored graph."""
    from repro.config.base import IGPMConfig as RCfg
    from repro.config.base import ServingConfig as RServCfg
    from repro.core.query import query_zoo as r_zoo
    from repro.data.temporal import TemporalGraphSpec as RSpec
    from repro.data.temporal import generate_stream as r_stream
    from repro.serving.server import MatchServer as RServer
    st = _stream(6)
    half = 3
    meshed = _ckpt_server([CPU] * 4, MESH4)
    assert meshed.engine.g_shards == 4 and meshed.engine.partitioned
    meshed.run(st.graph, st.updates[:half])
    ckpt = tmp_path / "g4"
    meshed.save(str(ckpt))
    want = _resume(meshed, st.graph, ckpt, st.updates[half:])
    got = _resume(_ckpt_server([CPU], {}), st.graph, ckpt,
                  st.updates[half:])
    assert got == want

    r_st = r_stream(RSpec(**SPEC), n_measured_steps=6, u_max=128)
    ref = RServer(RCfg(**{f: getattr(_cfg("coo"), f) for f in (
        "n_max", "e_max", "ell_width", "rwr_iters", "rwr_iters_incremental",
        "top_k_patterns", "init_community_size", "backend")}), r_zoo(4),
        RServCfg(microbatch_window=256, adaptive=False, full_graph_frac=-1.0),
        seed=0)
    ref.load(r_st.graph, str(ckpt))
    ref.run(ref.graph, r_st.updates[half:])
    _same_stores([dict(s._patterns) for s in ref.stores], want)

    # the reverse: saved under g = 1, and by the JAX package
    single = _ckpt_server([CPU], {})
    single.run(st.graph, st.updates[:half])
    ckpt1 = tmp_path / "g1"
    single.save(str(ckpt1))
    ref.load(r_st.graph, str(ckpt))
    ref.run(ref.graph, r_st.updates[half:half + 1])
    ckpt_r = tmp_path / "ref"
    ref.save(str(ckpt_r))
    for path, rest in ((ckpt1, st.updates[half:]),
                       (ckpt_r, st.updates[half + 1:])):
        want = _resume(_ckpt_server([CPU], {}), st.graph, path, rest)
        assert _resume(_ckpt_server([CPU] * 4, MESH4), st.graph, path,
                       rest) == want


def _same_stores(ref, port):
    """Keys (matched ids) and exact flags equal, goodness within 1e-5."""
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert sorted(a) == sorted(b)
        for key, (good, exact) in a.items():
            assert b[key][1] == exact
            np.testing.assert_allclose(b[key][0], good, rtol=GOOD_RTOL)


# -- the JAX package's sharded server -----------------------------------------

_CHILD = """
import pickle, sys
import jax
import numpy as np
assert len(jax.devices()) == 4, jax.devices()
import repro.engine.sharding as rsh
_shard_map = rsh.shard_map


def shard_map(f, **kw):
    # jax >= 0.7 renamed check_rep to check_vma
    if "check_rep" in kw:
        kw["check_vma"] = kw.pop("check_rep")
    return _shard_map(f, **kw)


rsh.shard_map = shard_map
from repro.config.base import IGPMConfig, ServingConfig
from repro.core.query import query_zoo
from repro.data.temporal import TemporalGraphSpec, generate_stream
from repro.serving import MatchServer
out = {}
for backend in ("coo", "ell"):
    cfg = IGPMConfig(n_max=%(N)d, e_max=8192, ell_width=%(K)d, rwr_iters=8,
                     rwr_iters_incremental=3, top_k_patterns=6,
                     init_community_size=32, backend=backend)
    srv = MatchServer(cfg, query_zoo(8), ServingConfig(
        microbatch_window=256, adaptive=False, shard="auto",
        graph_shard="auto", edge_partition="on", full_graph_frac=-1.0),
        seed=0)
    eng = srv.engine
    assert eng.g_shards == 2 and eng.partitioned
    assert any(b.n_shards > 1 for b in eng.buckets.values())
    stream = generate_stream(TemporalGraphSpec(**%(SPEC)r),
                             n_measured_steps=3, u_max=128)
    g, stats = srv.run(stream.graph, stream.updates)
    out[backend] = dict(
        deltas=[[tuple(d) for d in s.deltas] for s in stats],
        stores=[dict(s._patterns) for s in srv.stores],
        graph={f: np.asarray(getattr(g, f)) for f in g._fields},
        r_lab=np.asarray(srv._state.r_lab))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def test_sharded_server_matches_the_reference_sharded_server(tmp_path):
    out = tmp_path / "reference.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_CHILD % dict(
            N=N, K=K, SPEC=SPEC)), str(out)],
        env=env, capture_output=True, text=True, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    for backend in ("coo", "ell"):
        srv = TServer(_cfg(backend), t_zoo(8), TServCfg(
            microbatch_window=256, adaptive=False, shard="auto",
            graph_shard="auto", edge_partition="on", full_graph_frac=-1.0),
            seed=0, device=CPU, devices=[CPU] * 4)
        eng = srv.engine
        assert (eng.g_shards, eng.q_budget, eng.partitioned) == (2, 2, True)
        st = _stream()
        g, stats = srv.run(st.graph, st.updates)
        want = ref[backend]
        assert [[tuple(d) for d in s.deltas] for s in stats] == \
            want["deltas"]
        for f in g._fields:
            np.testing.assert_array_equal(to_numpy(getattr(g, f)),
                                          want["graph"][f], err_msg=f)
        _same_stores(want["stores"], [dict(s._patterns)
                                      for s in srv.stores])
        np.testing.assert_allclose(to_numpy(srv._state.r_lab),
                                   want["r_lab"], rtol=RWR_RTOL, atol=0)
