"""The port's async serving runtime against the JAX package's.

At the toy sizes of the reference's runtime tests (n_max 128, 10 ticks at
2,500 events/s over 128 vertices): ``build_workload`` deals the
reference's events into the reference's ticks for every scenario; the
lockstep ``ServingRuntime`` is bitwise equal to ``run_workload_sync``
(stores, graph arrays, step count, events per step); the port's sync
runner equals the reference's (graph and step accounting exact, stores
with goodness within ``GOOD_RTOL``); a 2-executor pool is bitwise equal
to serial; drains flush every accepted event; an abort returns promptly;
forced back-pressure cannot deadlock; per-query subscriber streams and the
tail-latency channels fill; a closed loop under ``VirtualClock`` gives the
reference's ``AckLedger`` summary exactly; the drain checkpoint restores
into the reference's engine and back; the controller modes build the
serving controller as the reference's runtime does
(``test_torch_control.py`` holds the controller's own parity).
"""

import math
import time

import numpy as np
import pytest
import torch

from repro.config.base import ControlConfig as RCtlCfg
from repro.config.base import IGPMConfig as RCfg
from repro.config.base import RuntimeConfig as RRtCfg
from repro.config.base import ServingConfig as RServCfg
from repro.core.query import query_zoo as r_zoo
from repro.runtime import SCENARIOS as R_SCENARIOS
from repro.runtime import ServingRuntime as RRuntime
from repro.runtime import VirtualClock as RVClock
from repro.runtime import build_workload as r_build
from repro.runtime import run_closed_loop as r_closed
from repro.runtime import run_workload_sync as r_sync
from repro.runtime import sim_service_model as r_model
from repro.serving import MatchServer as RServer
from repro_torch.config.base import ControlConfig, RuntimeConfig
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.config.base import ServingConfig as TServCfg
from repro_torch.core.graph import to_numpy
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.launch import serve as tserve
from repro_torch.runtime import (SCENARIOS, ServingRuntime, VirtualClock,
                                 WallClock, build_workload, churn_heavy,
                                 deal, flash_crowd, poisson,
                                 run_closed_loop, run_workload_sync,
                                 sim_service_model)
from repro_torch.serving import MatchServer as TServer
from repro_torch.serving.telemetry import percentile_min_count
from test_torch_adaptive import _stores_equal

torch.set_num_threads(1)
CPU = "cpu"


def _cfg(cls=TCfg, backend="coo", **kw):
    base = dict(n_max=128, e_max=8192, ell_width=8, rwr_iters=6,
                rwr_iters_incremental=2, top_k_patterns=4,
                init_community_size=32, backend=backend)
    base.update(kw)
    return cls(**base)


def _server(backend="coo", bank=2, **serving_kw):
    serving_kw.setdefault("microbatch_window", 64)
    serving_kw.setdefault("adaptive", False)
    return TServer(_cfg(backend=backend), t_zoo(bank),
                   TServCfg(**serving_kw), seed=0, device=CPU)


def _ref_server(bank=2, **serving_kw):
    serving_kw.setdefault("microbatch_window", 64)
    serving_kw.setdefault("adaptive", False)
    return RServer(_cfg(RCfg), r_zoo(bank), RServCfg(**serving_kw), seed=0)


def _sc_kw(**kw):
    kw.setdefault("rate", 2500.0)
    kw.setdefault("tick_s", 0.01)
    kw.setdefault("n_ticks", 10)
    kw.setdefault("n_vertices", 128)
    kw.setdefault("seed", 3)
    return kw


def _workload(kind=churn_heavy, **kw):
    return build_workload(kind(**_sc_kw(**kw)), u_max=256, device=CPU)


def _graphs_equal(a, b):
    for f in a._fields:
        np.testing.assert_array_equal(to_numpy(getattr(a, f)),
                                      to_numpy(getattr(b, f)), err_msg=f)


# -- scenarios: the reference's ticks ------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_build_workload_matches_reference(name):
    mine = build_workload(SCENARIOS[name](**_sc_kw()), u_max=256, device=CPU)
    theirs = r_build(R_SCENARIOS[name](**_sc_kw()), u_max=256)
    assert mine.n_events == theirs.n_events > 0
    assert mine.spec == type(mine.spec)(**theirs.spec.__dict__)
    assert [t.t for t in mine.ticks] == [t.t for t in theirs.ticks]
    assert [[tuple(e) for e in t.events] for t in mine.ticks] == \
        [[tuple(e) for e in t.events] for t in theirs.ticks]
    for f in mine.graph._fields:
        np.testing.assert_array_equal(to_numpy(getattr(mine.graph, f)),
                                      np.asarray(getattr(theirs.graph, f)))
    # dealing the same stream again reproduces the ticks
    again = deal(mine.scenario, mine.stream)
    assert [t.events for t in again.ticks] == [t.events for t in mine.ticks]


def test_flash_crowd_bursts_dominate_baseline():
    sc = flash_crowd(rate=1000.0, tick_s=0.01, n_ticks=32, n_vertices=64,
                     burst_amplitude=8.0, burst_period=16, burst_len=4,
                     seed=0)
    wl = build_workload(sc, u_max=512, device=CPU)
    sizes = np.array([len(t.events) for t in wl.ticks], np.float64)
    burst = (np.arange(32) % 16) < 4
    assert sizes[burst].mean() > 3 * sizes[~burst].mean()


# -- determinism: lockstep async ≡ sync, port ≡ reference --------------------------

@pytest.mark.parametrize("backend", ["coo", "ell"])
@pytest.mark.parametrize("kind", [churn_heavy, flash_crowd],
                         ids=["churn_heavy", "flash_crowd"])
def test_lockstep_runtime_bitwise_equals_sync(backend, kind):
    wl = _workload(kind)
    ref = _server(backend)
    g_ref, st_ref = run_workload_sync(ref, wl, clock=VirtualClock())
    srv = _server(backend)
    rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep"),
                        clock=VirtualClock())
    st_rt = rt.serve(wl)
    assert len(st_rt) == len(st_ref) > 1
    assert [s.n_events for s in st_rt] == [s.n_events for s in st_ref]
    assert [s.deltas for s in st_rt] == [s.deltas for s in st_ref]
    for a, b in zip(ref.stores, srv.stores):
        assert a._patterns == b._patterns
    _graphs_equal(g_ref, rt.graph)


@pytest.mark.parametrize("kind", ["churn_heavy", "flash_crowd"])
def test_sync_runner_matches_reference(kind):
    """One workload through both packages' ``run_workload_sync``: the same
    step count, events per step, deltas and graph; stores equal with
    goodness within GOOD_RTOL."""
    wl_t = build_workload(SCENARIOS[kind](**_sc_kw()), u_max=256, device=CPU)
    wl_r = r_build(R_SCENARIOS[kind](**_sc_kw()), u_max=256)
    port, ref = _server(), _ref_server()
    g_t, st_t = run_workload_sync(port, wl_t, clock=VirtualClock())
    g_r, st_r = r_sync(ref, wl_r, clock=RVClock())
    assert [s.n_events for s in st_t] == [s.n_events for s in st_r]
    assert [s.deltas for s in st_t] == [s.deltas for s in st_r]
    assert [(s.n_recompute, s.n_pruned) for s in st_t] == \
        [(s.n_recompute, s.n_pruned) for s in st_r]
    for f in g_t._fields:
        np.testing.assert_array_equal(to_numpy(getattr(g_t, f)),
                                      np.asarray(getattr(g_r, f)))
    _stores_equal(ref.stores, port.stores)


def test_multi_executor_store_identical_to_serial():
    """The per-bucket fan-out pool is pure plumbing: with four zoo shapes
    (four buckets) a 2-executor drain gives the serial stores bitwise, and
    the pool is torn down after the drain."""
    wl = _workload(flash_crowd, seed=7)
    stores = {}
    for n in (1, 2):
        srv = _server(bank=4)
        assert len(srv.engine.buckets) > 1
        rt = ServingRuntime(srv, RuntimeConfig(ingress="lockstep",
                                               n_executors=n),
                            clock=VirtualClock())
        stats = rt.serve(wl)
        assert srv.engine._exec_pool is None
        stores[n] = ([dict(s._patterns) for s in srv.stores],
                     [s.deltas for s in stats])
    assert stores[1] == stores[2]


def test_runtime_config_rejects_bad_values_and_the_controller():
    """Bad values are refused; the controller modes build the serving
    controller, as the reference's runtime does (same ladders, attached
    to the engine); ``--control`` without ``--closed-loop`` exits with
    the reference's message."""
    for bad, match in ((RuntimeConfig(n_executors=0), "n_executors"),
                       (RuntimeConfig(handoff_depth=0), "handoff_depth"),
                       (RuntimeConfig(ingress="burst"), "ingress")):
        with pytest.raises(ValueError, match=match):
            ServingRuntime(_server(), bad, clock=VirtualClock())
    for mode in ("train", "frozen"):
        rt = ServingRuntime(_server(),
                            RuntimeConfig(control=ControlConfig(mode=mode)),
                            clock=VirtualClock())
        r_rt = RRuntime(_ref_server(),
                        RRtCfg(control=RCtlCfg(mode=mode)), clock=RVClock())
        ctl, r_ctl = rt.controller, r_rt.controller
        assert ctl.mode == r_ctl.mode == mode
        assert rt.server.engine.control is ctl
        assert (ctl.env.window_ladder, ctl.env.depth_ladder,
                ctl.env.tol_ladder) == (r_ctl.env.window_ladder,
                                        r_ctl.env.depth_ladder,
                                        r_ctl.env.tol_ladder)
    with pytest.raises(SystemExit, match="--control wants --closed-loop"):
        tserve.main(["--arch", "igpm-pem", "--device", "cpu", "--async",
                     "--control", "train"])


# -- drain, abort, back-pressure ---------------------------------------------------

def test_end_of_stream_drain_flushes_every_event():
    wl = _workload(poisson, n_ticks=8)
    srv = _server(coalesce=False, queue_depth=100_000)
    stats = ServingRuntime(srv, clock=VirtualClock()).serve(wl)
    q = srv.queue
    assert q.n_offered == wl.n_events > 0
    assert q.n_dropped == 0 and len(q) == 0
    assert sum(s.n_events for s in stats) == q.n_offered


def test_stop_drain_flushes_all_accepted_events():
    wl = _workload(poisson, n_ticks=40)
    srv = _server(coalesce=False, queue_depth=100_000)
    rt = ServingRuntime(srv, clock=VirtualClock())
    rt.start(wl)
    deadline = time.monotonic() + 60.0
    while not rt.stats and time.monotonic() < deadline:
        time.sleep(0.001)
    assert rt.stop(drain=True)
    q = srv.queue
    assert 0 < q.n_offered <= wl.n_events
    assert len(q) == 0
    assert sum(s.n_events for s in rt.stats) == q.n_offered


def test_stop_without_drain_aborts_promptly():
    wl = _workload(poisson, n_ticks=200, tick_s=0.05)  # a 10 s workload
    srv = _server(bank=1)
    rt = ServingRuntime(srv, clock=WallClock())
    rt.start(wl)
    t0 = time.monotonic()
    assert rt.stop(drain=False)
    assert time.monotonic() - t0 < 8.0
    assert len(rt.stats) < 200


def test_no_deadlock_under_forced_backpressure():
    wl = _workload(flash_crowd, rate=6000.0, n_ticks=12)
    srv = _server(queue_depth=32)
    rt = ServingRuntime(srv, RuntimeConfig(ingress="shed", handoff_depth=1,
                                           drain_timeout_s=60.0),
                        clock=VirtualClock())
    rt.start(wl)
    assert rt.join(timeout=120.0), "runtime deadlocked under back-pressure"
    q = srv.queue
    assert q.n_dropped > 0 and q.n_evicted == q.n_dropped
    processed = sum(s.n_events for s in rt.stats)
    assert processed == q.n_offered - q.n_dropped - q.n_coalesced
    snap = srv.telemetry.snapshot()
    assert snap["dropped_events"] == q.n_dropped
    assert snap["evicted_events"] == q.n_evicted


# -- fan-out and telemetry ---------------------------------------------------------

def test_subscribers_receive_per_query_delta_streams():
    wl = _workload(churn_heavy)
    srv = _server(bank=2)
    tri_name = srv.queries[0].name
    rt = ServingRuntime(srv, clock=VirtualClock())
    all_sub = rt.subscribe()
    tri_sub = rt.subscribe(query=tri_name)
    stats = rt.serve(wl)
    got_all, got_tri = all_sub.drain(), tri_sub.drain()
    assert len(got_all) == 2 * len(stats)
    assert len(got_tri) == len(stats)
    assert all(d.query == tri_name for _, d in got_tri)
    last = {d.query: d for _, d in got_all}
    for q, store in zip(srv.queries, srv.stores):
        assert (last[q.name].total, last[q.name].exact) == \
            (store.total, store.exact)


def test_runtime_telemetry_has_tail_latency_channels():
    wl = _workload(poisson, n_ticks=8)
    srv = _server(bank=1)
    ServingRuntime(srv, clock=WallClock()).serve(wl)
    tel = srv.telemetry
    snap = tel.snapshot()
    for ch in ("e2e", "queue_wait", "assembly"):
        resident = min(tel.channel_count(ch), tel.channel_window(ch))
        assert resident > 0
        for q, label in ((50, "p50"), (99, "p99"), (99.9, "p999")):
            key = f"{label}_{ch}_ms"
            if resident >= percentile_min_count(q):
                assert key in snap and snap[key] >= 0.0
            else:
                assert key not in snap
                assert math.isnan(tel.latency_percentile(q, ch, strict=True))
    assert "p99_e2e_ms" in snap and "p99_queue_wait_ms" in snap


# -- closed loop, checkpoints --------------------------------------------------------

def test_closed_loop_summary_matches_reference():
    """Under ``VirtualClock`` and the shared service model, the closed
    loop is a pure function of the seeds: the port's ledger summary and
    offered/throttled counts equal the reference's exactly."""
    kw = _sc_kw(n_ticks=12, closed_loop=True, lag_ref_s=0.05)
    wl_t = build_workload(flash_crowd(**kw), u_max=256, device=CPU)
    wl_r = r_build(R_SCENARIOS["flash_crowd"](**kw), u_max=256)
    port, ref = _server(), _ref_server()
    _, st_t, led_t = run_closed_loop(port, wl_t, clock=VirtualClock(),
                                     service_model=sim_service_model())
    _, st_r, led_r = r_closed(ref, wl_r, clock=RVClock(),
                              service_model=r_model())
    dur = wl_t.scenario.duration_s
    assert led_t.summary(dur) == led_r.summary(dur)
    assert led_t.summary(dur)["events_acked"] > 0
    assert (led_t.closed_src.n_offered, led_t.closed_src.n_throttled) == \
        (led_r.closed_src.n_offered, led_r.closed_src.n_throttled)
    assert [s.n_events for s in st_t] == [s.n_events for s in st_r]


def test_drain_checkpoint_restores_across_packages(tmp_path):
    """The runtime's drain checkpoint (``Engine.save``) restores into the
    reference's server, and a reference checkpoint restores into the
    port's: stores equal in both directions."""
    wl_t = _workload(poisson, n_ticks=6)
    srv = _server(bank=2)
    rt = ServingRuntime(srv, RuntimeConfig(checkpoint_dir=str(tmp_path / "t")),
                        clock=VirtualClock())
    rt.serve(wl_t)
    assert rt.n_checkpoints >= 1
    ref = _ref_server(bank=2)
    wl_r = r_build(R_SCENARIOS["poisson"](**_sc_kw(n_ticks=6)), u_max=256)
    ref.load(wl_r.graph, str(tmp_path / "t"))
    _stores_equal(ref.stores, srv.stores)
    assert [(s.total, s.exact) for s in ref.stores] == \
        [(s.total, s.exact) for s in srv.stores]
    r_sync(ref, wl_r, clock=RVClock())
    ref.save(str(tmp_path / "r"))
    back = _server(bank=2)
    back.load(wl_t.graph, str(tmp_path / "r"))
    _stores_equal(ref.stores, back.stores)
    _graphs_equal(back.graph, type(back.graph)(*(
        torch.as_tensor(np.array(a)) for a in ref.graph)))


# -- the CLI -------------------------------------------------------------------------

def test_cli_async_runs_on_cpu(tmp_path, capsys):
    tserve.main(["--arch", "igpm-pem", "--async", "--scenario",
                 "flash_crowd", "--ticks", "8", "--bank", "2", "--sync-too",
                 "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[serve] sync : steps=" in out and "[serve] async: steps=" in out
    assert f"drained checkpoint -> {tmp_path}" in out
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())
