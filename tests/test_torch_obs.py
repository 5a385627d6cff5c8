"""The port's observability stack against the JAX package's.

Exporters write byte-equal files for one event list and one snapshot, and
the validators give equal verdicts on malformed inputs; the flight
recorder keeps the last N step groups, de-duplicates triggered dumps and
dumps on an SLO breach; with tracing off the engine wires the null tracer
and emits nothing. On one seeded toy stream served by both packages with
tracing on, each step emits the same ordered span names with the same
non-timing ``args`` keys, ``stage_s`` has the same keys, and stores and
deltas stay bitwise equal to the untraced run (and equal to the
reference's: goodness within ``GOOD_RTOL``, everything else exact). The
CLI's ``--trace --trace-out`` writes a schema-valid JSONL trace.
"""

import json
import math
import os
import threading

import numpy as np
import pytest
import torch

from repro.config.base import IGPMConfig as RCfg
from repro.config.base import ObsConfig as RObs
from repro.config.base import ServingConfig as RServCfg
from repro.core.query import query_zoo as r_zoo
from repro.data.temporal import TemporalGraphSpec as RSpec
from repro.data.temporal import generate_stream as r_gen
from repro.obs import export as rexp
from repro.obs import FlightRecorder as RFlight
from repro.serving import MatchServer as RServer
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.config.base import ObsConfig as TObs
from repro_torch.config.base import RuntimeConfig as TRtCfg
from repro_torch.config.base import ServingConfig as TServCfg
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.data.temporal import TemporalGraphSpec as TSpec
from repro_torch.data.temporal import generate_stream as t_gen
from repro_torch.launch import serve as tserve
from repro_torch.obs import export as texp
from repro_torch.obs import (NULL_SPAN, NULL_TRACER, FlightRecorder, Obs,
                             read_jsonl, validate_jsonl)
from repro_torch.serving import MatchServer as TServer
from test_torch_adaptive import _stores_equal

torch.set_num_threads(1)
CPU = "cpu"


# -- exporters: byte-equal to the reference's ---------------------------------

EVENTS = [
    {"name": "thread_name", "ph": "M", "ts": 0.0, "pid": 1, "tid": 2,
     "args": {"name": "rt-ingress"}},
    {"name": "engine/apply", "cat": "engine", "ph": "X", "ts": 1.5,
     "dur": 2.25, "pid": 1, "tid": 1, "args": {"step": 0, "batch": 3}},
    {"name": "engine/merge/row", "cat": "engine", "ph": "X", "ts": 9.125,
     "dur": 0.001, "pid": 1, "tid": 1,
     "args": {"qid": "tri#1", "aliases": 2, "unicode": "ü→"}},
    {"name": "ingress/packed", "cat": "ingress", "ph": "i", "ts": 4.0,
     "pid": 1, "tid": 2, "args": {"batch": 3, "n_events": 64}},
]
SNAPSHOT = {"p50_step_ms": 1.25, "p99_step_ms": 17.000000001, "steps": 4,
            "note": "text", "bad": float("nan"), "inf": float("inf"),
            "flag": True, "weird key!": 2.0, "9lead": 3, "a:b": -0.5,
            "weird key?": 7.0, "big": 123456789012.0, "tiny": 1e-12}


def test_exporters_write_the_reference_bytes(tmp_path):
    for name, fn in (("jsonl", "write_jsonl"), ("json", "write_chrome")):
        mine = getattr(texp, fn)(EVENTS, str(tmp_path / f"t.{name}"))
        theirs = getattr(rexp, fn)(EVENTS, str(tmp_path / f"r.{name}"))
        assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert texp.read_jsonl(str(tmp_path / "t.jsonl")) == EVENTS
    for prefix in ("repro", "igpm", ""):
        assert (texp.prometheus_text(SNAPSHOT, prefix=prefix)
                == rexp.prometheus_text(SNAPSHOT, prefix=prefix))
    texp.write_prometheus(SNAPSHOT, str(tmp_path / "t.prom"))
    rexp.write_prometheus(SNAPSHOT, str(tmp_path / "r.prom"))
    assert ((tmp_path / "t.prom").read_bytes()
            == (tmp_path / "r.prom").read_bytes())
    assert texp.validate_exposition(texp.prometheus_text(SNAPSHOT)) == []


@pytest.mark.parametrize("key,prefix", [
    ("p50_step_ms", "repro"), ("weird key!", "x"), ("9starts_numeric", ""),
    ("a:b", "ns"), ("", "p"), ("stage/gray-wait", "igpm")])
def test_metric_name_matches_reference(key, prefix):
    assert texp.metric_name(key, prefix) == rexp.metric_name(key, prefix)


BAD_EVENTS = [
    [{"name": "x", "ph": "X", "ts": 0.0, "pid": 1, "tid": 1}],
    [{"name": "x", "ph": "Q", "ts": 0.0, "dur": 1, "pid": 1, "tid": 1}],
    [{"ph": "i", "ts": 0.0, "pid": 1, "tid": 1}],
    [{"name": "", "ph": "i", "ts": -1.0, "pid": 1, "tid": 1}],
    [{"name": "x", "ph": "X", "ts": 0.0, "dur": -2, "pid": 1, "tid": 1,
      "args": [1]}],
    ["not an object"],
    EVENTS,
]
BAD_TEXTS = [
    "# HELP m_a help\n# TYPE m_a gauge\nm_a 1.5\n", "", "m_a 1.5\n",
    "# HELP m_a h\n# TYPE m_a gauge\nm_a banana\n",
    "# HELP m_a h\n# TYPE m_a gauge\nm_a nan\n",
    "# HELP m_a h\n# TYPE m_a gauge\nm_a 1\nm_a 2\n",
    "# HELP 9bad h\n# TYPE 9bad gauge\n9bad 1\n",
    "# HELP m\n# free comment\nm{a=\"b\"} 2\n",
]


@pytest.mark.parametrize("i", range(len(BAD_EVENTS)))
def test_validate_events_agrees_with_reference(i):
    assert (texp.validate_events(BAD_EVENTS[i])
            == rexp.validate_events(BAD_EVENTS[i]))


@pytest.mark.parametrize("i", range(len(BAD_TEXTS)))
def test_validate_exposition_agrees_with_reference(i):
    assert (texp.validate_exposition(BAD_TEXTS[i])
            == rexp.validate_exposition(BAD_TEXTS[i]))


def test_validate_jsonl_agrees_on_missing_and_empty_files(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for path in (str(tmp_path / "missing.jsonl"), str(empty)):
        assert bool(texp.validate_jsonl(path)) and \
            texp.validate_jsonl(path)[:1] == rexp.validate_jsonl(path)[:1]


# -- flight recorder ------------------------------------------------------------

def _fake_step_events(step):
    return [{"name": "engine/apply", "cat": "engine", "ph": "X",
             "ts": 1000.0 * step, "dur": 5.0, "pid": 1, "tid": 1,
             "args": {"step": step}}]


def test_flight_ring_keeps_last_n_and_dumps_like_reference(tmp_path):
    mine = FlightRecorder(3, str(tmp_path / "t"))
    theirs = RFlight(3, str(tmp_path / "r"))
    for s in range(5):
        mine.push(s, _fake_step_events(s))
        theirs.push(s, _fake_step_events(s))
    mine.loose.append(EVENTS[3])
    theirs.loose.append(EVENTS[3])
    assert mine.steps() == theirs.steps() == [2, 3, 4]
    a, b = mine.dump(reason="unit"), theirs.dump(reason="unit")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert validate_jsonl(a) == []
    marker = read_jsonl(a)[0]
    assert marker["name"] == "flight_dump"
    assert marker["args"] == {"reason": "unit", "steps": [2, 3, 4],
                              "n_loose": 1}


def test_flight_triggered_dumps_deduplicate(tmp_path):
    fr = FlightRecorder(4, str(tmp_path / "fl"))
    fr.push(0, _fake_step_events(0))
    first = fr.dump(reason="slo", triggered=True)
    assert first is not None
    assert fr.dump(reason="slo", triggered=True) is None   # same evidence
    fr.push(1, _fake_step_events(1))
    second = fr.dump(reason="slo", triggered=True)
    assert second is not None and second != first
    assert fr.dump(reason="manual") is not None           # manual: always
    assert FlightRecorder(2).dump(triggered=True) is None  # nowhere to write


def test_flight_concurrent_triggered_dumps_deduplicate(tmp_path):
    fr = FlightRecorder(4, str(tmp_path / "fl"))
    fr.push(0, _fake_step_events(0))
    barrier = threading.Barrier(2)
    results = []

    def trigger():
        barrier.wait()
        results.append(fr.dump(reason="race", triggered=True))

    threads = [threading.Thread(target=trigger) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    paths = [r for r in results if r is not None]
    assert len(paths) == 1 and fr.n_dumps == 1
    assert [f for f in os.listdir(tmp_path) if f.startswith("fl.")] == \
        [os.path.basename(paths[0])]


def test_slo_trigger_dumps_flight(tmp_path):
    obs = Obs(TObs(enabled=True, flight_n=4, slo_e2e_ms=100.0,
                   flight_path=str(tmp_path / "slo")))
    obs.begin_step(0)
    with obs.span("engine/apply"):
        pass
    obs.end_step(0)
    assert obs.observe_e2e(50.0) is None          # under the SLO
    path = obs.observe_e2e(250.0)                 # breach -> post-mortem
    assert path is not None and validate_jsonl(path) == []
    assert read_jsonl(path)[0]["args"]["reason"] == \
        "slo:e2e 250.0ms > 100ms"
    assert obs.observe_e2e(300.0) is None         # no new steps: de-duped


def test_profile_step_writes_a_torch_profiler_trace(tmp_path):
    obs = Obs(TObs(enabled=True, profiler_dir=str(tmp_path / "prof"),
                   profile_start=1, profile_stop=3))
    for step in range(4):
        with obs.profile_step(step):
            torch.ones(8).add_(1)
            if step < 3:
                assert (obs._profiler is not None) == (step >= 1)
    assert obs._profiler is None
    with open(obs.profile_path) as f:
        assert "traceEvents" in json.load(f)
    assert os.path.basename(obs.profile_path) == "steps_1_3.json"


# -- the traced engine against the reference's ---------------------------------

def _cfg(cls, backend="coo"):
    # community size 4: the stream's steps take both the induced-subgraph
    # path and the full-graph storm fallback
    return cls(n_max=128, e_max=8192, ell_width=8, rwr_iters=6,
               rwr_iters_incremental=2, top_k_patterns=4,
               init_community_size=4, backend=backend)


@pytest.fixture(scope="module")
def streams():
    kw = dict(n_vertices=128, n_edges=512, n_steps=16, seed=5, churn=0.25)
    ref = r_gen(RSpec("obs", "sparse_dense", **kw), n_measured_steps=5,
                u_max=128)
    port = t_gen(TSpec("obs", "sparse_dense", **kw), n_measured_steps=5,
                 u_max=128, device=CPU)
    return ref, port


def _run(server, stream):
    """Serve ``stream``; returns the engine's StepOutputs (which carry
    ``stage_s``; the server's step stats do not)."""
    outs = []
    step = server.engine.step

    def recording(state, upd):
        state, out = step(state, upd)
        outs.append(out)
        return state, out

    server.engine.step = recording
    g = stream.graph
    for upd in stream.updates:
        server.submit_update(upd)
        g, _ = server.step(g)
    return outs


def _port(obs=None, backend="coo", **kw):
    return TServer(_cfg(TCfg, backend), t_zoo(4),
                   TServCfg(adaptive=False, microbatch_window=64,
                            obs=obs or TObs(), **kw), seed=0, device=CPU)


def _shape(events):
    """Ordered (name, phase, non-timing args keys) of a span list."""
    return [(e["name"], e["ph"], sorted(e.get("args", {})))
            for e in events if e["ph"] != "M"]


@pytest.fixture(scope="module")
def traced_pair(streams):
    ref_s, port_s = streams
    ref = RServer(_cfg(RCfg), r_zoo(4),
                  RServCfg(adaptive=False, microbatch_window=64,
                           obs=RObs(enabled=True, flight_n=64)), seed=0)
    r_out = _run(ref, ref_s)
    port = _port(TObs(enabled=True, flight_n=64))
    p_out = _run(port, port_s)
    return ref, r_out, port, p_out


def test_traced_steps_emit_the_reference_spans(traced_pair):
    ref, r_out, port, p_out = traced_pair
    assert port.obs.flight.steps() == ref.obs.flight.steps() == \
        list(range(len(p_out)))
    r_steps = dict(ref.obs.flight._ring)
    p_steps = dict(port.obs.flight._ring)
    for step in r_steps:
        assert _shape(p_steps[step]) == _shape(r_steps[step]), step
        # every span of a step carries the step id from the context
        assert all(e["args"]["step"] == step for e in p_steps[step])
    names = {e["name"] for e in port.obs.tracer.events()}
    assert {"engine/apply", "engine/pem", "engine/extract", "engine/rwr",
            "engine/gray", "engine/gray_wait", "engine/device_wait",
            "engine/merge", "engine/merge/bucket", "engine/merge/row",
            "engine/merge/fanout", "engine/pem_feedback", "engine/seeds",
            "bank/register"} <= names
    assert _shape(port.obs.tracer.events()) == \
        _shape(ref.obs.tracer.events())
    assert texp.validate_events(port.obs.tracer.events()) == []


def test_traced_stage_keys_match_reference(traced_pair):
    ref, r_out, port, p_out = traced_pair
    for a, b in zip(r_out, p_out):
        assert b.stage_s is not None
        assert list(b.stage_s) == list(a.stage_s)
        assert all(v >= 0.0 for v in b.stage_s.values())
    snap = port.telemetry.snapshot()
    stages = {k[len("p50_stage_"):-len("_ms")] for k in snap
              if k.startswith("p50_stage_")}
    assert stages == {k[len("p50_stage_"):-len("_ms")]
                      for k in ref.telemetry.snapshot()
                      if k.startswith("p50_stage_")}
    assert {"apply", "pem", "rwr", "gray", "merge", "feedback"} <= stages


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_tracing_changes_nothing_computed(streams, traced_pair, backend):
    """Tracing off: the null tracer, zero spans, no stage dict. Traced and
    untraced runs give bitwise-equal deltas and stores; the coo runs also
    equal the reference's (goodness within GOOD_RTOL)."""
    _, port_s = streams
    off = _port(backend=backend)
    outs_off = _run(off, port_s)
    assert off.obs.tracer is NULL_TRACER and off.obs.tracer.n_spans == 0
    assert off.obs.span("anything") is NULL_SPAN
    assert all(o.stage_s is None for o in outs_off)
    assert not any(k.startswith("p50_stage_")
                   for k in off.telemetry.snapshot())
    if backend == "coo":
        ref, r_out, on, outs_on = traced_pair
    else:
        on = _port(TObs(enabled=True), backend=backend)
        outs_on = _run(on, port_s)
    assert on.obs.tracer.n_spans > 0
    for a, b in zip(outs_off, outs_on):
        assert (a.deltas, a.n_recompute, a.n_events, a.n_pruned,
                a.subgraph_nodes) == (b.deltas, b.n_recompute, b.n_events,
                                      b.n_pruned, b.subgraph_nodes)
    for a, b in zip(off.stores, on.stores):
        assert a._patterns == b._patterns
    if backend == "coo":
        assert [o.deltas for o in outs_on] == [o.deltas for o in r_out]
        _stores_equal(ref.stores, on.stores)


def test_batch_mode_spans_match_reference(streams):
    from repro.config.base import EngineConfig as REngCfg
    from repro.engine import Engine as REngine
    from repro_torch.config.base import EngineConfig as TEngCfg
    from repro_torch.engine import Engine as TEngine
    ref_s, port_s = streams
    ref = REngine(_cfg(RCfg), REngCfg(mode="batch", obs=RObs(enabled=True)))
    port = TEngine(_cfg(TCfg), TEngCfg(mode="batch", obs=TObs(enabled=True)),
                   device=CPU)
    for eng, zoo in ((ref, r_zoo(2)), (port, t_zoo(2))):
        for q in zoo:
            eng.register(q)
    sr, sp = ref.init_state(ref_s.graph), port.init_state(port_s.graph)
    for ur, up in zip(ref_s.updates[:2], port_s.updates[:2]):
        sr, o_r = ref.step(sr, ur)
        sp, o_p = port.step(sp, up)
        assert list(o_p.stage_s) == list(o_r.stage_s)
        assert o_p.deltas == o_r.deltas
    assert _shape(port.obs.tracer.events()) == \
        _shape(ref.obs.tracer.events())


def test_lockstep_runtime_trace_spans_threads():
    from repro_torch.runtime import (ServingRuntime, VirtualClock,
                                     build_workload, churn_heavy)
    wl = build_workload(churn_heavy(rate=2500.0, tick_s=0.01, n_ticks=8,
                                    n_vertices=128, seed=3), u_max=256,
                        device=CPU)
    srv = _port()
    rt = ServingRuntime(srv, TRtCfg(ingress="lockstep",
                                    obs=TObs(enabled=True, flight_n=64)),
                        clock=VirtualClock())
    stats = rt.serve(wl)
    assert stats
    events = srv.obs.tracer.events()
    by_cat = {}
    for ev in events:
        by_cat.setdefault(ev.get("cat"), []).append(ev)
    ingress_tids = {ev["tid"] for ev in by_cat["ingress"]}
    engine_tids = {ev["tid"] for ev in by_cat["engine"]}
    assert ingress_tids and engine_tids
    assert ingress_tids.isdisjoint(engine_tids)
    names = {ev["args"]["name"] for ev in events if ev["ph"] == "M"}
    assert any("ingress" in n for n in names)
    assert any("executor" in n for n in names)
    packed = {ev["args"]["batch"] for ev in events
              if ev["name"] == "ingress/packed"}
    stepped = {ev["args"]["batch"] for ev in by_cat["executor"]
               if ev["name"] == "executor/step"}
    assert stepped and stepped <= packed
    merges = [ev for ev in by_cat["engine"] if ev["name"] == "engine/merge"]
    assert merges and all("step" in ev["args"] and "batch" in ev["args"]
                          for ev in merges)
    assert srv.obs.flight.steps() == [s.step for s in stats][-64:]


# -- the CLI ----------------------------------------------------------------------

def test_cli_trace_writes_valid_jsonl_and_prints_stages(tmp_path, capsys):
    prefix = str(tmp_path / "t")
    tserve.main(["--arch", "igpm-pem", "--steps", "3", "--bank", "2",
                 "--device", "cpu", "--trace", "--trace-out", prefix])
    out = capsys.readouterr().out
    assert "[serve] stage p50 ms: " in out
    line = [ln for ln in out.splitlines() if "stage p50 ms" in ln][0]
    stages = dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
    assert {"apply", "pem", "rwr", "gray", "merge", "feedback"} <= \
        set(stages)
    assert all(math.isfinite(float(v)) for v in stages.values())
    assert validate_jsonl(prefix + ".jsonl") == []
    assert texp.validate_exposition(open(prefix + ".prom").read()) == []
    with open(prefix + ".json") as f:
        assert json.load(f)["traceEvents"]
    assert f"trace_jsonl: {prefix}.jsonl" in out
