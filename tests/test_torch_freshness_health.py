"""The port's freshness ledger, health watchdog and ops HTTP surface
against the JAX package's.

One scripted sequence of registrations, deliveries, completions, idle
snaps and retirements at ``VirtualClock`` times drives both packages'
``FreshnessLedger``; one scripted sequence of heartbeats and supplier
readings drives both ``HealthMonitor``s. Their ``snapshot()``,
``status()``, ``counters()`` and event rings are compared exactly. Both
``OpsServer``s, bound to port 0 on localhost with the same suppliers,
answer every route with the same status code, body and content type: 200,
503 when stalled, 404 for an unknown route or a missing supplier, 500 for
a supplier that raises.
"""

from urllib.error import HTTPError
from urllib.request import urlopen

import pytest
import torch

from repro.config.base import EngineConfig as REngCfg
from repro.config.base import IGPMConfig as RCfg
from repro.core.query import query_zoo as r_zoo
from repro.engine import Engine as REngine
from repro.obs import FreshnessLedger as RFresh
from repro.obs import HealthMonitor as RHealth
from repro.obs import OpsServer as ROps
from repro.obs import QueryFreshness as RRow
from repro.runtime import VirtualClock as RVClock
from repro_torch.config.base import EngineConfig as TEngCfg
from repro_torch.config.base import IGPMConfig as TCfg
from repro_torch.core.query import query_zoo as t_zoo
from repro_torch.engine import Engine as TEngine
from repro_torch.obs import FreshnessLedger, HealthMonitor, OpsServer
from repro_torch.obs import QueryFreshness
from repro_torch.runtime import VirtualClock

torch.set_num_threads(1)


class _Tel:
    """Telemetry stand-in recording latency samples."""

    def __init__(self):
        self.samples = []

    def record_latency(self, name, *vals):
        self.samples.append((name, vals))


def _script_freshness(cls):
    """Run one scripted sequence; return every observable it produced."""
    tel = _Tel()
    groups = {"late": "q0", "solo": "solo"}
    led = cls(slo_s=0.3, fast_window_s=1.0, slow_window_s=4.0,
              telemetry=tel, resolver=lambda: groups, t0=0.0)
    led.register("q0", t=0.0)
    led.register("q0dup", primary="q0", t=0.0)
    led.register("q1", t=0.1)
    seen = []
    script = [("deliver", 0, ["q0", "q0dup", "q1"]),
              ("complete", 0, (0.05, 0.2), 0.25),
              ("deliver", 1, ["q0", "late", "solo"]),
              ("complete", 1, (0.3, 0.45, 0.4), 1.2),
              ("complete", 7, (0.9,), 1.3),          # unknown: ignored
              ("idle", 1.5, 3), ("idle", 1.6, 0),
              ("deliver", 2, ["q1"]),
              ("complete", 2, (), 2.9),
              ("deliver", 3, ["q0dup", "q1"]),
              ("complete", 3, (1.7, 2.8), 3.4),
              ("retire", "solo"),
              ("deliver", 4, ["q0"]),
              ("complete", 4, (3.3,), 6.5)]
    for op in script:
        if op[0] == "deliver":
            led.deliver(op[1], op[2])
        elif op[0] == "complete":
            led.complete(op[1], op[2], op[3])
        elif op[0] == "idle":
            led.idle_snap(op[1], op[2])
        else:
            led.retire(op[1])
        seen.append((tuple(tuple(r) for r in led.snapshot(3.0)),
                     led.counters(), led.worst(3.0), led.qids,
                     led.n_groups))
    with pytest.raises(ValueError, match="already registered"):
        led.register("q0")
    led.reset(t0=7.0)
    seen.append((tuple(tuple(r) for r in led.snapshot(8.0)),
                 led.counters(), led.staleness("q1", 8.5)))
    return seen, tel.samples


def test_freshness_ledger_matches_reference():
    mine, mine_tel = _script_freshness(FreshnessLedger)
    theirs, theirs_tel = _script_freshness(RFresh)
    assert mine == theirs
    assert mine_tel == theirs_tel and mine_tel
    assert QueryFreshness._fields == RRow._fields


def test_freshness_from_engine_shares_alias_frontiers():
    """``from_engine`` reads ``Engine.alias_groups``: an exact duplicate
    joins its primary's group in both packages."""
    port = TEngine(TCfg(n_max=64, e_max=512), TEngCfg(adaptive=False),
                   device="cpu")
    ref = REngine(RCfg(n_max=64, e_max=512), REngCfg(adaptive=False))
    for eng, zoo in ((port, t_zoo(3)), (ref, r_zoo(3))):
        for q in zoo + [zoo[0]._replace(name="dup")]:
            eng.register(q)
    assert port.alias_groups() == ref.alias_groups()
    assert port.partition_occupancy() is None
    assert ref.partition_occupancy() is None
    mine = FreshnessLedger.from_engine(port, t0=0.5)
    theirs = RFresh.from_engine(ref, t0=0.5)
    assert mine.n_groups == theirs.n_groups == 3
    for led in (mine, theirs):
        led.deliver(0, list(port.qids))
        led.complete(0, (0.75,), 1.0)
    assert [tuple(r) for r in mine.snapshot(1.5)] == \
        [tuple(r) for r in theirs.snapshot(1.5)]


class _Obs:
    def __init__(self):
        self.dumps = []

    def flight_dump(self, reason="manual", path=None, triggered=False):
        self.dumps.append((reason, triggered))
        return f"/tmp/fl.{len(self.dumps):03d}.jsonl"


def _script_health(mon_cls, fresh_cls, clock_cls):
    clock = clock_cls()
    fresh = fresh_cls(slo_s=0.2, fast_window_s=1.0, slow_window_s=2.0,
                      t0=0.0)
    fresh.register("q0", t=0.0)
    obs = _Obs()
    mon = mon_cls(clock=clock, period_s=0.0, stall_after_s=1.0,
                  queue_high_frac=0.8, queue_dwell_periods=2,
                  partition_near_frac=0.9, burn_degraded=0.4, obs=obs,
                  freshness=fresh, max_events=64)
    fills = iter([0.1, 0.85, 0.9, 0.95, 0.2, 0.9, 0.99, 0.99] + [0.0] * 11)
    occ = iter([None, 0.5, 0.95, 0.95, 0.1, None, None, 0.92] + [None] * 11)
    pending = iter([1, 1, 2, 0, 0, 1, 1] + [0] * 12)
    mon.attach_queue(lambda: next(fills))
    mon.attach_partition(lambda: next(occ))
    mon.attach_pending(lambda: next(pending))
    seen = []
    for i, t in enumerate([0.1, 0.3, 0.6, 1.0, 1.4, 1.9, 2.6, 3.0, 3.5,
                           3.9, 4.6, 5.0, 6.5, 7.0, 7.1, 7.2, 7.4, 7.6,
                           7.8]):
        clock.advance_to(t)
        if i in (0, 1, 2, 5, 8) or i >= 10:
            mon.beat("executor", t)
        if i < 4 or i > 8:
            mon.beat("ingress", t)
        if i == 9:
            mon.set_inactive("ingress")
        if i == 3:
            fresh.deliver(0, ["q0"])
            fresh.complete(0, (0.05,), t)
        seen.append((mon.check(), mon.state, mon.status(t + 0.05)))
    seen.append(([tuple(e) for e in mon.events], obs.dumps,
                 mon.n_checks, mon.n_dumps_triggered))
    return seen


def test_health_monitor_matches_reference():
    mine = _script_health(HealthMonitor, FreshnessLedger, VirtualClock)
    theirs = _script_health(RHealth, RFresh, RVClock)
    assert mine == theirs
    states = {s[0] for s in mine[:-1]}
    assert {"ok", "degraded", "stalled"} <= states
    kinds = {e[0] for e in mine[-1][0]}
    assert {"stall", "queue_saturation", "partition_pressure",
            "freshness_burn", "recovered"} <= kinds


def test_health_monitor_thread_runs_and_closes():
    import time

    mon = HealthMonitor(clock=VirtualClock(), period_s=0.01)
    mon.start()
    with pytest.raises(RuntimeError, match="already started"):
        mon.start()
    deadline = time.monotonic() + 5.0
    while mon.n_checks < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    mon.close()
    n = mon.n_checks
    assert n >= 3
    time.sleep(0.05)
    assert mon.n_checks == n


# -- the ops surface ----------------------------------------------------------------

def _get(url):
    try:
        with urlopen(url, timeout=5) as resp:
            return (resp.status, resp.read().decode("utf-8"),
                    resp.headers.get("Content-Type", ""))
    except HTTPError as e:
        return e.code, e.read().decode("utf-8"), e.headers.get(
            "Content-Type", "")


def _boom():
    raise RuntimeError("supplier exploded")


ROWS = [QueryFreshness("q1", "q0", 1.0, 0.5, 0.1, 0.05, 3),
        QueryFreshness("q0", "q0", 1.0, 0.5, 0.1, 0.05, 3)]
SUPPLIERS = {
    "ok": dict(snapshot=lambda: {"p50_step_ms": 1.5, "steps": 4,
                                 "weird key!": 2.0, "note": "x"},
               health=lambda: {"state": "ok", "alarms": {}},
               freshness=lambda: ROWS,
               flight=lambda: "/tmp/fl.000.jsonl"),
    "stalled": dict(health=lambda: {"state": "stalled",
                                     "alarms": {"stall": {"age_s": 3.0}}},
                    flight=lambda: None),
    "broken": dict(snapshot=_boom, health=_boom, freshness=_boom),
}


@pytest.mark.parametrize("case", sorted(SUPPLIERS))
def test_ops_server_answers_like_reference(case):
    mine = OpsServer(port=0, **SUPPLIERS[case]).start()
    theirs = ROps(port=0, **SUPPLIERS[case]).start()
    try:
        assert mine.host == "127.0.0.1" and mine.port > 0
        codes = set()
        for route in ("/metrics", "/health", "/freshness/", "/flight",
                      "/nope", "/health?verbose=1"):
            got = _get(mine.url + route)
            assert got == _get(theirs.url + route), route
            codes.add(got[0])
    finally:
        mine.close()
        theirs.close()
    want = {"ok": {200, 404}, "stalled": {503, 200, 404},
            "broken": {500, 404}}[case]
    assert codes == want
