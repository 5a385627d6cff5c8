"""Structured low-overhead tracing (the port's copy of ``repro.obs.trace``).

One :class:`Obs` hub per engine bundles a tracer, a flight recorder, and
the exporters; the serving server and async runtime share the engine's
hub so one event stream sees offer → assemble → handoff → engine stages
→ merge → fan-out across threads.

Spans are context managers timed with ``perf_counter`` and emitted as
Chrome ``trace_event`` "complete" events (``ph: "X"``, microsecond
``ts``/``dur``) into a bounded ring — no I/O, no locks on the hot path.
``Tracer.context(step=..., batch=...)`` scopes thread-local ids that
every span emitted inside inherits into ``args``, which is what lets a
post-mortem follow one micro-batch offer→delta across the ingress and
executor threads.

Zero-cost disabled: ``Obs(ObsConfig())`` wires the :data:`NULL_TRACER`
singleton whose ``span()`` returns a shared no-op context manager, and
every *extra* device fence in the engine (``torch.cuda.synchronize``)
sits behind ``if obs.enabled``.

``Obs.profile_step`` opens one ``torch.profiler`` session (CPU and CUDA
activities) over the configured steps and writes its Chrome trace under
``ObsConfig.profiler_dir``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, List, Optional

from repro_torch.config.base import ObsConfig
from repro_torch.obs import export as _export
from repro_torch.obs.flight import FlightRecorder


class _NullSpan:
    """Shared no-op span: the whole disabled-tracing fast path."""

    __slots__ = ()
    dur_s = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self.dur_s = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.dur_s = t1 - self._t0
        self._tracer._emit(self.name, "X", self._t0, t1, self.args)
        return False


class _Ctx:
    """Scopes thread-local span annotations (step/batch ids)."""

    __slots__ = ("_tls", "_kw", "_saved")

    def __init__(self, tls: threading.local, kw: Dict[str, Any]):
        self._tls = tls
        self._kw = kw
        self._saved: Dict[str, Any] = {}

    def __enter__(self) -> "_Ctx":
        ids = getattr(self._tls, "ids", None)
        self._saved = ids
        merged = dict(ids) if ids else {}
        merged.update(self._kw)
        self._tls.ids = merged
        return self

    def __exit__(self, *exc) -> bool:
        self._tls.ids = self._saved
        return False


class Tracer:
    """Enabled tracer: bounded event ring + per-step grouping."""

    enabled = True

    def __init__(self, cfg: ObsConfig):
        self.cfg = cfg
        self._epoch = time.perf_counter()
        self._events: Deque[Dict[str, Any]] = deque(maxlen=cfg.event_cap)
        self._meta: List[Dict[str, Any]] = []
        self._tls = threading.local()
        self._tids: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.n_spans = 0
        # out-of-step spans also stream here when a flight recorder is
        # attached (Obs wires this to FlightRecorder.loose)
        self.loose_sink: Optional[Deque[Dict[str, Any]]] = None

    def span(self, name: str, **args: Any) -> _Span:
        return _Span(self, name, args)

    def context(self, **ids: Any) -> _Ctx:
        return _Ctx(self._tls, ids)

    def instant(self, name: str, **args: Any) -> None:
        t = time.perf_counter()
        self._emit(name, "i", t, t, args)

    # -- step grouping (flight recorder) ---------------------------------

    def begin_step(self, step: int) -> None:
        self._tls.step_events = []

    def take_step(self) -> List[Dict[str, Any]]:
        events = getattr(self._tls, "step_events", None) or []
        self._tls.step_events = None
        return events

    # -- emission --------------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids) + 1)
            self._meta.append({
                "name": "thread_name", "ph": "M", "ts": 0.0, "pid": 1,
                "tid": tid,
                "args": {"name": threading.current_thread().name},
            })
        return tid

    def _emit(self, name: str, ph: str, t0: float, t1: float,
              args: Dict[str, Any]) -> None:
        tls = self._tls
        ids = getattr(tls, "ids", None)
        if ids:
            merged = dict(ids)
            merged.update(args)
            args = merged
        ev: Dict[str, Any] = {
            "name": name,
            "cat": name.split("/", 1)[0],
            "ph": ph,
            "ts": round(1e6 * (t0 - self._epoch), 3),
            "pid": 1,
            "tid": self._tid(),
            "args": args,
        }
        if ph == "X":
            ev["dur"] = round(1e6 * (t1 - t0), 3)
        self.n_spans += 1
        self._events.append(ev)
        step_events = getattr(tls, "step_events", None)
        if step_events is not None:
            step_events.append(ev)
        elif self.loose_sink is not None:
            self.loose_sink.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        """Metadata + ring contents, export-ready."""
        return list(self._meta) + list(self._events)


class NullTracer:
    """Disabled tracer: every call is a constant-time no-op."""

    enabled = False
    n_spans = 0

    def span(self, name: str, **args: Any) -> _NullSpan:
        return NULL_SPAN

    def context(self, **ids: Any) -> _NullSpan:
        return NULL_SPAN

    def instant(self, name: str, **args: Any) -> None:
        return None

    def begin_step(self, step: int) -> None:
        return None

    def take_step(self) -> List[Dict[str, Any]]:
        return []

    def events(self) -> List[Dict[str, Any]]:
        return []


NULL_TRACER = NullTracer()


class Obs:
    """Observability hub: tracer + flight recorder + exporters."""

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg if cfg is not None else ObsConfig()
        self.enabled = bool(self.cfg.enabled)
        self.tracer = Tracer(self.cfg) if self.enabled else NULL_TRACER
        self.flight: Optional[FlightRecorder] = None
        if self.enabled and self.cfg.flight_n > 0:
            self.flight = FlightRecorder(self.cfg.flight_n,
                                         self.cfg.flight_path)
            self.tracer.loose_sink = self.flight.loose
        # bound the delegates so the disabled hot path is one attribute
        # load + one constant return, with no Obs-level frame
        self.span = self.tracer.span
        self.context = self.tracer.context
        self.instant = self.tracer.instant
        self._profiler = None          # open torch.profiler session
        self.profile_path: Optional[str] = None

    # -- step lifecycle ---------------------------------------------------

    def begin_step(self, step: int) -> None:
        self.tracer.begin_step(step)

    def end_step(self, step: int) -> None:
        events = self.tracer.take_step()
        if self.flight is not None and events:
            self.flight.push(step, events)

    def observe_e2e(self, e2e_ms: float) -> Optional[str]:
        """SLO trigger: dump the flight ring when an end-to-end latency
        sample crosses the configured threshold."""
        if (self.flight is not None and self.cfg.slo_e2e_ms > 0
                and e2e_ms > self.cfg.slo_e2e_ms):
            return self.flight.dump(
                reason=f"slo:e2e {e2e_ms:.1f}ms > {self.cfg.slo_e2e_ms:g}ms",
                triggered=True)
        return None

    def flight_dump(self, reason: str = "manual",
                    path: Optional[str] = None,
                    triggered: bool = False) -> Optional[str]:
        if self.flight is None:
            return None
        return self.flight.dump(reason=reason, path=path,
                                triggered=triggered)

    # -- torch.profiler session hook ---------------------------------------

    @contextmanager
    def profile_step(self, step: int):
        """Bracket steps ``[profile_start, profile_stop)`` inside one
        ``torch.profiler`` session (no-op unless configured); the session's
        Chrome trace is written to ``<profiler_dir>/steps_<a>_<b>.json``
        when it stops."""
        cfg = self.cfg
        active = (self.enabled and bool(cfg.profiler_dir)
                  and cfg.profile_start <= step < cfg.profile_stop)
        if active and self._profiler is None:
            self._start_profiler()
        try:
            yield
        finally:
            if self._profiler is not None and step >= cfg.profile_stop - 1:
                self._stop_profiler()

    def _start_profiler(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.__enter__()

    def _stop_profiler(self) -> None:
        import os

        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        cfg = self.cfg
        os.makedirs(cfg.profiler_dir, exist_ok=True)
        self.profile_path = os.path.join(
            cfg.profiler_dir,
            f"steps_{cfg.profile_start}_{cfg.profile_stop}.json")
        prof.export_chrome_trace(self.profile_path)

    def close(self) -> None:
        if self._profiler is not None:
            self._stop_profiler()

    # -- export -----------------------------------------------------------

    def export(self, snapshot: Optional[Dict[str, Any]] = None
               ) -> Dict[str, str]:
        """Write every configured artifact; returns ``{kind: path}``.

        ``trace_path`` prefix → ``<prefix>.jsonl`` (span stream) and
        ``<prefix>.json`` (Perfetto-loadable); ``prometheus_path`` +
        a telemetry ``snapshot`` → text-format gauges.
        """
        out: Dict[str, str] = {}
        if self.enabled and self.cfg.trace_path:
            events = self.tracer.events()
            out["trace_jsonl"] = _export.write_jsonl(
                events, self.cfg.trace_path + ".jsonl")
            out["trace_chrome"] = _export.write_chrome(
                events, self.cfg.trace_path + ".json")
        if self.cfg.prometheus_path and snapshot is not None:
            out["prometheus"] = _export.write_prometheus(
                snapshot, self.cfg.prometheus_path)
        return out
