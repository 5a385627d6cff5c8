"""Observability layer: structured tracing, flight recorder, exporters,
per-query freshness, the health watchdog and the ops HTTP surface.

The one entry point the rest of the package touches is :class:`Obs` — an
engine builds one from ``EngineConfig.obs`` and the serving/runtime layers
share it, so a single event stream covers ingress → handoff → engine
stages → merge → subscription fan-out. Everything here is host-side
Python; only ``Obs.profile_step`` touches torch (``torch.profiler``).
"""

from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, NullTracer, Obs, Tracer
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.export import (prometheus_text, read_jsonl,
                                    validate_events, validate_exposition,
                                    validate_jsonl, write_chrome, write_jsonl,
                                    write_prometheus)
from repro_torch.obs.freshness import FreshnessLedger, QueryFreshness
from repro_torch.obs.health import HealthEvent, HealthMonitor
from repro_torch.obs.serve import OpsServer

__all__ = [
    "Obs", "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
    "FlightRecorder", "read_jsonl", "validate_events", "validate_jsonl",
    "validate_exposition", "prometheus_text", "write_chrome", "write_jsonl",
    "write_prometheus",
    "FreshnessLedger", "QueryFreshness", "HealthMonitor", "HealthEvent",
    "OpsServer",
]
