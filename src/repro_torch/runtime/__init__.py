"""Async serving runtime (the port's ``repro.runtime``).

Threaded ingress + double-buffered device executor around one
:class:`~repro_torch.serving.server.MatchServer`: the host assembles
micro-batch *k+1* while the card runs step *k*, match deltas fan out to
subscribers, and a graceful drain flushes in-flight batches and
checkpoints via ``Engine.save``. Workload scenarios (Poisson steady state,
flash crowd, diurnal ramp, churn-heavy) layer seeded arrival processes on
the temporal stream generators so tail-latency SLOs are measured against
reproducible traffic. Closed-loop mode (``ScenarioConfig.closed_loop``)
adds ack-driven arrival modulation through the ``AckLedger``; the
``RuntimeKnobs`` indirection is the surface the serving controller
(:mod:`repro_torch.control`) drives.
"""

from repro_torch.runtime.clock import Clock, VirtualClock, WallClock
from repro_torch.runtime.runtime import (AckLedger, PackedBatch, RuntimeKnobs,
                                         ServingRuntime, Subscription,
                                         run_closed_loop, run_workload_sync,
                                         sim_service_model)
from repro_torch.runtime.scenarios import (SCENARIOS, ClosedLoopSource,
                                           ScenarioConfig, Tick, Workload,
                                           build_workload, churn_heavy, deal,
                                           diurnal, flash_crowd, poisson)

__all__ = [
    "Clock", "VirtualClock", "WallClock",
    "AckLedger", "PackedBatch", "RuntimeKnobs", "ServingRuntime",
    "Subscription", "run_closed_loop", "run_workload_sync",
    "sim_service_model",
    "SCENARIOS", "ClosedLoopSource", "ScenarioConfig", "Tick", "Workload",
    "build_workload", "churn_heavy", "deal", "diurnal", "flash_crowd",
    "poisson",
]
