"""Continuous multi-query match serving."""

from repro_torch.serving.queue import (ADD, RELABEL, REMOVE, UpdateEvent,
                                       UpdateQueue, batch_to_events)
from repro_torch.serving.server import (MatchDelta, MatchServer,
                                        ServingStepStats)
from repro_torch.serving.telemetry import Telemetry

__all__ = [
    "ADD", "REMOVE", "RELABEL", "UpdateEvent", "UpdateQueue",
    "batch_to_events", "MatchDelta", "MatchServer", "ServingStepStats",
    "Telemetry",
]
