"""Straggler monitoring for the train loop (the ``StragglerMonitor`` of the
JAX package's ``repro.distrib.fault``; its ``ElasticPlan``,
``plan_elastic`` and ``reshard`` wait for the distributed layers, ROADMAP
item 13.5).

Per-step duration tracking with robust (median/MAD) outlier detection; it
emits a skip/quarantine list the way a pod controller would deschedule a
slow host.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class StragglerMonitor:
    """Flags ranks whose step times are MAD-outliers (k·MAD over median)."""

    k: float = 4.0
    min_history: int = 5
    history: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, rank: int, step_time: float) -> None:
        self.history.setdefault(rank, []).append(step_time)

    def stragglers(self) -> List[int]:
        medians = {r: statistics.median(h) for r, h in self.history.items()
                   if len(h) >= self.min_history}
        if len(medians) < 2:
            return []
        vals = sorted(medians.values())
        global_med = statistics.median(vals)
        mad = statistics.median([abs(v - global_med) for v in vals]) or 1e-9
        return [r for r, v in medians.items()
                if (v - global_med) / mad > self.k]
