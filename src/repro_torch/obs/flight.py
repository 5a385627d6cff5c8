"""Flight recorder — a bounded ring of the last N fully-traced steps.

The tracer groups every span emitted between ``begin_step``/``end_step``
into one step record and pushes it here; spans emitted *outside* a step
scope (the ingress thread's offer/assemble/handoff spans) land in a
bounded *loose* ring so a dump still shows what was arriving while the
executor worked. A dump writes one JSONL file per trigger — on demand,
on executor crash (``ServingRuntime._guard``), or when an e2e latency
sample crosses ``ObsConfig.slo_e2e_ms`` — prefixed with an instant
marker event naming the trigger reason and the step ids captured.

Triggered (crash/SLO) dumps are de-duplicated: a second trigger writes a
new file only once the ring has advanced past the last dumped step, so a
sustained SLO breach yields one post-mortem per window of new evidence,
not one file per violating sample.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.obs import export as _export

LOOSE_CAP = 4096  # out-of-step spans retained alongside the step ring


class FlightRecorder:
    def __init__(self, n: int, path_prefix: str = ""):
        self.n = n
        self.path_prefix = path_prefix
        self._ring: Deque[Tuple[int, List[Dict[str, Any]]]] = deque(maxlen=n)
        self.loose: Deque[Dict[str, Any]] = deque(maxlen=LOOSE_CAP)
        self._lock = threading.Lock()
        # serialises whole dumps: the triggered de-dup check and the
        # counters it guards must be atomic across concurrent triggers
        # (SLO breach racing a crash dump from another thread)
        self._dump_lock = threading.Lock()
        self.n_dumps = 0
        self.last_reason = ""
        self.last_path: Optional[str] = None
        self._dumped_through = -1  # newest step covered by a triggered dump

    def push(self, step: int, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._ring.append((int(step), events))

    def steps(self) -> List[int]:
        with self._lock:
            return [s for s, _ in self._ring]

    def _snapshot(self) -> Tuple[List[Tuple[int, List[Dict[str, Any]]]],
                                 List[Dict[str, Any]]]:
        with self._lock:
            return list(self._ring), list(self.loose)

    def dump(self, reason: str = "manual", path: Optional[str] = None,
             triggered: bool = False) -> Optional[str]:
        """Write the ring (+ loose spans) to ``<prefix>.NNN.jsonl``.

        ``triggered=True`` marks crash/SLO dumps: they are skipped when
        no step newer than the last triggered dump is in the ring, and
        when no ``path``/``path_prefix`` is configured. A manual dump
        with an explicit ``path`` always writes. Concurrent callers are
        serialised, so two racing triggers over the same evidence yield
        exactly one file.
        """
        with self._dump_lock:
            records, loose = self._snapshot()
            newest = max((s for s, _ in records), default=-1)
            if triggered and newest <= self._dumped_through:
                return None
            if path is None:
                if not self.path_prefix:
                    return None
                path = f"{self.path_prefix}.{self.n_dumps:03d}.jsonl"
            self.n_dumps += 1
            self.last_reason = reason
            if triggered:
                self._dumped_through = newest
            marker = {
                "name": "flight_dump", "ph": "i", "s": "g", "ts": 0.0,
                "pid": 1, "tid": 0,
                "args": {"reason": reason, "steps": [s for s, _ in records],
                         "n_loose": len(loose)},
            }
            events = [marker] + loose
            for _, evs in records:
                events.extend(evs)
            self.last_path = _export.write_jsonl(events, path)
            return self.last_path
