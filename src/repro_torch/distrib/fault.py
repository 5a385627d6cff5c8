"""Fault tolerance for training: the straggler monitor and the elastic
re-mesh (PyTorch port of ``repro.distrib.fault``).

* StragglerMonitor — per-step duration tracking with robust (median/MAD)
  outlier detection; emits a skip/quarantine list the way a pod
  controller would deschedule a slow host.
* ElasticPlan — given a failed device count, the largest healthy mesh
  (shrinking the "data" axis first, keeping tensor-parallel groups whole),
  and ``reshard``, which re-places a state on it.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.distrib.sharding import (ShardedTensor, device_put, gather,
                                          map_with_specs)


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


@dataclass(frozen=True)
class ElasticPlan:
    """Re-mesh decision after failures: shrink 'data', keep 'model' intact
    (TP groups must stay whole — a dead chip kills its whole TP group)."""

    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    lost_batch_fraction: float


def plan_elastic(mesh_shape: Sequence[int], axes: Sequence[str],
                 failed_devices: int) -> ElasticPlan:
    shape = list(mesh_shape)
    data_idx = list(axes).index("data")
    model = 1
    for i, a in enumerate(axes):
        if a != "data":
            model *= shape[i]
    # each failure removes ceil(failed/model) data rows (whole TP groups)
    lost_rows = -(-failed_devices // model)
    new_data = shape[data_idx] - lost_rows
    if new_data < 1:
        raise RuntimeError("not enough healthy devices for any data row")
    new_shape = list(shape)
    new_shape[data_idx] = new_data
    return ElasticPlan(tuple(shape), tuple(new_shape), tuple(axes),
                       lost_batch_fraction=lost_rows / shape[data_idx])


def reshard(state: Any, new_mesh, spec_tree: Any,
            donate: bool = False) -> Any:
    """Re-place a state tree onto a new mesh: every leaf — a whole
    (restored) tensor or a :class:`ShardedTensor` on another mesh — split
    by its spec in ``spec_tree``. A sharded leaf is gathered whole on the
    new mesh's first device first (its bytes counted as ``reshard`` on the
    old mesh). With ``donate`` the old shards are released leaf by leaf,
    as a donated JAX buffer is, so the old and the new state are never
    both whole on the card."""
    def one(x, spec):
        if isinstance(x, ShardedTensor):
            whole = gather(x, collective="reshard").to(new_mesh.device(0))
            if donate:
                x.shards.clear()
        else:
            whole = torch.as_tensor(x)
        out = device_put(whole, new_mesh, spec)
        del whole
        return out

    return map_with_specs(one, state, spec_tree)
