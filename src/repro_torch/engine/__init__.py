"""Functional-core match engine: one step pipeline, bucketed query banks."""

from repro_torch.engine.buckets import QueryBucket, bucket_shape
from repro_torch.engine.core import Engine, engine_step
from repro_torch.engine.state import EngineState, QueryDelta, StepOutput
from repro_torch.engine.store import PatternStore, live_vertex_mask

__all__ = [
    "Engine", "engine_step", "EngineState", "StepOutput", "QueryDelta",
    "QueryBucket", "bucket_shape", "PatternStore", "live_vertex_mask",
]
