"""Synthetic data: temporal graph streams and the LM token pipeline."""

from repro_torch.data.temporal import (DATASET_TWINS, TemporalGraphSpec,
                                       TemporalStream, generate_stream)
from repro_torch.data.lm import TokenPipeline, synthetic_token_batches

__all__ = [
    "TemporalGraphSpec",
    "TemporalStream",
    "generate_stream",
    "DATASET_TWINS",
    "TokenPipeline",
    "synthetic_token_batches",
]
