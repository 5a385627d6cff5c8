"""AdamW with global-norm clipping, the LR schedule and the error-feedback
gradient compression (PyTorch port of ``repro.optim``)."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compression import (CompressionState, compress_grads,
                                           compression_init)
from repro_torch.optim.schedules import warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "warmup_cosine",
    "CompressionState", "compress_grads", "compression_init",
]
