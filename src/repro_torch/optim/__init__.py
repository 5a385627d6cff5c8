"""AdamW with global-norm clipping and the LR schedule (PyTorch port of
``repro.optim``; the gradient compression of ``repro.optim.compression``
waits for the distributed layers, ROADMAP item 13.5)."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedules import warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "warmup_cosine",
]
