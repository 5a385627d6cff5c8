"""LR schedules (pure functions of the step index), in f32 as the JAX
package's ``repro.optim.schedules`` computes them."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    down to ``min_frac · base_lr`` at ``total_steps``; an f32 scalar tensor
    on the step's device (a Python int is taken on the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
