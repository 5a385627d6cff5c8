"""Plain PyTorch version of the grouped expert GEMM: an einsum in f32."""

from __future__ import annotations

import torch


def expert_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, C, d) × (E, d, f) → (N, C, f) with ``y[n] = x[n] @ w[n mod E]``,
    summed in f32 and returned in x's type."""
    N, C, d = x.shape
    E, _, f = w.shape
    xg = x.reshape(N // E, E, C, d).float()
    y = torch.einsum("gecd,edf->gecf", xg, w.float())
    return y.reshape(N, C, f).to(x.dtype)
