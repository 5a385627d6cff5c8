"""Plain PyTorch versions of the grouped expert GEMM and of its two backward
products: einsums in f32."""

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


def expert_gemm_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, C, f) × (E, d, f) → (N, C, d) with ``dx[n] = dy[n] @ w[n mod
    E]ᵀ``, summed in f32 and returned in dy's type (the product of
    ``expert_gemm_ref`` with a contiguous Wᵀ, bit for bit)."""
    N, C, f = dy.shape
    E, d, _ = w.shape
    dyg = dy.reshape(N // E, E, C, f).float()
    wt = w.transpose(1, 2).contiguous().float()
    dx = torch.einsum("gecf,efd->gecd", dyg, wt)
    return dx.reshape(N, C, d).to(dy.dtype)


def expert_gemm_dw_ref(x: torch.Tensor, dy: torch.Tensor,
                       n_experts: int) -> torch.Tensor:
    """(N, C, d) and (N, C, f) → (E, d, f) with ``dw[e] = Σ_g x[g·E +
    e]ᵀ @ dy[g·E + e]``: one contraction over the G·C rows of expert e,
    summed in f32 and returned in x's type."""
    N, C, d = x.shape
    f = dy.shape[2]
    E, G = n_experts, N // n_experts
    # (G, E, C, ·) → (E, ·, G·C) and (E, G·C, ·)
    xt = x.reshape(G, E, C, d).permute(1, 3, 0, 2).reshape(E, d, G * C)
    dyt = dy.reshape(G, E, C, f).transpose(0, 1).reshape(E, G * C, f)
    return torch.einsum("edk,ekf->edf", xt.float(), dyt.float()).to(x.dtype)
