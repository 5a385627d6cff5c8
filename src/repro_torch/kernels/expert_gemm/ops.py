"""Public wrapper of the grouped expert GEMM kernel.

``expert_gemm(x, w)`` multiplies x (N, C, d) by w (E, d, f) as
``y[n] = x[n] @ w[n mod E]``, so the MoE block's (G, E, C, d) dispatch
buffer goes in whole as N = G·E matrices. Both f32 or both bf16. It checks
its inputs, then:

* on CUDA tensors launches one of three kernels (built on first use by
  :mod:`repro_torch.kernels.build`) on the current stream, or raises;
  :func:`gemm_variant` picks it by shape: bf16 that TMA can address (d and
  f multiples of 8, x, w and y 16-byte aligned) goes to
  ``csrc/expert_gemm_wgmma.cu``, as its skinny variant for C ≤
  :data:`SKINNY_MAX_C` (the decode step) and its tiles variant above (the
  prefill); everything else, f32 included, to ``csrc/expert_gemm.cu``;
* on CPU tensors runs the plain version, :func:`.ref.expert_gemm_ref`.

:class:`ExpertGemm` gives the product a gradient built on the same
kernels: dX = dY·Wᵀ is ``expert_gemm(dY, Wᵀ)`` with Wᵀ a contiguous (E, f, d)
copy, and dW[e] = Σ_g X[g, e]ᵀ·dY[g, e] is one ``expert_gemm`` over
(E, d, G·C) × (E, G·C, f), the group sum inside the contraction (no
separate sum, no atomics). The transposes are plain torch copies.

:data:`LAUNCHES` counts launches per kernel, bumped only where the kernel
is launched, so a run can show that its path went through the kernel.

The JAX wrapper's Pallas tile arguments ``block_c``, ``block_d`` and
``block_f`` are not ported: each CUDA variant fixes its tiles (the tiles
variant 128 × 192 output tiles over 64-wide k steps, the skinny one C
rounded up to a wgmma N), so a caller has no tile to pick.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from repro_torch.kernels import build
from repro_torch.kernels.expert_gemm.ref import expert_gemm_ref

FIRST = "expert_gemm"
TILES = "expert_gemm_wgmma"
SKINNY = "expert_gemm_skinny"
LAUNCHES: Dict[str, int] = {FIRST: 0, TILES: 0, SKINNY: 0}
# largest C the skinny variant takes (its wgmma N is C rounded up to 8,
# 16, 32 or 64); csrc/expert_gemm_wgmma.cu: SKINNY_MAX_C
SKINNY_MAX_C = 64
# the C entry point's `variant` argument (csrc/expert_gemm_wgmma.cu)
GEMM_VARIANTS = {TILES: 0, SKINNY: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.device != x.device:
        raise ValueError(f"expert_gemm: w on {w.device}, x on {x.device}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expert_gemm: x and w must both be float32 or "
                         f"both bfloat16, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f"expert_gemm: wants x (N, C, d) and w (E, d, f), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[0] == 0 or x.shape[0] % w.shape[0] != 0:
        raise ValueError(f"expert_gemm: N={x.shape[0]} is not a multiple "
                         f"of E={w.shape[0]}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("expert_gemm: x and w must be contiguous")


def gemm_variant(dtype: torch.dtype, C: int, d: int, f: int,
                 ptrs: Iterable[int]) -> str:
    """The kernel that takes a call, by shape alone: for bf16 with d and f
    positive multiples of 8 (TMA's 16-byte row strides) and every pointer
    (x, w, y) 16-byte aligned, the TMA + wgmma source, as its skinny
    variant for C ≤ :data:`SKINNY_MAX_C` and its tiles variant above; the
    first kernel (WMMA bf16, FMA f32) for everything else."""
    if (dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f > 0
            and f % 8 == 0 and all(p % 16 == 0 for p in ptrs)):
        return SKINNY if C <= SKINNY_MAX_C else TILES
    return FIRST


def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, C, d) × (E, d, f) → (N, C, f), f32 accumulation over d."""
    _check(x, w)
    if x.device.type == "cpu":
        return expert_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"expert_gemm runs on CUDA or CPU tensors, not "
                           f"{x.device}")
    N, C, d = x.shape
    E, _, f = w.shape
    y = torch.empty((N, C, f), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
    name = gemm_variant(x.dtype, C, d, f, ptrs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if name == FIRST:
            rc = build.kernel(FIRST)(*ptrs, N, E, C, d, f,
                                     int(x.dtype == torch.bfloat16), stream)
        else:
            rc = build.kernel(TILES)(*ptrs, N, E, C, d, f,
                                     GEMM_VARIANTS[name], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return y


class ExpertGemm(torch.autograd.Function):
    """``expert_gemm`` with a gradient; both backward products go through
    ``expert_gemm`` too (kernels on CUDA tensors, ``expert_gemm_ref`` on
    CPU tensors), in the inputs' dtype with f32 accumulation."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return expert_gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        N, C, d = x.shape
        E, _, f = w.shape
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = expert_gemm(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            G = N // E
            # (G, E, C, ·) → (E, ·, G·C): one contraction over G·C rows
            xt = x.view(G, E, C, d).permute(1, 3, 0, 2).reshape(E, d, G * C)
            dyt = dy.view(G, E, C, f).transpose(0, 1).reshape(E, G * C, f)
            dw = expert_gemm(xt.contiguous(), dyt.contiguous())
        return dx, dw
