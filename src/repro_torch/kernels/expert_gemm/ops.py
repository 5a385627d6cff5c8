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

:class:`ExpertGemm` gives the product a gradient from the two backward
products, each a wrapper of its own:

* ``expert_gemm_dx(dy, w)``: dX[n] = dY[n]·W[n mod E]ᵀ, W read where it
  lies (B K-major);
* ``expert_gemm_dw(x, dy, E)``: dW[e] = Σ_g X[g·E + e]ᵀ·dY[g·E + e], X and
  dY read where they lie, the group sum inside the kernel's k-loop (g
  ascending, then c; no split, no atomics).

:func:`gemm_bwd_variant` picks their route by shape: bf16 that TMA can
address goes to the dX and dW variants of ``csrc/expert_gemm_wgmma.cu``;
everything else, f32 included, to ``expert_gemm`` on transposed copies
(Wᵀ (E, f, d); X, dY as (E, d, G·C) × (E, G·C, f)), counted under that
call's names. CPU tensors take :func:`.ref.expert_gemm_dx_ref` and
:func:`.ref.expert_gemm_dw_ref`.

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

from repro_torch.kernels import PLAIN_DEVICES, build
from repro_torch.kernels.expert_gemm.ref import (expert_gemm_dw_ref,
                                                 expert_gemm_dx_ref,
                                                 expert_gemm_ref)

FIRST = "expert_gemm"
TILES = "expert_gemm_wgmma"
SKINNY = "expert_gemm_skinny"
DX = "expert_gemm_dx"
DW = "expert_gemm_dw"
# gemm_bwd_variant's answer for a backward product on transposed copies
COPIES = "copies"
LAUNCHES: Dict[str, int] = {FIRST: 0, TILES: 0, SKINNY: 0, DX: 0, DW: 0}
# largest C the skinny variant takes (its wgmma N is C rounded up to 8,
# 16, 32 or 64); csrc/expert_gemm_wgmma.cu: SKINNY_MAX_C
SKINNY_MAX_C = 64
# the C entry point's `variant` argument (csrc/expert_gemm_wgmma.cu)
GEMM_VARIANTS = {TILES: 0, SKINNY: 1, DX: 2, DW: 3}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor, an: str,
                bn: str) -> None:
    if b.device != a.device:
        raise ValueError(f"{name}: {bn} on {b.device}, {an} on {a.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: {an} and {bn} must both be float32 or "
                         f"both bfloat16, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: {an} and {bn} must be contiguous")


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    _check_pair("expert_gemm", x, w, "x", "w")
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f"expert_gemm: wants x (N, C, d) and w (E, d, f), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[0] == 0 or x.shape[0] % w.shape[0] != 0:
        raise ValueError(f"expert_gemm: N={x.shape[0]} is not a multiple "
                         f"of E={w.shape[0]}")


def _tma_addressable(dtype: torch.dtype, d: int, f: int,
                     ptrs: Iterable[int]) -> bool:
    """bf16 with d and f positive multiples of 8 (TMA's 16-byte row
    strides) and every pointer 16-byte aligned."""
    return (dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f > 0
            and f % 8 == 0 and all(p % 16 == 0 for p in ptrs))


def gemm_variant(dtype: torch.dtype, C: int, d: int, f: int,
                 ptrs: Iterable[int]) -> str:
    """The kernel that takes a call, by shape alone: for bf16 that TMA can
    address (x, w, y), the TMA + wgmma source, as its skinny variant for
    C ≤ :data:`SKINNY_MAX_C` and its tiles variant above; the first kernel
    (WMMA bf16, FMA f32) for everything else."""
    if _tma_addressable(dtype, d, f, ptrs):
        return SKINNY if C <= SKINNY_MAX_C else TILES
    return FIRST


def gemm_bwd_variant(product: str, dtype: torch.dtype, d: int, f: int,
                     ptrs: Iterable[int]) -> str:
    """The route of backward product ``product`` (:data:`DX` or
    :data:`DW`; d and f the model's widths), by shape alone: for bf16 that
    TMA can address (both operands and the output), ``product`` itself,
    its variant of the TMA + wgmma source; :data:`COPIES` (``expert_gemm``
    on transposed copies) for everything else."""
    return product if _tma_addressable(dtype, d, f, ptrs) else COPIES


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` (the wgmma source's variants share one C
    entry point) on the current stream of ``device``; raise if the launch
    fails, count it if not."""
    lib = FIRST if name == FIRST else TILES
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = build.kernel(lib)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1


def expert_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, C, d) × (E, d, f) → (N, C, f), f32 accumulation over d."""
    _check(x, w)
    if x.device.type in PLAIN_DEVICES:
        return expert_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"expert_gemm runs on CUDA, CPU or meta tensors, not "
                           f"{x.device}")
    N, C, d = x.shape
    E, _, f = w.shape
    y = torch.empty((N, C, f), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
    name = gemm_variant(x.dtype, C, d, f, ptrs)
    if name == FIRST:
        _launch(FIRST, x.device, *ptrs, N, E, C, d, f,
                int(x.dtype == torch.bfloat16))
    else:
        _launch(name, x.device, *ptrs, N, E, C, d, f, GEMM_VARIANTS[name])
    return y


def expert_gemm_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, C, f) × (E, d, f) → (N, C, d): ``dx[n] = dy[n] @ w[n mod E]ᵀ``,
    f32 accumulation over f."""
    _check_pair(DX, dy, w, "dy", "w")
    if dy.dim() != 3 or w.dim() != 3 or dy.shape[2] != w.shape[2]:
        raise ValueError(f"{DX}: wants dy (N, C, f) and w (E, d, f), got "
                         f"{tuple(dy.shape)} and {tuple(w.shape)}")
    if w.shape[0] == 0 or dy.shape[0] % w.shape[0] != 0:
        raise ValueError(f"{DX}: N={dy.shape[0]} is not a multiple of "
                         f"E={w.shape[0]}")
    if dy.device.type in PLAIN_DEVICES:
        return expert_gemm_dx_ref(dy, w)
    if dy.device.type != "cuda":
        raise RuntimeError(f"{DX} runs on CUDA, CPU or meta tensors, not "
                           f"{dy.device}")
    N, C, f = dy.shape
    E, d, _ = w.shape
    dx = torch.empty((N, C, d), dtype=dy.dtype, device=dy.device)
    ptrs = (dy.data_ptr(), w.data_ptr(), dx.data_ptr())
    if gemm_bwd_variant(DX, dy.dtype, d, f, ptrs) == COPIES:
        return expert_gemm(dy, w.transpose(1, 2).contiguous())
    if dx.numel() > 0:
        # the entry point's (x, w, y, N, E, C, depth, width): depth f
        _launch(DX, dy.device, *ptrs, N, E, C, f, d, GEMM_VARIANTS[DX])
    return dx


def expert_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                   n_experts: int) -> torch.Tensor:
    """(N, C, d) and (N, C, f) → (E, d, f): ``dw[e] = Σ_g x[g·E + e]ᵀ @
    dy[g·E + e]`` over the N = G·E matrices, f32 accumulation over the
    G·C rows."""
    _check_pair(DW, x, dy, "x", "dy")
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"{DW}: wants x (N, C, d) and dy (N, C, f), got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if n_experts <= 0 or x.shape[0] % n_experts != 0:
        raise ValueError(f"{DW}: N={x.shape[0]} is not a multiple of "
                         f"E={n_experts}")
    if x.device.type in PLAIN_DEVICES:
        return expert_gemm_dw_ref(x, dy, n_experts)
    if x.device.type != "cuda":
        raise RuntimeError(f"{DW} runs on CUDA, CPU or meta tensors, not "
                           f"{x.device}")
    N, C, d = x.shape
    f = dy.shape[2]
    E = n_experts
    dw = torch.empty((E, d, f), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), dy.data_ptr(), dw.data_ptr())
    if gemm_bwd_variant(DW, x.dtype, d, f, ptrs) == COPIES:
        G = N // E
        # (G, E, C, ·) → (E, ·, G·C): one contraction over G·C rows
        xt = x.view(G, E, C, d).permute(1, 3, 0, 2).reshape(E, d, G * C)
        dyt = dy.view(G, E, C, f).transpose(0, 1).reshape(E, G * C, f)
        return expert_gemm(xt.contiguous(), dyt.contiguous())
    if N * C == 0:
        return dw.zero_()
    _launch(DW, x.device, *ptrs, N, E, C, d, f, GEMM_VARIANTS[DW])
    return dw


class ExpertGemm(torch.autograd.Function):
    """``expert_gemm`` with a gradient: ``expert_gemm_dx`` and
    ``expert_gemm_dw`` (kernels on CUDA tensors, their plain versions on
    CPU tensors), in the inputs' dtype with f32 accumulation."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return expert_gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = expert_gemm_dx(dy, w)
        if ctx.needs_input_grad[1]:
            dw = expert_gemm_dw(x, dy, w.shape[0])
        return dx, dw
