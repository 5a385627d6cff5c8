"""Public wrapper of the grouped expert GEMM kernel.

``expert_gemm(x, w)`` multiplies x (N, C, d) by w (E, d, f) as
``y[n] = x[n] @ w[n mod E]``, so the MoE block's (G, E, C, d) dispatch
buffer goes in whole as N = G·E matrices. Both f32 or both bf16. It checks
its inputs, then:

* on CUDA tensors launches ``csrc/expert_gemm.cu`` (built on first use by
  :mod:`repro_torch.kernels.build`) on the current stream, or raises;
* on CPU tensors runs the plain version, :func:`.ref.expert_gemm_ref`.

:data:`LAUNCHES` counts kernel launches, bumped only where the kernel is
launched.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.expert_gemm.ref import expert_gemm_ref

LAUNCHES: Dict[str, int] = {"expert_gemm": 0}


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
    fn = build.kernel("expert_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), N, E, C, d, f,
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"expert_gemm kernel launch failed (cudaError "
                           f"{rc})")
    LAUNCHES["expert_gemm"] += 1
    return y
