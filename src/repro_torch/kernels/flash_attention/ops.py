"""Public wrapper of the flash-attention kernel, in the model layout.

``flash_attention(q, k, v)`` takes q (B, Sq, H, hd) and k, v (B, Sk, KV, hd)
with H = KV·G, all f32 or all bf16, and returns (B, Sq, H, hd) in q's type.
It checks its inputs, then:

* on CUDA tensors launches one of two kernels (built on first use by
  :mod:`repro_torch.kernels.build`) on the current stream, or raises;
  :func:`flash_variant` picks it by shape: bf16 with hd 64 or 128 and
  16-byte aligned tensors go to ``csrc/flash_attention_fwd_wgmma.cu``
  (TMA + wgmma), everything else to ``csrc/flash_attention_fwd.cu``;
* on CPU tensors runs the plain version, :func:`.ref.flash_attention_ref`.

:data:`LAUNCHES` counts launches per kernel, bumped only where the kernel
is launched, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

WGMMA = "flash_attention_fwd_wgmma"
FIRST = "flash_attention_fwd"
LAUNCHES: Dict[str, int] = {FIRST: 0, WGMMA: 0}
MAX_HEAD_DIM = 128
WGMMA_HEAD_DIMS = (64, 128)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {key} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {key} is {t.dtype}, q is "
                             f"{q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {key} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {key} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: float32 or bfloat16, got "
                         f"{q.dtype}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k, v must be (B={B}, Sk, KV, "
                         f"hd={hd}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if k.shape[2] == 0 or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"onto {k.shape[2]} KV heads")


def flash_variant(dtype: torch.dtype, hd: int, sq: int, sk: int,
                  ptrs: Iterable[int]) -> str:
    """The kernel that takes a call, by shape alone: the TMA + wgmma kernel
    for bf16 with hd 64 or 128, at least one query and one key, and every
    pointer (q, k, v, o) 16-byte aligned, as TMA needs; the first kernel
    (mma.sync bf16, or f32) for everything else."""
    if (dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and sq > 0
            and sk > 0 and all(p % 16 == 0 for p in ptrs)):
        return WGMMA
    return FIRST


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Softmax attention of q over k, v; query row i sits at position
    ``q_offset + i`` for the causal mask."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CUDA or CPU tensors, "
                           f"not {q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    name = flash_variant(q.dtype, hd, Sq, Sk, ptrs)
    fn = build.kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the first kernel takes both types and is told which
        dtype_flag = (() if name == WGMMA
                      else (int(q.dtype == torch.bfloat16),))
        rc = fn(*ptrs, B, Sq, Sk, H, KV, hd, q_offset, int(causal),
                *dtype_flag, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return o
