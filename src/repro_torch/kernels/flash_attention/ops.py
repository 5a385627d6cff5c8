"""Public wrapper of the flash-attention kernel, in the model layout.

``flash_attention(q, k, v)`` takes q (B, Sq, H, hd) and k, v (B, Sk, KV, hd)
with H = KV·G, all f32 or all bf16, and returns (B, Sq, H, hd) in q's type.
It checks its inputs, then:

* on CUDA tensors launches ``csrc/flash_attention_fwd.cu`` (built on first
  use by :mod:`repro_torch.kernels.build`) on the current stream, or raises;
* on CPU tensors runs the plain version, :func:`.ref.flash_attention_ref`.

:data:`LAUNCHES` counts kernel launches, bumped only where the kernel is
launched, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}
MAX_HEAD_DIM = 128


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
    fn = build.kernel("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                Sq, Sk, H, KV, hd, q_offset, int(causal),
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed "
                           f"(cudaError {rc})")
    LAUNCHES["flash_attention_fwd"] += 1
    return o
