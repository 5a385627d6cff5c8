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

With ``return_lse=True`` it also returns each row's log-sum-exp (f32,
(B, H, Sq)), which both kernels write on request. The backward pass,
``flash_attention_bwd``, runs from the saved output and log-sum-exp: on CUDA
tensors :func:`flash_bwd_variant` sends bf16 with hd 64 or 128 and 16-byte
aligned tensors to ``csrc/flash_attention_bwd_wgmma.cu`` (TMA + wgmma),
everything else to ``csrc/flash_attention_bwd.cu``; on CPU tensors it runs
:func:`.ref.flash_attention_bwd_ref`. :class:`FlashAttention` ties the two
together as an autograd function: the path a loss is differentiated
through.

:data:`LAUNCHES` counts launches per kernel, bumped only where the kernel
is launched, so a run can show that its path went through the kernel (a
backward's passes are one launch of its entry point).

The JAX wrapper's Pallas tile arguments ``block_q`` and ``block_k`` are
not ported: each CUDA kernel fixes its tiles in its source, sized to its
shared-memory and register budget, so a caller has no tile to pick.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

WGMMA = "flash_attention_fwd_wgmma"
FIRST = "flash_attention_fwd"
BWD = "flash_attention_bwd"
BWD_WGMMA = "flash_attention_bwd_wgmma"
LAUNCHES: Dict[str, int] = {FIRST: 0, WGMMA: 0, BWD: 0, BWD_WGMMA: 0}
MAX_HEAD_DIM = 128
WGMMA_HEAD_DIMS = (64, 128)
# the TMA backward's per-row lse and D scratch is padded to this many rows
BWD_WGMMA_ROWS = 64


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


def flash_bwd_variant(dtype: torch.dtype, hd: int, sq: int, sk: int,
                      ptrs: Iterable[int]) -> str:
    """The backward kernel that takes a call, by shape alone: the TMA +
    wgmma kernel for bf16 with hd 64 or 128, at least one query and one
    key, and every pointer (q, k, v, O, dO, dq, dk, dv) 16-byte aligned;
    the first backward kernel (mma.sync bf16, or f32) for everything
    else."""
    if (dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and sq > 0
            and sk > 0 and all(p % 16 == 0 for p in ptrs)):
        return BWD_WGMMA
    return BWD


def _device_ok(q: torch.Tensor, what: str) -> bool:
    """True for CUDA tensors (launch a kernel), False for CPU tensors (run
    the plain version); raises for any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"{what} runs on CUDA or CPU tensors, not "
                           f"{q.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    return_lse: bool = False):
    """Softmax attention of q over k, v; query row i sits at position
    ``q_offset + i`` for the causal mask. With ``return_lse`` returns
    (o, lse), lse f32 (B, H, Sq)."""
    _check(q, k, v)
    if not _device_ok(q, "flash_attention"):
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   return_lse=return_lse)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0:
        if lse is not None:
            lse.fill_(float("-inf"))
        return (o, lse) if return_lse else o
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    name = flash_variant(q.dtype, hd, Sq, Sk, ptrs)
    fn = build.kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the first kernel takes both types and is told which
        dtype_flag = (() if name == WGMMA
                      else (int(q.dtype == torch.bfloat16),))
        rc = fn(*ptrs, None if lse is None else lse.data_ptr(), B, Sq, Sk,
                H, KV, hd, q_offset, int(causal), *dtype_flag, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True, q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention`` from its output ``o``, the
    output's gradient ``do`` (both like q) and the forward's ``lse``. The
    TMA kernel computes D = rowsum(dO·O) itself and sums the G query
    heads' dK, dV partials (f32 scratch made here) in a fixed order; for
    the first kernel D is a plain f32 reduction here. Each kernel's passes
    run in one launch of its entry point."""
    _check(q, k, v)
    for key, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {key} must be a "
                             f"contiguous {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 {(B, H, Sq)} on {q.device}")
    if not _device_ok(q, "flash_attention_bwd"):
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       q_offset=q_offset)
    if Sq == 0 or Sk == 0 or B * H * hd == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = tuple(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv))
    name = flash_bwd_variant(q.dtype, hd, Sq, Sk, ptrs)
    if name == BWD_WGMMA:
        sq_pad = -(-Sq // BWD_WGMMA_ROWS) * BWD_WGMMA_ROWS
        stats = torch.empty((2, B, H, sq_pad), dtype=torch.float32,
                            device=q.device)           # lse·log2(e), D
        partials = torch.empty((2, B, Sk, H, hd), dtype=torch.float32,
                               device=q.device)        # dK, dV per q head
        args = (*ptrs[:5], lse.data_ptr(), *ptrs[5:], stats.data_ptr(),
                partials.data_ptr(), B, Sq, Sk, H, KV, hd, q_offset,
                int(causal))
    else:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, hd, q_offset,
                int(causal), int(q.dtype == torch.bfloat16))
    fn = build.kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward runs the kernel
    (or the plain version on the CPU) and saves q, k, v, O and the
    log-sum-exp; the backward runs ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, q_offset: int = 0):
        o, lse = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None
