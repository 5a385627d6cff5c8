"""Plain PyTorch versions of flash attention (dense softmax attention).

``attention_ref`` is the oracle on flattened heads, as in the JAX package;
``flash_attention_ref`` computes the same function in the model layout
with grouped KV heads and serves the CPU path of
:func:`~repro_torch.kernels.flash_attention.ops.flash_attention` and the
kernel-vs-plain checks on the card. Both materialise the (Sq, Sk) scores
in f32.
"""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd). Query row i sits at position
    ``q_offset + i`` for the causal mask."""
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (hd ** 0.5)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = torch.arange(sk, device=q.device)[None, :] <= q_pos[:, None]
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H = KV·G → (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd)
    # query head h reads KV head h // G
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    o = attention_ref(qh, kh, vh, causal=causal, q_offset=q_offset)
    return o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3).contiguous()
