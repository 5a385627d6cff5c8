"""Plain PyTorch versions of flash attention (dense softmax attention).

``attention_ref`` is the oracle on flattened heads, as in the JAX package;
``flash_attention_ref`` computes the same function in the model layout
with grouped KV heads (and, on request, each row's log-sum-exp) and serves
the CPU path of
:func:`~repro_torch.kernels.flash_attention.ops.flash_attention` and the
kernel-vs-plain checks on the card; ``flash_attention_bwd_ref`` is the
backward pass from the saved output and log-sum-exp, the plain version of
``csrc/flash_attention_bwd.cu``. All materialise the (Sq, Sk) scores in
f32.
"""

from __future__ import annotations

import torch


def causal_mask(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    """(sq, sk) bool: key j visible to query row i (position q_offset + i)."""
    q_pos = q_offset + torch.arange(sq, device=device)
    return torch.arange(sk, device=device)[None, :] <= q_pos[:, None]


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            q_offset: int) -> torch.Tensor:
    """Scaled f32 scores of q (BH, Sq, hd) against k (BH, Sk, hd), masked
    keys at -inf."""
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (hd ** 0.5)
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
        s = s.masked_fill(~mask[None], float("-inf"))
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd). Query row i sits at position
    ``q_offset + i`` for the causal mask."""
    p = torch.softmax(_scores(q, k, causal, q_offset), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H = KV·G → o (B, Sq, H, hd)
    or, with ``return_lse``, (o, lse) with lse f32 (B, H, Sq), each row's
    log-sum-exp of its scaled scores (-inf for a row that sees no key)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd)
    # query head h reads KV head h // G
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    o = attention_ref(qh, kh, vh, causal=causal, q_offset=q_offset)
    o = o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3).contiguous()
    if not return_lse:
        return o
    lse = torch.logsumexp(_scores(qh, kh, causal, q_offset), dim=-1)
    return o, lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor,
                            causal: bool = True, q_offset: int = 0):
    """Gradients (dq, dk, dv) of softmax attention in the model layout, in
    the inputs' dtypes, from the forward's output ``o`` and log-sum-exp
    ``lse`` (B, H, Sq): P = exp(scale·qkᵀ − lse), D = rowsum(dO·O),
    dS = P·(dO vᵀ − D); dq = scale·dS k, and dk = scale·dSᵀ q and dv = Pᵀ dO
    summed over the G query heads of each KV head. One KV head at a time,
    in f32, so the (G, Sq, Sk) tiles stay small at the served shapes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    sqrt_hd = hd ** 0.5
    mask = (causal_mask(Sq, Sk, q_offset, q.device) if causal
            else torch.ones((Sq, Sk), dtype=torch.bool, device=q.device))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for b in range(B):
        for kv in range(KV):
            heads = slice(kv * G, (kv + 1) * G)
            qg = q[b, :, heads].float().transpose(0, 1)         # (G, Sq, hd)
            dog = do[b, :, heads].float().transpose(0, 1)
            og = o[b, :, heads].float().transpose(0, 1)
            kf, vf = k[b, :, kv].float(), v[b, :, kv].float()   # (Sk, hd)
            s = torch.einsum("gqd,kd->gqk", qg, kf) / sqrt_hd
            p = torch.where(mask, torch.exp(s - lse[b, heads, :, None]), 0.0)
            dp = torch.einsum("gqd,kd->gqk", dog, vf)
            delta = (dog * og).sum(-1)                          # (G, Sq)
            ds = p * (dp - delta[..., None])
            dv[b, :, kv] = torch.einsum("gqk,gqd->kd", p, dog).to(v.dtype)
            dk[b, :, kv] = (torch.einsum("gqk,gqd->kd", ds, qg)
                            / sqrt_hd).to(k.dtype)
            dq[b, :, heads] = (torch.einsum("gqk,kd->gqd", ds, kf)
                               / sqrt_hd).transpose(0, 1).to(q.dtype)
    return dq, dk, dv
