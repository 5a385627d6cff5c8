"""Transformer building blocks (PyTorch port of ``repro.models.layers``).

Plain functions over parameter tensors, with the JAX package's layouts:
activations (B, S, d), attention tensors (B, S, H, hd) with H = KV·G
(GQA), and the same casts in the same places (RMSNorm and RoPE in f32,
attention statistics in f32). ``blockwise_attention`` is the serving path's
prefill attention: on CUDA tensors it launches the flash-attention kernel,
on CPU tensors it runs the plain online-softmax scan over KV blocks; when a
gradient is needed it goes through the autograd function
``FlashAttention`` instead (the kernels forward and backward on CUDA, their
plain versions on the CPU). ``softmax_xent_chunked`` and
``softmax_xent_sharded`` are the training loss's cross entropy; handed a
``TPView`` head (the ``tp2d`` train step), the latter is the
vocab-parallel loss over each position's vocab block, its sums and counts
added over the batch shards (``distrib.collectives.tp_vocab_xent``).

Every product with a weight goes through :func:`linear`: handed a
``distrib.collectives.TPView`` (training on a mesh under ``tp2d``) it
multiplies each position's rows by the weight's column or row block
gathered along "data"; handed a ``StationaryView`` (serving under
``tp2d``) it multiplies on the positions that hold the weight's blocks;
the activations are then
:class:`~repro_torch.distrib.collectives.Rows`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distrib.collectives import (LyingHead, Rows,
                                             StationaryView, TPView,
                                             block_matmul, each, tp_linear,
                                             tp_resplit_linear,
                                             tp_rows_linear, tp_vocab_xent)
from repro_torch.kernels import PLAIN_DEVICES
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., None].float() * freqs                   # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _scale(hd: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32,
                                         device=device))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention, O(block·S) memory.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H = KV·G (GQA). On CUDA
    tensors this is one launch of the flash-attention kernel (``block`` is
    the CPU scan's knob and does not reach it); on CPU tensors a scan over
    KV blocks keeps the running (max, denominator, accumulator) in f32.
    When autograd needs a gradient of q, k or v, it is ``FlashAttention``
    on either device (the forward also keeps each row's log-sum-exp). Meta
    tensors take the CPU's scan (shapes only).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, q_offset)
    if q.device.type not in PLAIN_DEVICES:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               q_offset=q_offset)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qf = q.reshape(B, Sq, KV, G, hd).float() * _scale(hd, dev)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    m = torch.full((B, KV, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, KV, G, Sq), device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), device=dev)
    for lo in range(0, Sk, block):
        hi = min(lo + block, Sk)
        kf = k[:, lo:hi].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)           # (B,KV,G,Sq,blk)
        if causal:
            kv_pos = torch.arange(lo, hi, device=dev)
            valid = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(valid[None, None, None], s, neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p, v[:, lo:hi].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, KV * G, Sq, hd).permute(0, 2, 1, 3) \
              .to(q.dtype).contiguous()


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Reference full-materialization attention (tests / tiny shapes)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.reshape(B, Sq, KV, G, hd).float() * _scale(hd, q.device)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = torch.arange(Sk, device=q.device)[None, :] <= q_pos[:, None]
        s = s.masked_fill(~mask[None, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, hd) \
              .to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-token decode against a KV cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); ``cache_len`` (B,) masks the
    slots at and past each row's length. Plain reductions in f32."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float() * _scale(hd, q.device)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    if cache_len is not None:
        valid = torch.arange(S, device=q.device)[None] < cache_len[:, None]
        s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp_min(l, 1e-30),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, valid: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """:func:`decode_attention` over one slice of the cache, unnormalised:
    the slots ``[0, valid)`` of ``k_cache``/``v_cache`` (B, S_slice, KV,
    hd) count, the rest are masked. Returns f32 (m, l, o): m (B, KV, G) the
    slice's largest scaled score (−inf where no slot counts), l the sum of
    exp(s − m) and o (B, KV, G, hd) the sum of exp(s − m)·v, both 0 where
    no slot counts. :func:`combine_attention_partials` joins the slices
    (flash-decoding's split)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float() * _scale(hd, q.device)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    counts = torch.arange(S, device=q.device) < valid
    s = s.masked_fill(~counts, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return m, l, o


def combine_attention_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """The attention output (B, 1, H, hd) in ``dtype`` from the slices'
    (m, l, o) of :func:`decode_attention_partial`, on one device, added in
    the order given: each slice rescaled by exp(m_j − max_j m_j) (0 for a
    slice with no slot), in f32."""
    m = parts[0][0]
    for mj, _, _ in parts[1:]:
        m = torch.maximum(m, mj)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    l = o = None
    for mj, lj, oj in parts:
        a = torch.where(torch.isfinite(mj), torch.exp(mj - m_safe), 0.0)
        l = a * lj if l is None else l + a * lj
        o = a[..., None] * oj if o is None else o + a[..., None] * oj
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    B, KV, G, hd = out.shape
    return out.reshape(B, 1, KV * G, hd).to(dtype)


def linear(x, w, dtype: torch.dtype, bias=None):
    """``x @ w.to(dtype)`` (+ ``bias.to(dtype)``); with a ``TPView`` weight
    (the ``tp2d`` train step, and serving under ``tp2d`` with the batch
    split) ``tp_linear`` of every position's rows ``x``: a column or row
    block of the weight gathered along "data" at each position, or, where
    the view says so (``TPView.gathers``: a decode step's row blocks, the
    head), ``tp_rows_linear``: the rows moved to the blocks where they
    lie, or, for a decode step's router (``TPView.resplits``),
    ``tp_resplit_linear``: the weight re-split over "model" where it lies
    and the partials summed; with a :class:`StationaryView` weight (serving
    under ``tp2d`` with the batch whole) ``block_matmul`` of the batch
    shards' rows ``x``; with the weight as ``Rows`` (the ``fsdp`` train
    step's microbatch over several homes, each home's leaf gathered there)
    each home's product."""
    if isinstance(w, Rows):         # each home's own whole weight
        return each(linear, x, w, dtype, bias)
    if isinstance(w, TPView):
        if w.gathers():
            return tp_linear(x, w, dtype, bias)
        if bias is not None:
            raise ValueError("linear: a bias beside a weight whose rows "
                             "move to its blocks")
        if w.resplits():
            return tp_resplit_linear(x, w, dtype)
        return tp_rows_linear(x, w, dtype)
    if isinstance(w, StationaryView):
        return block_matmul(x, w, dtype, bias)
    y = x @ w.to(dtype)
    return y if bias is None else y + bias.to(dtype)


def _gated(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(g) * u


def swiglu(x, w_gate, w_up, w_down):
    g = linear(x, w_gate, x.dtype)
    u = linear(x, w_up, x.dtype)
    return linear(each(_gated, g, u), w_down, x.dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Glorot-normal (d_in, d_out) weight on ``device`` (default: the
    generator's; ``"meta"`` draws nothing)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    dev = gen.device if device is None else device
    return (torch.randn((d_in, d_out), generator=gen, device=dev)
            * scale).to(dtype)


def softmax_xent_sharded(hidden, head_w, labels, sums: bool = False):
    """Mean cross entropy of the logits ``hidden @ head_w`` over the labels
    ≥ 0, with the target logit taken by a one-hot contraction, as the
    reference's vocab-parallel loss does. On plain tensors, on one device
    (with ``sums``, the sum of the terms and their int32 count instead).
    With ``hidden`` and ``labels`` as ``Rows`` and ``head_w`` a ``TPView``
    (the ``tp2d`` train step), over each position's vocab block gathered
    along "data", only per-row statistics crossing "model", the sums and
    counts added over "data": the mean over the rows of every batch shard,
    at each position (``distrib.collectives.tp_vocab_xent``), as Rows; a
    ``LyingHead`` (the ``fsdp`` step's head where its blocks lie), over
    those blocks as the reference's partitioner forms the loss, the
    logits never assembled (``distrib.collectives.vocab_parallel_xent``):
    a home's mean, or with ``Rows`` each home's sums added over the homes,
    as Rows."""
    if isinstance(head_w, TPView):
        return tp_vocab_xent(hidden, head_w, labels)
    if isinstance(head_w, LyingHead):
        return head_w.xent(hidden, labels)
    logits = (hidden @ head_w.to(hidden.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    onehot = labels[..., None] == torch.arange(V, device=labels.device)
    tgt = torch.einsum("bsv,bsv->bs", logits, onehot.float())
    valid = labels >= 0
    tot = torch.where(valid, lse - tgt, 0.0).sum()
    if sums:
        return tot, valid.sum().to(torch.int32)
    return tot / torch.clamp_min(valid.sum(), 1)


def softmax_xent_chunked(logits_fn, x: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512, sums: bool = False):
    """Cross entropy over a huge vocab without materialising all logits
    (with ``sums``, the sum of the terms and their int32 count).

    ``logits_fn(x_chunk) -> (B, chunk, V)``; the sequence is padded to a
    multiple of ``chunk`` (labels -1, which count nothing) and summed chunk
    by chunk in order, as the reference's scan. When a gradient is needed
    each chunk runs under ``torch.utils.checkpoint``, so its f32 logits are
    recomputed in the backward pass instead of kept (the reference's scan
    keeps them: the same values, more memory)."""
    B, S, _ = x.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    xp = F.pad(x, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad), value=-1)

    def body(xb, lb):
        logits = logits_fn(xb).float()
        lse = torch.logsumexp(logits, dim=-1)
        idx = torch.clamp_min(lb, 0)[..., None].long()
        tgt = logits.gather(-1, idx)[..., 0]
        valid = lb >= 0
        return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    remat = torch.is_grad_enabled() and x.requires_grad
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        if remat:
            t, c = checkpoint(body, xp[:, sl], lp[:, sl], use_reentrant=False)
        else:
            t, c = body(xp[:, sl], lp[:, sl])
        tot = tot + t
        cnt = cnt + c
    if sums:
        return tot, cnt.to(torch.int32)
    return tot / torch.clamp_min(cnt, 1)
