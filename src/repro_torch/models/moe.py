"""Mixture-of-Experts block — grouped sort-based capacity dispatch
(PyTorch port of ``repro.models.moe``).

Tokens are split into groups; within each group, (token, expert) slots
are sorted by expert id, truncated to a static per-expert capacity C and
run through the grouped expert GEMM kernel over the whole (G, E, C, d)
dispatch buffer (three launches: gate, up, down), as the autograd function
``ExpertGemm``, whose backward is two more launches of the same kernels per
product. The gradient reaches the router through the gates (the sorted
values of ``top_k_stable``) and the aux loss's mean probabilities.
Overflow slots beyond capacity are dropped (GShard/Switch semantics); the
Switch load-balance aux loss is returned too.

Order is kept where the JAX block fixes it: the top-k breaks ties toward
the lower expert id (a stable descending sort), the slot sort is stable,
and the combine is a gather in which each token sums its own kept slots
in ascending sorted-slot order, starting from zero — the order of the
reference's scatter-add, and free of atomics, so two runs on the card
give the same bits.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.kernels.expert_gemm import ExpertGemm


def moe_capacity(group_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    c = int(group_tokens * top_k * capacity_factor / n_experts) + 1
    return max(8, -(-c // 8) * 8)  # multiple of 8, as the reference


def top_k_stable(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties toward the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One MoE block's routing: G groups of S tokens, capacity C per expert;
    N = S·k (token, expert) slots per group, in sorted order where noted."""
    G: int
    S: int
    C: int
    probs: torch.Tensor       # (G, S, E) f32 router softmax
    gate_vals: torch.Tensor   # (G, S, k) renormalised top-k probabilities
    expert_idx: torch.Tensor  # (G, S, k) top-k experts, ties to lower ids
    perm: torch.Tensor        # (G, N) stable sort of the slots by expert
    tokens: torch.Tensor      # (G, N) token of each sorted slot
    gates: torch.Tensor       # (G, N) gate of each sorted slot
    keep: torch.Tensor        # (G, N) sorted slot within capacity
    rows: torch.Tensor        # (G, N) dispatch row e·C + rank, E·C if dropped


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
          n_groups: int, capacity_factor: float = 1.25) -> Routing:
    """Top-k routing and the per-group sort-based slot assignment of
    ``moe_block`` for x: (T, d)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = n_groups if T % n_groups == 0 else 1
    S = T // G
    C = moe_capacity(S, E, k, capacity_factor)
    dev = x.device

    logits = (x.reshape(G, S, d) @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                     # (G, S, E)
    gate_vals, expert_idx = top_k_stable(probs, k)            # (G, S, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                # renormalize

    N = S * k
    e_flat = expert_idx.reshape(G, N)
    tok_flat = torch.arange(S, device=dev).repeat_interleave(k) \
        .expand(G, N)
    se, perm = torch.sort(e_flat, dim=1, stable=True)
    st = tok_flat.gather(1, perm)
    sg = gate_vals.reshape(G, N).gather(1, perm)

    ar = torch.arange(N, device=dev)[None, :]
    is_start = torch.cat([torch.ones((G, 1), dtype=torch.bool, device=dev),
                          se[:, 1:] != se[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    pos = ar - run_start                                      # rank within expert
    keep = pos < C
    rows = torch.where(keep, se * C + pos, E * C)             # E*C → dropped
    return Routing(G, S, C, probs, gate_vals, expert_idx, perm, st, sg,
                   keep, rows)


def moe_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
              cfg: MoEConfig, n_groups: int,
              capacity_factor: float = 1.25,
              exp_spec=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) → (y: (T, d), aux_loss scalar).

    params: router (d, E); wg/wu (E, d, f); wd (E, f, d).
    """
    if exp_spec is not None:
        raise NotImplementedError(
            "moe_block: exp_spec (expert-parallel sharding) waits for the "
            "LM's multi-GPU layers (ROADMAP queue 1, item 13)")
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    r = route(x, params["router"], cfg, n_groups, capacity_factor)
    G, S, C = r.G, r.S, r.C
    N = S * k
    dev = x.device

    # Switch aux loss: E * mean(fraction routed to e) * mean(router prob e)
    me = r.probs.mean(dim=(0, 1))                             # (E,)
    ce = torch.bincount(r.expert_idx.reshape(-1), minlength=E).float() \
        / (G * S * k)
    aux = E * torch.sum(me * ce)

    # dispatch: kept slots land in a flat (G·E·C, d) buffer; dropped ones in
    # one extra row past its end, cut off before the products
    g_base = (torch.arange(G, device=dev) * (E * C))[:, None]
    dst = torch.where(r.keep, g_base + r.rows, G * E * C)
    buf = torch.zeros((G * E * C + 1, d), dtype=x.dtype, device=dev)
    src = x.reshape(G, S, d).gather(1, r.tokens[..., None].expand(G, N, d))
    buf[dst.reshape(-1)] = src.reshape(G * N, d)
    x_exp = buf[:G * E * C].view(G * E, C, d)

    wg = params["wg"].to(x.dtype)                             # (E, d, f)
    wu = params["wu"].to(x.dtype)
    wd = params["wd"].to(x.dtype)                             # (E, f, d)
    gemm = ExpertGemm.apply
    h = F.silu(gemm(x_exp, wg)) * gemm(x_exp, wu)
    y_exp = gemm(h, wd).view(G, E * C, d)

    # combine: sorted slot i feeds token r.tokens[i]; each token gathers its
    # k slots and adds them in ascending sorted position, starting from 0
    picked = y_exp.gather(
        1, torch.clamp_max(r.rows, E * C - 1)[..., None].expand(G, N, d))
    picked = picked * (r.gates * r.keep).to(y_exp.dtype)[..., None]
    inv = torch.empty_like(r.perm)                            # slot → sorted pos
    inv.scatter_(1, r.perm, torch.arange(N, device=dev).expand(G, N))
    order = torch.sort(inv.view(G, S, k), dim=-1).values
    mine = picked.gather(1, order.reshape(G, N)[..., None].expand(G, N, d)) \
        .view(G, S, k, d)
    y = torch.zeros((G, S, d), dtype=y_exp.dtype, device=dev)
    for j in range(k):
        y = y + mine[:, :, j]
    return y.reshape(T, d), aux.float()


def init_moe_params(gen: torch.Generator, cfg: MoEConfig, d_model: int,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Router and expert weights on the generator's device, drawn in f32
    and stored in ``dtype``."""
    E, f = cfg.n_experts, cfg.d_ff_expert
    s_in = (2.0 / (d_model + f)) ** 0.5

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dtype)

    return {
        "router": normal((d_model, E), 0.02),
        "wg": normal((E, d_model, f), s_in),
        "wu": normal((E, d_model, f), s_in),
        "wd": normal((E, f, d_model), s_in),
    }
