"""Decoder-only transformer LM, dense and MoE, for serving and training
(PyTorch port of ``repro.models.transformer``).

GQA (+ optional QKV bias), RoPE, RMSNorm, SwiGLU or a routed MoE MLP.
Parameters are a plain dictionary with one dictionary per layer in
``params["layers"]`` (the JAX package stacks them on a leading axis for its
``lax.scan``; :func:`params_from_jax` unstacks). Serving stores weights in
the compute dtype: every use in the reference casts to it first, so that
is exact and keeps the card's weights at 2 bytes each in bf16. Training
keeps f32 masters, as the reference does (``init(..., dtype=float32)``),
and casts at each use; ``cfg.remat == "full"`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint``. ``cfg.remat == "dots"`` is the reference's
``checkpoint_dots_with_no_batch_dims`` policy as a selective checkpoint
(:func:`dots_policy`): the outputs of the products with a 2-D weight
(``aten.mm``/``aten.addmm``: the QKV and output projections, the dense
SwiGLU's three products, the router) are saved, everything else in the
layer is recomputed — attention and the expert GEMMs (batched products in
the reference, so its policy saves neither), norms, RoPE, activations.
The flash and expert-GEMM kernels launch from Python through the
extension, not as dispatched ops, so the policy never sees them: they run
again in the recompute, as the reference recomputes those products.

Entry points:
  init(generator, dtype)                 → params
  forward(params, tokens)                → (hidden, aux)
  loss(params, tokens, labels)           → scalar
  logits(params, hidden)                 → logits
  prefill(params, tokens)                → (logits_last, kv_cache)
  decode_step(params, token, cache, cache_len) → (logits, cache)
  make_cache(batch, seq_len)             → zero kv_cache

The KV cache is (L, B, S, KV, hd) ×2 in bf16, as in the reference, even for
f32 configs. ``decode_step`` writes the new token's keys and values into
the cache in place (the reference returns an updated copy) and returns it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.base import TransformerConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe_params, moe_block

Params = Dict[str, Any]
Cache = Tuple[torch.Tensor, torch.Tensor]

# the products of a 2-D weight: what checkpoint_dots_with_no_batch_dims saves
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the outputs of products without a batch
    dimension, recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXTS = functools.partial(create_selective_checkpoint_contexts,
                                   dots_policy)


class TransformerLM:
    def __init__(self, cfg: TransformerConfig, moe_group_size: int = 4096,
                 act_spec=None):
        if act_spec is not None:
            raise NotImplementedError(
                "TransformerLM: act_spec (activation sharding) waits for the "
                "LM's multi-GPU layers (ROADMAP queue 1, item 13)")
        self.cfg = cfg
        self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                              else torch.float32)
        self.moe_group_size = moe_group_size

    # -- init -----------------------------------------------------------------

    def init_layer(self, gen: torch.Generator,
                   dtype: Optional[torch.dtype] = None) -> Params:
        cfg = self.cfg
        cd = self.compute_dtype if dtype is None else dtype
        d, hd = cfg.d_model, cfg.head_dim
        H, KV = cfg.n_heads, cfg.n_kv_heads
        dev = gen.device
        p: Params = {
            "ln1": torch.ones((d,), dtype=cd, device=dev),
            "ln2": torch.ones((d,), dtype=cd, device=dev),
            "wq": L.init_linear(gen, d, H * hd, cd),
            "wk": L.init_linear(gen, d, KV * hd, cd),
            "wv": L.init_linear(gen, d, KV * hd, cd),
            "wo": L.init_linear(gen, H * hd, d, cd),
        }
        if cfg.qkv_bias:
            p["bq"] = torch.zeros((H * hd,), dtype=cd, device=dev)
            p["bk"] = torch.zeros((KV * hd,), dtype=cd, device=dev)
            p["bv"] = torch.zeros((KV * hd,), dtype=cd, device=dev)
        if cfg.moe is None:
            p["wg"] = L.init_linear(gen, d, cfg.d_ff, cd)
            p["wu"] = L.init_linear(gen, d, cfg.d_ff, cd)
            p["wd"] = L.init_linear(gen, cfg.d_ff, d, cd)
        else:
            p["moe"] = init_moe_params(gen, cfg.moe, d, cd)
            if cfg.moe.n_shared_experts:
                f = cfg.moe.n_shared_experts * cfg.moe.d_ff_expert
                p["sg"] = L.init_linear(gen, d, f, cd)
                p["su"] = L.init_linear(gen, d, f, cd)
                p["sd"] = L.init_linear(gen, f, d, cd)
        return p

    def init(self, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Params:
        """Random weights on the generator's device, drawn from it in f32
        and stored in ``dtype`` (default: the compute dtype, for serving;
        training passes ``torch.float32`` for f32 masters)."""
        cfg = self.cfg
        cd = self.compute_dtype if dtype is None else dtype
        dev = generator.device
        params: Params = {
            "embed": (torch.randn((cfg.vocab_size, cfg.d_model),
                                  generator=generator, device=dev)
                      * 0.02).to(cd),
            "ln_f": torch.ones((cfg.d_model,), dtype=cd, device=dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = L.init_linear(generator, cfg.d_model,
                                           cfg.vocab_size, cd)
        params["layers"] = [self.init_layer(generator, cd)
                            for _ in range(cfg.n_layers)]
        return params

    # -- layer body -------------------------------------------------------------

    def _attn(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
              kv: Optional[Cache] = None, cache_len: int = 0
              ) -> Tuple[torch.Tensor, Cache]:
        """kv: this layer's (k_cache, v_cache) for decode, written in place
        at ``cache_len``."""
        cfg = self.cfg
        B, S, d = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        cd = self.compute_dtype
        h = L.rms_norm(x, p["ln1"].to(cd), cfg.rms_eps)
        q = h @ p["wq"].to(cd)
        k = h @ p["wk"].to(cd)
        v = h @ p["wv"].to(cd)
        if cfg.qkv_bias:
            q = q + p["bq"].to(cd)
            k = k + p["bk"].to(cd)
            v = v + p["bv"].to(cd)
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, KV, hd)
        v = v.reshape(B, S, KV, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        if kv is None:
            o = L.blockwise_attention(q, k, v, causal=True)
            new_kv = (k, v)
        else:
            k_cache, v_cache = kv
            k_cache[:, cache_len:cache_len + S] = k.to(k_cache.dtype)
            v_cache[:, cache_len:cache_len + S] = v.to(v_cache.dtype)
            o = L.decode_attention(
                q, k_cache.to(cd), v_cache.to(cd),
                cache_len=torch.full((B,), cache_len + 1, dtype=torch.int32,
                                     device=x.device))
            new_kv = (k_cache, v_cache)
        o = o.reshape(B, S, H * hd) @ p["wo"].to(cd)
        return x + o, new_kv

    def _mlp(self, p: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        cd = self.compute_dtype
        B, S, d = x.shape
        h = L.rms_norm(x, p["ln2"].to(cd), cfg.rms_eps)
        if cfg.moe is None:
            y = L.swiglu(h, p["wg"], p["wu"], p["wd"])
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            T = B * S
            n_groups = max(1, T // self.moe_group_size)
            y2d, aux = moe_block(h.reshape(T, d), p["moe"], cfg.moe,
                                 n_groups)
            y = y2d.reshape(B, S, d)
            if cfg.moe.n_shared_experts:
                y = y + L.swiglu(h, p["sg"], p["su"], p["sd"])
        return x + y, aux

    def _layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, _ = self._attn(p, x, positions)
        return self._mlp(p, x)

    # -- forward ---------------------------------------------------------------

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"].to(self.compute_dtype)[tokens.long()]

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device)[None] \
                .expand(B, S)
        if cfg.remat not in ("full", "dots", "none"):
            raise ValueError(f"TransformerLM: unknown remat {cfg.remat!r}")
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        kw = {"context_fn": _DOTS_CONTEXTS} if cfg.remat == "dots" else {}
        x = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for lp in params["layers"]:
            if remat:
                x, a = checkpoint(self._layer, lp, x, positions,
                                  use_reentrant=False, **kw)
            else:
                x, a = self._layer(lp, x, positions)
            aux = aux + a
        x = L.rms_norm(x, params["ln_f"].to(self.compute_dtype), cfg.rms_eps)
        return x, aux

    def _head_w(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self._head_w(params).to(hidden.dtype)

    def loss(self, params: Params, tokens: torch.Tensor,
             labels: torch.Tensor, aux_coef: float = 0.01) -> torch.Tensor:
        """Mean next-token cross entropy over the labels ≥ 0 (chunks of 512
        positions) + ``aux_coef`` · the MoE aux loss / n_layers."""
        hidden, aux = self.forward(params, tokens)
        w = self._head_w(params)
        xent = L.softmax_xent_chunked(lambda xc: xc @ w.to(xc.dtype),
                                      hidden, labels)
        return xent + aux_coef * aux / max(self.cfg.n_layers, 1)

    # -- serving ----------------------------------------------------------------

    def prefill(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
        """Full-sequence forward returning last-position logits + KV cache.

        Cache layout: (L, B, S, KV, hd) ×2, bf16.
        """
        cfg = self.cfg
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = self._embed(params, tokens)
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        ks = torch.empty(shape, dtype=torch.bfloat16, device=tokens.device)
        vs = torch.empty(shape, dtype=torch.bfloat16, device=tokens.device)
        for i, lp in enumerate(params["layers"]):
            x, (k, v) = self._attn(lp, x, positions)
            x, _ = self._mlp(lp, x)
            ks[i] = k.to(torch.bfloat16)
            vs[i] = v.to(torch.bfloat16)
        x = L.rms_norm(x, params["ln_f"].to(self.compute_dtype), cfg.rms_eps)
        return self.logits(params, x[:, -1:]), (ks, vs)

    def decode_step(self, params: Params, token: torch.Tensor, cache: Cache,
                    cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """One-token decode. token: (B, 1); cache: (L, B, S, KV, hd) ×2,
        written in place at position ``cache_len``."""
        cfg = self.cfg
        B = token.shape[0]
        cache_len = int(cache_len)
        positions = torch.full((B, 1), cache_len, device=token.device)
        x = self._embed(params, token)
        ks, vs = cache
        for i, lp in enumerate(params["layers"]):
            x, _ = self._attn(lp, x, positions, kv=(ks[i], vs[i]),
                              cache_len=cache_len)
            x, _ = self._mlp(lp, x)
        x = L.rms_norm(x, params["ln_f"].to(self.compute_dtype), cfg.rms_eps)
        return self.logits(params, x), (ks, vs)

    def make_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda") -> Cache:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def params_from_jax(cfg: TransformerConfig, tree: Params, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX package's ``TransformerLM.init`` tree (leaves as numpy
    arrays) as this port's parameters: the leading layer axis of
    ``tree["layers"]`` unstacked into one dictionary per layer, every
    tensor cast to ``dtype`` (default: the compute dtype, for serving;
    ``torch.float32`` for training's masters) and placed on ``device``."""
    cd = dtype
    if cd is None:
        cd = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        return _to_tensor(node).to(device=device, dtype=cd)

    out = {key: conv(val) for key, val in tree.items() if key != "layers"}
    stacked = tree["layers"]

    def layer(node, i):
        if isinstance(node, dict):
            return {key: layer(val, i) for key, val in node.items()}
        return np.asarray(node)[i]

    layers: List[Params] = [conv(layer(stacked, i))
                            for i in range(cfg.n_layers)]
    out["layers"] = layers
    return out


def train_state_from_jax(cfg: TransformerConfig, tree, device="cuda"):
    """The JAX package's LM ``TrainState(params, AdamWState(step, m, v))``
    (leaves as numpy arrays, layers stacked) as this port's train state:
    params, m and v unstacked per layer in f32 on ``device``, step an int32
    scalar tensor there."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.state import TrainState
    f32 = torch.float32
    opt = tree.opt
    return TrainState(
        params_from_jax(cfg, tree.params, device, dtype=f32),
        AdamWState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                                device=device),
                   params_from_jax(cfg, opt.m, device, dtype=f32),
                   params_from_jax(cfg, opt.v, device, dtype=f32)))


def train_state_to_jax(state):
    """This port's train state in the JAX package's layout: the same
    ``TrainState(params, AdamWState(step, m, v))`` with numpy leaves and
    each ``layers`` list stacked on a leading axis (the layout of the
    reference's checkpoints)."""
    from repro_torch.train.state import stack_layers
    return stack_layers(state)
