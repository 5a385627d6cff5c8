#!/usr/bin/env python3
"""The flash backward kernel on real training inputs, on one CUDA card.

Run from the root of a checkout:

    python3 tools/flash_bwd_train_inputs.py

It runs one card's train step (forward and backward) of smollm-135m whole
on one microbatch of train-smollm's batch, and of qwen3-moe-30b-a3b at
train-lm's 2 layers on one microbatch of train-lm's batch, with weights
from seed 0, both as ``chip_smoke.py`` builds them. It keeps the inputs of
every flash backward call, runs each again through
``flash_attention_bwd`` and through SDPA's backward, and holds both
against ``flash_attention_bwd_ref`` by two rules:

* ``chip_smoke.terms_used``: a share LM_KERNEL_RTOL of the magnitude each
  element's rounding error scales with (``chip_smoke.flash_bwd_terms``).
  This is the rule ``chip_smoke.py`` holds the path's captured inputs by.
* ``chip_smoke.grad_allowance_used``: ``flash_bwd_row``'s row rule, a
  share of each element and of its row's RMS. Rows whose exact dq cancels
  miss it.

It prints one line per call, the worst reading of each model, and last a
JSON summary.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def model_calls(cfg, model_kw: dict, batch: int):
    """The inputs of every flash backward call in one card's train step of
    ``cfg`` on the first ``batch`` sequences of the pipeline's batch 0."""
    import torch
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim.adamw import tree_leaves
    import chip_smoke as CS
    calls = []
    orig = flash_ops.flash_attention_bwd

    def spy(*args, **kw):
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                            for a in args), dict(kw)))
        return orig(*args, **kw)

    model = TransformerLM(cfg, **model_kw)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    pipe = TokenPipeline(cfg.vocab_size, 2 * batch, CS.TRAIN_SEQ, seed=0)
    tokens, labels = (torch.as_tensor(a, device="cuda")[:batch]
                      for a in pipe.batch_at(0))
    flash_ops.flash_attention_bwd = spy
    try:
        model.loss(params, tokens, labels).backward()
    finally:
        flash_ops.flash_attention_bwd = orig
    return calls


def hold(tag: str, calls) -> dict:
    """Each call's readings by both rules, the kernel's and SDPA's."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    import chip_smoke as CS
    rows = []
    for n, (args, kw) in enumerate(calls):
        got = flash_ops.flash_attention_bwd(*args, **kw)
        want = flash_attention_bwd_ref(*args, **kw)
        terms = CS.flash_bwd_terms(*args, **kw)
        lib = CS.sdpa_backward(*args[:3], args[4])
        row = dict(
            kernel_terms=[CS.terms_used(g, w, t)
                          for g, w, t in zip(got, want, terms)],
            sdpa_terms=max(CS.terms_used(g, w, t)
                           for g, w, t in zip(lib, want, terms)),
            kernel_row=max(CS.grad_allowance_used(g, w, CS.LM_KERNEL_RTOL)
                           for g, w in zip(got, want)),
            sdpa_row=max(CS.grad_allowance_used(g, w, CS.LM_KERNEL_RTOL)
                         for g, w in zip(lib, want)))
        rows.append(row)
        dq, dk, dv = row["kernel_terms"]
        print(f"{tag} call {n}: term bound kernel {max(dq, dk, dv):.4f} "
              f"(dq {dq:.4f} dk {dk:.4f} dv {dv:.4f}) SDPA "
              f"{row['sdpa_terms']:.4f}; row rule kernel "
              f"{row['kernel_row']:.3f} SDPA {row['sdpa_row']:.3f}",
              flush=True)
        del got, want, terms, lib
        torch.cuda.empty_cache()
    out = dict(calls=len(rows),
               kernel_terms=[min(max(r["kernel_terms"]) for r in rows),
                             max(max(r["kernel_terms"]) for r in rows)],
               sdpa_terms=[min(r["sdpa_terms"] for r in rows),
                           max(r["sdpa_terms"] for r in rows)],
               kernel_row=[min(r["kernel_row"] for r in rows),
                           max(r["kernel_row"] for r in rows)],
               sdpa_row=[min(r["sdpa_row"] for r in rows),
                         max(r["sdpa_row"] for r in rows)])
    print(f"{tag}: {out}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_train_inputs: needs a CUDA card")
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL as QWEN
    from repro_torch.configs.smollm_135m import FULL as SMOL
    from repro_torch.kernels import build
    from repro_torch.kernels.measure import card_line
    print(f"card: {card_line()}", flush=True)
    build.build()
    summary = {}
    for tag, cfg, kw, batch in (
            ("smollm-135m", SMOL, {}, CS.SMOL_BATCH // CS.SMOL_MICRO),
            ("qwen3-moe-30b-a3b", dataclasses.replace(
                QWEN, n_layers=CS.TRAIN_LAYERS),
             dict(moe_group_size=CS.TRAIN_GROUP),
             CS.TRAIN_BATCH // CS.TRAIN_MICRO)):
        summary[tag] = hold(tag, model_calls(cfg, kw, batch))
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
