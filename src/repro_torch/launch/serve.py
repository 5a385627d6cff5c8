"""Batched LM serving driver: prefill + greedy decode with a KV cache (the
LM branch of the JAX package's ``repro.launch.serve``), on the reduced
config of the arch, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --tokens 16

The BST and IGPM branches of the reference CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.config.registry import get_arch, list_archs
from repro_torch.models.transformer import Cache, Params, TransformerLM

PROMPT_LEN = 12


@dataclass
class Generation:
    tokens: torch.Tensor      # (B, tokens_out) greedy continuation, int32
    logits: torch.Tensor      # (B, 1, V) logits of the last step
    cache: Cache              # (L, B, prompt + tokens_out, KV, hd) ×2, bf16
    prefill_s: float          # prefill + cache pad, wall clock
    decode_s: float           # the tokens_out - 1 decode steps, wall clock


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(model: TransformerLM, params: Params,
                    prompt: torch.Tensor, tokens_out: int) -> Generation:
    """Prefill ``prompt`` (B, P), pad the cache to P + tokens_out, then
    decode greedily: the first token comes from the prefill logits, each of
    the other ``tokens_out - 1`` from one decode step."""
    B, P = prompt.shape
    t0 = time.perf_counter()
    logits, (ks, vs) = model.prefill(params, prompt)
    pad = tokens_out
    ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
    vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
    _sync(prompt.device)
    prefill_s = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(tokens_out - 1):
        logits, (ks, vs) = model.decode_step(params, tok, (ks, vs), P + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    _sync(prompt.device)
    decode_s = time.perf_counter() - t0
    return Generation(torch.cat(out, dim=1), logits, (ks, vs), prefill_s,
                      decode_s)


def serve_lm(arch, tokens_out: int, batch: int = 2,
             device="cuda") -> Generation:
    cfg = arch.model
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (batch, PROMPT_LEN),
                           generator=torch.Generator(device=device)
                           .manual_seed(1), device=device)
    gen = greedy_generate(model, params, prompt, tokens_out)
    print(f"[serve] prefill {tuple(prompt.shape)} in {gen.prefill_s:.2f}s")
    print(f"[serve] decoded {tokens_out} tokens/seq × {batch} seqs "
          f"in {gen.decode_s:.2f}s "
          f"({tokens_out * batch / max(gen.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] greedy continuation (row 0): "
          f"{gen.tokens[0, :16].cpu().numpy()}")
    return gen


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch, smoke=True)
    if arch.family != "lm":
        raise SystemExit(f"{args.arch} ({arch.family}): only the LM serve "
                         f"path is ported (see ROADMAP.md)")
    serve_lm(arch, args.tokens, device=args.device)


if __name__ == "__main__":
    main()
