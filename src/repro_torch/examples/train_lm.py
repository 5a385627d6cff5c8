"""End-to-end training script: decoder-only LM on the synthetic corpus with
the full substrate — AdamW, warmup-cosine, grad clipping, checkpointing +
restart, straggler monitor (PyTorch port of the JAX package's
``examples/train_lm.py``).

Presets:
  tiny (default) : 6L/d192 ≈ 8M params, seq 128
  smollm         : the REAL smollm-135m config (30L/d576/GQA/tied) at
                   short seq — "~100M model for a few hundred steps"

Both train in f32, so on the card attention runs the first flash kernels
(``flash_attention_fwd.cu`` and ``flash_attention_bwd.cu``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
      PYTHONPATH=src python -m repro_torch.examples.train_lm --preset smollm \\
          --steps 200
      (``--device cpu`` for the CPU)
Kill it and re-run: it resumes from the last committed checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.data.lm import TokenPipeline
from repro_torch.models.transformer import TransformerLM
from repro_torch.train.loop import TrainLoop
from repro_torch.train.state import make_train_step, new_train_state


def preset_config(preset: str, batch: int, seq: int):
    """(model config, batch, seq) of a preset, the sizes cut as the
    reference's script cuts them."""
    cfg = get_arch("smollm-135m").model
    if preset == "tiny":
        cfg = dataclasses.replace(cfg, n_layers=6, d_model=192, n_heads=6,
                                  n_kv_heads=2, d_ff=512, vocab_size=4096,
                                  dtype="float32", remat="none")
        seq = min(seq, 128)
    else:
        cfg = dataclasses.replace(cfg, dtype="float32", remat="none")
        seq = min(seq, 64)
        batch = min(batch, 4)
    return cfg, batch, seq


def build(cfg, steps: int, batch: int, seq: int, ckpt_dir: str,
          device="cuda", params=None, learning_rate: float = 3e-3,
          checkpoint_every: int = 50, print_fn=print) -> TrainLoop:
    """The train loop of ``cfg`` on ``device`` over ``steps`` steps of the
    token pipeline (seed 0), restoring the last checkpoint in ``ckpt_dir``
    if there is one. ``params``: the initial weights (default: drawn from
    seed 0)."""
    model = TransformerLM(cfg)
    tcfg = TrainConfig(learning_rate=learning_rate, warmup_steps=20,
                       total_steps=steps, checkpoint_every=checkpoint_every,
                       checkpoint_dir=ckpt_dir)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=0)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0),
                            dtype=torch.float32)
    return TrainLoop(make_train_step(model.loss, tcfg),
                     new_train_state(params), pipe.batch_at, tcfg,
                     log_every=10, print_fn=print_fn)


def run(loop: TrainLoop, steps: int):
    """The loop's steps from where it starts up to ``steps``."""
    return loop.run(n_steps=steps - loop.start_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["tiny", "smollm"], default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, args.batch, args.seq = preset_config(args.preset, args.batch,
                                              args.seq)
    print(f"preset={args.preset}: {cfg.n_layers}L d={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.1f}M")
    loop = build(cfg, args.steps, args.batch, args.seq, args.ckpt_dir,
                 args.device,
                 learning_rate=3e-3 if args.preset == "tiny" else 6e-4)
    metrics = run(loop, args.steps)

    first = metrics.losses[0] if metrics.losses else float("nan")
    last = (sum(metrics.losses[-10:]) / max(len(metrics.losses[-10:]), 1)
            if metrics.losses else float("nan"))
    print(f"\nloss: first={first:.4f} last10={last:.4f} "
          f"(uniform = {math.log(cfg.vocab_size):.2f})")
    print(f"checkpoints in {args.ckpt_dir}: kill + re-run to test restart")
    return metrics


if __name__ == "__main__":
    main()
