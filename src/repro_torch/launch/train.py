"""Training launcher: ``--arch <id>`` runs the reduced (smoke) config of an
LM arch for a few steps, on the card unless ``--device cpu`` is given (the
LM branch of the JAX package's ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-30b-a3b --steps 20

The train cell is built here as the reference's ``launch/cells.py`` builds
its smoke cell (``_LM_SMOKE_DIMS`` and ``_lm_cell``; ``cells.py`` itself is
a TPU tool that waits for ROADMAP item 13.5): the shape's reduced batch and
sequence, ``moe_group_size = min(4096, max(64, B·S // 8))``, the default
``TrainConfig()``, f32 master weights drawn from seed 0, and one batch of
tokens and labels drawn with ``numpy.random.default_rng(0)`` as the cell's
argument factory draws them, fed to every step. The reference's
``--dry-run`` lowering against the production mesh has no counterpart.
Every LM arch of the registry trains (qwen3-moe-30b-a3b, smollm-135m,
deepseek-7b, qwen2-72b, dbrx-132b); GNN and BST archs wait for ROADMAP
items 13.3 and 13.4.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config.base import TrainConfig
from repro_torch.config.registry import get_arch
from repro_torch.models.transformer import TransformerLM
from repro_torch.train.state import make_train_step, new_train_state

# the reference's launch/cells.py:_LM_SMOKE_DIMS, train shape
LM_SMOKE_TRAIN_DIMS = {"train_4k": {"seq_len": 32, "global_batch": 2}}


def lm_train_cell(cfg, shape: str, device):
    """(model, state, tokens, labels) of the reduced LM train cell."""
    dims = LM_SMOKE_TRAIN_DIMS[shape]
    B, S = dims["global_batch"], dims["seq_len"]
    model = TransformerLM(cfg, moe_group_size=min(4096, max(64, B * S // 8)))
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return (model, new_train_state(params),
            torch.as_tensor(tokens, device=device),
            torch.as_tensor(labels, device=device))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="defaults to the arch's first train shape")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    arch = get_arch(args.arch, smoke=True)
    if arch.family != "lm":
        raise SystemExit(f"{args.arch} is a {arch.family} arch: it has no "
                         f"train shape")
    shape = args.shape or next(s.name for s in arch.shapes
                               if s.kind == "train")
    kind = {s.name: s.kind for s in arch.shapes}.get(shape)
    if kind != "train":
        raise SystemExit(f"shape {shape} is {kind}, not train")
    device = torch.device(args.device)
    model, state, tokens, labels = lm_train_cell(arch.model, shape, device)
    step = make_train_step(model.loss, TrainConfig())
    print(f"[train] {args.arch}/{shape} (reduced config) — {args.steps} "
          f"steps on {device}")
    t0 = time.time()
    m = None
    for i in range(args.steps):
        state, m = step(state, tokens, labels)
        if i % args.log_every == 0:
            print(f"  step {i:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}")
    if m is not None:
        print(f"[train] done in {time.time()-t0:.1f}s; "
              f"final loss {float(m['loss']):.4f}")


if __name__ == "__main__":
    main()
