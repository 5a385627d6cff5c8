"""Training launcher: ``--arch <id>`` runs the reduced (smoke) config of
an arch's train shape for a few steps, on the card unless ``--device cpu``
is given (the PyTorch port of the JAX package's ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-30b-a3b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dimenet --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch bst --device cpu

Every cell comes from ``repro_torch.launch.cells.build_cell``, as the
reference's launcher builds its smoke cell; the LM's: the shape's reduced
batch and sequence, ``moe_group_size = min(4096, max(64, B·S // 8))``, the default
``TrainConfig()``, f32 master weights drawn from seed 0, and one batch of
tokens and labels drawn with ``numpy.random.default_rng(0)`` as the cell's
argument factory draws them, fed to every step. Every arch with a train
shape trains: the five LMs, schnet, dimenet, meshgraphnet, graphcast and
bst (the GNNs' first train shape is ``full_graph_sm``, BST's
``train_batch``). The reference's ``--dry-run`` lowering against the
production mesh is ``python -m repro_torch.launch.dryrun`` here, which runs
every cell — the GNNs' edge-sharded step and BST's row-sharded table
included — on a meta production mesh.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config.base import LM_SHAPES, ArchConfig
from repro_torch.config.registry import get_arch
from repro_torch.launch.cells import build_cell


def lm_train_cell(cfg, shape: str, device):
    """(model, state, tokens, labels) of the reduced LM train cell
    (``launch.cells.build_cell`` on an arch of ``cfg``)."""
    arch = ArchConfig("lm", "lm", cfg, LM_SHAPES)
    cell = build_cell(arch, shape, device, smoke=True)
    return (cell.model, *cell.args)


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
    if arch.family not in ("lm", "gnn", "recsys"):
        raise SystemExit(f"{args.arch} is a {arch.family} arch: it has no "
                         f"train shape")
    shape = args.shape or next(s.name for s in arch.shapes
                               if s.kind == "train")
    kind = {s.name: s.kind for s in arch.shapes}.get(shape)
    if kind != "train":
        raise SystemExit(f"shape {shape} is {kind}, not train")
    device = torch.device(args.device)
    cell = build_cell(arch, shape, device, smoke=True)
    step = cell.step_fn
    state, *batch = cell.args
    print(f"[train] {args.arch}/{shape} (reduced config) — {args.steps} "
          f"steps on {device}")
    t0 = time.time()
    m = None
    for i in range(args.steps):
        state, m = step(state, *batch)
        if i % args.log_every == 0:
            print(f"  step {i:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}")
    if m is not None:
        print(f"[train] done in {time.time()-t0:.1f}s; "
              f"final loss {float(m['loss']):.4f}")


if __name__ == "__main__":
    main()
