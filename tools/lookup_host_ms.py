#!/usr/bin/env python3
"""Times the ``tp2d`` table's lookup alone on one CUDA card, in one or
more checkouts in turn, to compare its cost across versions.

Run from anywhere, with checkouts of the repository:

    python3 tools/lookup_host_ms.py DIR [DIR ...] [--rounds 2] [--reps 20]

Each round runs every checkout once, in the order given when the round is
even and reversed when it is odd, each in a fresh process in its checkout.
There qwen3-moe-30b-a3b's ``embed`` (151,936 × 2,048) is placed as
P("model", "data") on a 2 × 2 ("data", "model") mesh of ``cuda:0`` four
times, as chip_smoke's serve-sharded-lm and train-sharded-tp2d place it,
and each form of the lookup is timed with the card synchronised before
and after the call (host and device time together; the median of
``--reps`` calls after 3 warm-ups), its rows in bf16:

* decode: ``TPView.serving(embed, groups, "decode").take_rows`` of 16
  tokens split over "data" (serve-sharded-lm (ii)'s decode step, the
  table in bf16);
* whole: ``StationaryView.take_rows`` of 2 tokens with the batch whole
  (serve-sharded-lm (i)'s, the table in bf16);
* train: ``TPView(embed, groups).take_rows`` of 2 × 4,096 tokens split
  over "data", and its backward (train-sharded-tp2d (i)'s microbatch, the
  table in f32).

Prints one line a run, the card's name and power limit, and a JSON
summary last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import inspect, json, statistics, sys, time
sys.path[:0] = ["src"]
import torch
from repro_torch.distrib.collectives import (Rows, StationaryView, TPView,
                                             batch_groups)
from repro_torch.distrib.sharding import P, device_put
from repro_torch.launch.mesh import Mesh

reps = int(sys.argv[1])
mesh = Mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
g = torch.Generator(device="cuda").manual_seed(0)
V, d, bf16 = 151936, 2048, torch.bfloat16
_, groups = batch_groups(mesh, "data")
homes_whole, _ = batch_groups(mesh, None)


def take(view, ids):
    # the lookup in bf16 (a version without the dtype argument casts after)
    if "dtype" in inspect.signature(view.take_rows).parameters:
        return view.take_rows(ids, bf16).parts
    return [t.to(bf16) for t in view.take_rows(ids).parts]


def median_ms(fn):
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def split_ids(view, B, S):
    ids = torch.randint(0, V, (B, S), device="cuda", generator=g,
                        dtype=torch.int32)
    return Rows([ids.chunk(2)[view.shard[p]] for p in range(mesh.size)],
                list(range(mesh.size)), mesh)


table = torch.randn((V, d), device="cuda", generator=g)
res = {}
placed = device_put(table.to(bf16), mesh, P("model", "data"))
view = TPView.serving(placed, groups, "decode")
ids = split_ids(view, 16, 1)
res["decode"] = median_ms(lambda: take(view, ids))
tok = torch.randint(0, V, (2, 1), device="cuda", generator=g,
                    dtype=torch.int32)
if "ids" in inspect.signature(StationaryView).parameters:
    whole = lambda: StationaryView(placed, ids=[tok] * mesh.size)
else:
    whole = lambda: StationaryView(placed)
rows = Rows([tok], homes_whole, mesh)
res["whole"] = median_ms(lambda: take(whole(), rows))
placed = device_put(table, mesh, P("model", "data"))
view = TPView(placed, groups)
ids = split_ids(view, 2, 4096)
seeds = [p for p in range(mesh.size) if view.collects(p)]


def train():
    for leaf in view.leaves:
        leaf.grad = None
    out = [t for p, t in enumerate(take(view, ids))
           if p in seeds and t.requires_grad]
    torch.autograd.backward(out, [torch.ones_like(t) for t in out])


res["train"] = median_ms(train)
print("RESULT " + json.dumps(res))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", type=Path, nargs="+", help="checkouts")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from repro_torch.kernels.measure import card_line
    runs = []
    for r in range(args.rounds):
        for root in (args.roots if r % 2 == 0 else args.roots[::-1]):
            res = subprocess.run([sys.executable, "-c", CHILD,
                                  str(args.reps)], cwd=root.resolve(),
                                 capture_output=True, text=True, timeout=600)
            line = next((ln for ln in res.stdout.splitlines()
                         if ln.startswith("RESULT ")), None)
            if res.returncode or line is None:
                print(res.stdout[-2000:] + res.stderr[-4000:],
                      file=sys.stderr)
                return res.returncode or 1
            run = {"checkout": str(root), "round": r,
                   "ms": json.loads(line[7:])}
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = {"card": card_line(), "runs": runs}
    print(f"card: {summary['card']}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
