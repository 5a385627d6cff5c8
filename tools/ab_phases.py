#!/usr/bin/env python3
"""Times chip_smoke.py's LM mesh phases of two checkouts in turn on one
CUDA card, to compare a change with its parent on the same card.

Run from anywhere, with two checkouts of the repository:

    python3 tools/ab_phases.py A_DIR B_DIR [--rounds 2] [--profile] \
        [--phases serve-sharded-lm,train-sharded-tp2d] [--out DIR]

Round r runs A then B when r is even and B then A when it is odd, so two
rounds run A, B, B, A. Each run is a fresh process in its checkout: it
builds that checkout's kernels (``repro_torch.kernels.build``) and runs
its ``chip_smoke`` phases named by ``--phases`` (``serve-sharded-lm``;
``train-sharded-tp2d``, after ``phase_train_smollm``, whose run it
needs; ``train-sharded``, after ``phase_train_lm``; ``train-sharded-bst``)
with every check they make (a failed check fails the run), the output
kept in ``DIR/<A|B>_<n>.log``. The summary, printed last as one JSON line
and written to ``DIR/summary.json``, holds the card's name and power
limit and per run what the phases print: each serve-sharded-lm case's
decode ms/step and prefill s of its first and second mesh run and of one
card ((vi): its one mesh run's prefill and one card's), each
train-sharded-tp2d case's warm step s and one card's, each
train-sharded case's step s by step, train-sharded-bst's step s at one
microbatch and at two, and with ``--profile`` (the phases' own, which
profiles one step a case in its first mesh run) the host and device ms
under each of the lookup's ranges (``emb_*``) in each profiled step.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

CHILD = r'''
import sys
sys.path[:0] = ["src", "."]
import chip_smoke as cs
from repro_torch.kernels import build
profile = sys.argv[1] == "1"
phases = sys.argv[2].split(",")
build.build()
if "serve-sharded-lm" in phases:
    cs.say("phase serve-sharded-lm:")
    cs.phase_serve_sharded_lm(profile)
if "train-sharded" in phases:
    cs.say("phase train-lm:")
    _, train = cs.phase_train_lm()
    cs.say("phase train-sharded:")
    cs.phase_train_sharded(train, profile)
if "train-sharded-tp2d" in phases:
    cs.say("phase train-smollm:")
    _, smol = cs.phase_train_smollm()
    cs.say("phase train-sharded-tp2d:")
    cs.phase_train_sharded_tp2d(smol, profile)
if "train-sharded-bst" in phases:
    cs.say("phase train-sharded-bst:")
    cs.phase_train_sharded_bst(profile)
'''
PHASES = ("serve-sharded-lm", "train-sharded", "train-sharded-tp2d",
          "train-sharded-bst")

DECODE = re.compile(r"serve-sharded-lm \((\w+)\) .* decode ([\d.]+) ms/step "
                    r"\(again ([\d.]+); one card ([\d.]+)\)")
PREFILL = re.compile(r"serve-sharded-lm \((\w+)\) .*: prefill ([\d.]+) s "
                     r"\(again ([\d.]+); one card ([\d.]+) s\)")
FAULT7 = re.compile(r"serve-sharded-lm \(vi\) fault 7, .* prefill fsdp on "
                    r".*: ([\d.]+) s \(one card ([\d.]+) s\)")
TRAIN = re.compile(r"train-sharded-tp2d \((\w+)\): \(loss, grad_norm\).* "
                   r"warm step ([\d.]+) s .* against one card's ([\d.]+) s")
SHARDED = re.compile(r"train-sharded (\([^)]*\)(?: [\w ]+?)?) step (\d+) "
                     r"on \(([\d, ]+)\): .* step ([\d.]+) s")
BST = re.compile(r"train-sharded-bst step (\d+) on 2 x 2 .* step ([\d.]+) s")
BST_M1 = re.compile(r"train-sharded-bst: the cell's step at 1 microbatch "
                    r".* steps \[([\d., e-]+)\] s")
RANGES = re.compile(r"profile (.+?): (host|device) time under each range: "
                    r"(.*)")
LOOKUP = re.compile(r"(emb_\w+) ([\d.]+) ms")


def read(log: str) -> dict:
    """The timings the phases print, by case."""
    out = {"decode_ms": {}, "prefill_s": {}, "train_s": {},
           "lookup_ms": {}, "sharded_s": {}, "bst_s": {}}
    for m in PREFILL.finditer(log):
        out["prefill_s"][m.group(1)] = {"first": float(m.group(2)),
                                        "again": float(m.group(3)),
                                        "one_card": float(m.group(4))}
    for m in FAULT7.finditer(log):
        out["prefill_s"]["vi"] = {"first": float(m.group(1)),
                                  "one_card": float(m.group(2))}
    for m in SHARDED.finditer(log):
        key = f"{m.group(1)} {m.group(3).replace(' ', '')}"
        out["sharded_s"].setdefault(key, []).append(float(m.group(4)))
    for m in BST.finditer(log):
        out["bst_s"].setdefault("M2", []).append(float(m.group(2)))
    for m in BST_M1.finditer(log):
        out["bst_s"]["M1"] = [float(x) for x in m.group(1).split(",")]
    for m in DECODE.finditer(log):
        out["decode_ms"][m.group(1)] = {"first": float(m.group(2)),
                                        "again": float(m.group(3)),
                                        "one_card": float(m.group(4))}
    for m in TRAIN.finditer(log):
        out["train_s"][m.group(1)] = {"warm": float(m.group(2)),
                                      "one_card": float(m.group(3))}
    for m in RANGES.finditer(log):
        ms = {k: float(v) for k, v in LOOKUP.findall(m.group(3))}
        out["lookup_ms"].setdefault(m.group(1), {})[m.group(2)] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path, help="checkout A (the parent)")
    ap.add_argument("b", type=Path, help="checkout B (the change)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/ab"))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds allowed to one run")
    ap.add_argument("--phases", default="serve-sharded-lm,"
                    "train-sharded-tp2d",
                    help="comma-separated, of " + ", ".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="run the phases with their --profile: a profiled "
                         "step's time is not comparable with one without")
    args = ap.parse_args(argv)
    unknown = set(args.phases.split(",")) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from repro_torch.kernels.measure import card_line
    args.out.mkdir(parents=True, exist_ok=True)
    runs, rc = [], 0
    for r in range(args.rounds):
        for label in ("AB" if r % 2 == 0 else "BA"):
            root = (args.a if label == "A" else args.b).resolve()
            n = sum(1 for x in runs if x["checkout"] == label)
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-c", CHILD,
                                  "1" if args.profile else "0",
                                  args.phases], cwd=root,
                                 capture_output=True, text=True,
                                 timeout=args.timeout)
            log = res.stdout + res.stderr
            (args.out / f"{label}_{n}.log").write_text(log)
            run = {"checkout": label, "order": len(runs),
                   "rc": res.returncode, "wall_s": time.perf_counter() - t0,
                   **read(res.stdout)}
            runs.append(run)
            print(f"{label} run {n}: rc {res.returncode}, "
                  f"{run['wall_s']:.1f} s, {json.dumps(run)}", flush=True)
            rc = rc or res.returncode
    summary = {"card": card_line(), "a": str(args.a), "b": str(args.b),
               "runs": runs}
    (args.out / "summary.json").write_text(json.dumps(summary) + "\n")
    print(f"card: {summary['card']}")
    print(json.dumps(summary))
    return rc


if __name__ == "__main__":
    sys.exit(main())
