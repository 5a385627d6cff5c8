#!/usr/bin/env python3
"""chip_smoke.py's serve-sharded-lm phase alone, on one CUDA card.

Run from the root of a checkout:

    python3 tools/serve_sharded_lm.py [--profile] [--out FILE]

It builds the port's kernels from the checkout
(``repro_torch.kernels.build``), runs
``chip_smoke.phase_serve_sharded_lm`` with every check that phase makes
(a failed check exits non-zero), prints the card's name and power limit
and, last, the phase's record as one JSON line, also written to ``--out``.
With ``--profile``, decode step 1 of each case's first mesh run is
recorded under ``torch.profiler``: device time by op, the device's busy
share of the step's wall time, and the device and host time under each
collective's profiler range (``distrib.collectives.SPANS``), kept in each
case's ``decode_profile``. A profiled step is slower than an unprofiled
one, so its case's decode ms/step is not comparable with a run without
``--profile``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile decode step 1 of each case")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the record here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_sharded_lm: this needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.measure import card_line
    build.build()
    launches, res = chip_smoke.phase_serve_sharded_lm(profile=args.profile)
    res["launches"] = launches
    res["card"] = card_line()
    line = json.dumps(res, default=str)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(f"card: {res['card']}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
