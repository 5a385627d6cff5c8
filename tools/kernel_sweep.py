#!/usr/bin/env python3
"""Tuning sweeps of the port's kernels on one CUDA card.

Run from the root of a checkout:

    python3 tools/kernel_sweep.py reach   # ell_reach: U, min blocks per width
    python3 tools/kernel_sweep.py gemm    # expert GEMM: tiles, skinny threshold
    python3 tools/kernel_sweep.py gemm-bwd  # its dW: tile width, epilogue
    python3 tools/kernel_sweep.py all

Each sweep compiles its kernel source once more with a ``-D<NAME>_SWEEP``
define, which adds tuning entry points (``ell_reach_sweep``,
``expert_gemm_sweep``, ``expert_gemm_dw_sweep``) beside the production
one, into
``src/repro_torch/kernels/build/sweep`` (git-ignored). Every setting is
checked against the plain version before it is timed (reach bitwise, the
GEMM to rtol/atol 2e-2), and times are medians of CUDA-event launches with
the card spun before each (``repro_torch.kernels.measure.cuda_ms``, as in
``chip_smoke.py``). It prints one line per setting and, last, a JSON
summary of them all.

The reach sweep runs the synthetic full-mirror tile of chip_smoke.py
(``measure.random_ell``: n 262,144, R 393,216, K 64) at d 40, 160 and
320, and the BFS inputs that two steps of serve-batch (``Engine(FULL, mode="batch")`` on the ``transactions`` twin)
hand the kernel, one per width. The GEMM sweep times the tiles variant at
BN 128, 192 and 256 (2 to 6 stages) on the serve-lm prefill products, and
the skinny variant against the tiles variant at C 8 to 64 on the decode
products: each variant timed ``SKINNY_ROUNDS`` times, alternating, so
the gap between them can be set against the run-to-run spread. The
GEMM backward sweep times dW at the train-lm shapes (G 4, C 88, gate and
down) at the ``GEMM_DW`` settings (tile width, ring depth, rows of C per
k-step, TMA store or 16-byte stores), alternating for ``SKINNY_ROUNDS``
rounds, beside dX and cuBLAS (``torch.bmm``) on the same products.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS = 20
REACH_U = (1, 2, 4, 8)
REACH_MINB = (2, 3, 4, 6)
# (BN, STAGES) of the tiles variant
GEMM_TILES = ((128, 4), (128, 6), (192, 3), (192, 4), (256, 2), (256, 3))
GEMM_SKINNY_C = (8, 16, 32, 64)
SKINNY_ROUNDS = 3
# (BN, STAGES, KS, TMA store) of the dW kernel: output tile width, ring
# depth, rows of C per k-step, and its TMA-store epilogue (1) or the tiles
# variant's 16-byte stores (0); csrc/expert_gemm_wgmma.cu: gemm_dw
GEMM_DW = ((192, 4, 64, 1), (192, 2, 96, 1), (256, 3, 64, 1),
           (128, 3, 128, 1), (128, 4, 96, 1), (128, 4, 96, 0),
           (64, 5, 96, 1))
# serve-lm's prompt batch (chip_smoke.py: LM_BATCH, LM_PROMPT), the
# serve-batch steps captured (chip_smoke.py: BATCH_STEPS) and train-lm's
# sequence and MoE group (chip_smoke.py: TRAIN_SEQ, TRAIN_GROUP)
LM_BATCH, LM_PROMPT = 2, 4096
BATCH_STEPS = 2
TRAIN_SEQ, TRAIN_GROUP = 4096, 1024

_P, _I = ctypes.c_void_p, ctypes.c_int


def say(*parts) -> None:
    print(*parts, flush=True)


_SWEEP_LIBS = {}  # kernel name → its sweep library, compiled once a run


def build_sweep(name: str, define: str, fn_name: str, argtypes):
    """Compile kernel ``name``'s source with ``-D<define>`` (once a run)
    and return its tuning entry point ``fn_name``."""
    from repro_torch.kernels import build
    if name not in _SWEEP_LIBS:
        out = build.build_dir() / "sweep"
        out.mkdir(parents=True, exist_ok=True)
        lib_path = out / f"lib{name}_sweep.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I",
               str(build.INCLUDE_DIR), f"-D{define}", "-o", str(lib_path),
               str(build.build_dir().parent / build.KERNELS[name][0])]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                               f"{res.stderr}")
        _SWEEP_LIBS[name] = ctypes.CDLL(str(lib_path))
    fn = getattr(_SWEEP_LIBS[name], fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


# -- ell_reach -----------------------------------------------------------------

def served_bfs_inputs():
    """The first ell_reach input of every width that two serve-batch steps
    hand the kernel, copied."""
    from repro_torch.config.base import EngineConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.data.temporal import generate_stream, scaled_twin
    from repro_torch.engine import Engine
    from repro_torch.kernels.spmv_ell import ops
    stream = generate_stream(scaled_twin("transactions", 1.0),
                             n_max=FULL.n_max, e_max=FULL.e_max,
                             n_measured_steps=BATCH_STEPS, u_max=512,
                             device="cuda")
    eng = Engine(FULL, EngineConfig(mode="batch"), device="cuda")
    for q in query_zoo(16):
        eng.register(q)
    state = eng.init_state(stream.graph)
    seen = {}
    reach = ops.ell_reach

    def spy(cols, mask, row_ids, x, n, index=None):
        if x.shape[1] not in seen:
            seen[x.shape[1]] = tuple(t.clone() for t in
                                     (cols, mask, row_ids, x)) + (n,)
        return reach(cols, mask, row_ids, x, n, index=index)

    ops.ell_reach = spy
    try:
        for upd in stream.updates[:BATCH_STEPS]:
            state, _ = eng.step(state, upd)
    finally:
        ops.ell_reach = reach
    return seen


def sweep_reach():
    import torch
    from repro_torch.kernels.measure import cuda_ms, gather_floor, random_ell
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    fn = build_sweep("ell_reach", "ELL_REACH_SWEEP", "ell_reach_sweep",
                     [_P] * 6 + [_I] * 5 + [_P])
    cases = []
    n, k, r_cap = 262_144, 64, 393_216
    cols, _, mask, row_ids = random_ell(n, r_cap, k, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for d in (40, 160, 320):
        x = (torch.rand((n, d), device="cuda", generator=gen)
             < 0.1).to(torch.float32)
        cases.append((f"synthetic d={d}", cols, mask, row_ids, x, n))
    for d, (c, m, r, x, nn) in sorted(served_bfs_inputs().items()):
        if d >= 32:
            cases.append((f"serve-batch bfs d={d}", c, m, r, x, nn))
    out = []
    for label, cols, mask, row_ids, x, n in cases:
        perm, row_ptr = build_row_index(mask, row_ids, n)
        d = x.shape[1]
        want = ref.ell_reach_ref(cols, mask, row_ids, x, n)
        y = torch.empty((n, d), dtype=torch.float32, device="cuda")

        def run(u, minb):
            rc = fn(cols.data_ptr(), mask.data_ptr(), perm.data_ptr(),
                    row_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), n, d,
                    cols.shape[1], u, minb, stream_ptr())
            if rc != 0:
                raise RuntimeError(f"ell_reach_sweep rc {rc}")

        prod = cuda_ms(lambda: ops.ell_reach(cols, mask, row_ids, x, n,
                                             index=(perm, row_ptr)), REPS)
        nnz = int(mask.sum())
        say(f"reach {label}: n={n} nnz={nnz} production {prod:.4f} ms, "
            f"gather floor {gather_floor(mask, d):.4f} ms")
        times = {}
        for u, minb in itertools.product(REACH_U, REACH_MINB):
            y.fill_(-1.0)
            run(u, minb)
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise RuntimeError(f"reach {label} U={u} MINB={minb}: not "
                                   f"bitwise equal to the plain version")
            times[(u, minb)] = cuda_ms(lambda: run(u, minb), REPS)
            say(f"  U={u} MINB={minb}: {times[(u, minb)]:.4f} ms")
        best = min(times, key=times.get)
        say(f"  best U={best[0]} MINB={best[1]} {times[best]:.4f} ms")
        out.append(dict(case=label, n=n, d=d, nnz=nnz, production_ms=prod,
                        gather_floor_ms=gather_floor(mask, d),
                        best=dict(u=best[0], minb=best[1], ms=times[best]),
                        ms={f"U{u}_MINB{m}": t
                            for (u, m), t in times.items()}))
        del want, y
        torch.cuda.empty_cache()
    return out


# -- expert GEMM ---------------------------------------------------------------

def sweep_gemm():
    import torch
    from repro_torch.kernels.measure import cuda_ms
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.kernels import build
    from repro_torch.kernels.expert_gemm import ops
    from repro_torch.kernels.expert_gemm.ref import expert_gemm_ref
    from repro_torch.models.moe import moe_capacity
    fn = build_sweep("expert_gemm_wgmma", "EXPERT_GEMM_SWEEP",
                     "expert_gemm_sweep", [_P] * 3 + [_I] * 7 + [_P])
    wgmma = build.kernel(ops.TILES)
    moe = FULL.moe
    E, dm, ff = moe.n_experts, FULL.d_model, moe.d_ff_expert
    c_pre = moe_capacity(LM_PROMPT, E, moe.top_k)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    def close(y, x, w):
        want = expert_gemm_ref(x, w).float()
        return bool(((y.float() - want).abs()
                     <= 2e-2 + 2e-2 * want.abs()).all())

    out = []
    s_in = (2.0 / (dm + ff)) ** 0.5
    for label, depth, width in (("gate", dm, ff), ("down", ff, dm)):
        w = randn(E, depth, width, scale=s_in)
        x = randn(LM_BATCH * E, c_pre, depth)
        y = torch.empty((LM_BATCH * E, c_pre, width), dtype=torch.bfloat16,
                        device="cuda")
        flops = 2 * LM_BATCH * E * c_pre * depth * width
        for bn, stages in GEMM_TILES:
            def run():
                rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0],
                        E, c_pre, depth, width, bn, stages, stream_ptr())
                if rc != 0:
                    raise RuntimeError(f"expert_gemm_sweep rc {rc}")
            y.zero_()
            run()
            ok = close(y, x, w)
            again = y.clone()
            run()
            ok = ok and bool(torch.equal(y, again))
            ms = cuda_ms(run, REPS)
            say(f"gemm prefill {label} x {tuple(x.shape)} w {tuple(w.shape)}"
                f" tiles BN={bn} STAGES={stages}: {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s) ok={ok}")
            out.append(dict(case=f"prefill {label}",
                            variant=f"tiles BN={bn} STAGES={stages}", ms=ms,
                            ok=ok))
        lib = cuda_ms(lambda: torch.matmul(x.view(LM_BATCH, E, c_pre, depth),
                                           w), REPS)
        say(f"gemm prefill {label}: torch.matmul {lib:.4f} ms")
        out.append(dict(case=f"prefill {label}", variant="torch.matmul",
                        ms=lib, ok=True))
        del x, y
        for C in GEMM_SKINNY_C:
            x = randn(E, C, depth)
            y = torch.empty((E, C, width), dtype=torch.bfloat16,
                            device="cuda")
            runs = {}
            for variant, code in (("skinny", 1), ("tiles", 0)):
                def run(code=code):
                    rc = wgmma(x.data_ptr(), w.data_ptr(), y.data_ptr(), E, E,
                               C, depth, width, code, stream_ptr())
                    if rc != 0:
                        raise RuntimeError(f"expert_gemm_wgmma rc {rc}")
                y.zero_()
                run()
                runs[variant] = (run, close(y, x, w))
            times = {v: [] for v in runs}
            for _ in range(SKINNY_ROUNDS):
                for variant, (run, _ok) in runs.items():
                    times[variant].append(cuda_ms(run, REPS))
            for variant, (_run, ok) in runs.items():
                ts = times[variant]
                say(f"gemm {label} C={C} {variant}: median of medians "
                    f"{sorted(ts)[len(ts) // 2]:.4f} ms, rounds "
                    f"{', '.join(f'{t:.4f}' for t in ts)} ok={ok}")
                out.append(dict(case=f"{label} C={C}", variant=variant,
                                ms=sorted(ts)[len(ts) // 2], rounds=ts,
                                ok=ok))
            lib = cuda_ms(lambda: torch.matmul(x, w), REPS)
            say(f"gemm {label} C={C} torch.matmul: {lib:.4f} ms")
            out.append(dict(case=f"{label} C={C}", variant="torch.matmul",
                            ms=lib, ok=True))
            del x, y
        del w
        torch.cuda.empty_cache()
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise RuntimeError(f"gemm sweep: outputs off the plain version: {bad}")
    return out


def sweep_gemm_bwd():
    import torch
    from repro_torch.configs.qwen3_moe_30b_a3b import FULL
    from repro_torch.kernels.expert_gemm import ops
    from repro_torch.kernels.expert_gemm.ref import expert_gemm_dw_ref
    from repro_torch.kernels.measure import cuda_ms
    from repro_torch.models.moe import moe_capacity
    fn = build_sweep("expert_gemm_wgmma", "EXPERT_GEMM_SWEEP",
                     "expert_gemm_dw_sweep", [_P] * 3 + [_I] * 9 + [_P])
    moe = FULL.moe
    E, dm, ff = moe.n_experts, FULL.d_model, moe.d_ff_expert
    G = TRAIN_SEQ // TRAIN_GROUP
    C = moe_capacity(TRAIN_GROUP, E, moe.top_k)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    out = []
    s_in = (2.0 / (dm + ff)) ** 0.5
    for label, din, dout in (("gate", dm, ff), ("down", ff, dm)):
        x, w = randn(G * E, C, din), randn(E, din, dout, scale=s_in)
        dy = randn(G * E, C, dout, scale=(G * C) ** -0.5)
        dw = torch.empty((E, din, dout), dtype=torch.bfloat16, device="cuda")
        want = expert_gemm_dw_ref(x, dy, E).float()
        atol = 2e-2 * float(want.pow(2).mean().sqrt())
        runs = {}
        for setting in GEMM_DW:
            def run(setting=setting):
                rc = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), G * E, E,
                        C, din, dout, *setting, stream_ptr())
                if rc != 0:
                    raise RuntimeError(f"expert_gemm_dw_sweep rc {rc}")
            dw.zero_()
            run()
            ok = bool(((dw.float() - want).abs()
                       <= atol + 2e-2 * want.abs()).all())
            again = dw.clone()
            run()
            ok = ok and bool(torch.equal(dw, again))
            runs[setting] = (run, ok)
        times = {k: [] for k in runs}
        for _ in range(SKINNY_ROUNDS):
            for k, (run, _ok) in runs.items():
                times[k].append(cuda_ms(run, REPS))
        for (bn, stages, ks, store), (_run, ok) in runs.items():
            ts = times[(bn, stages, ks, store)]
            med = sorted(ts)[len(ts) // 2]
            variant = (f"dW BN={bn} STAGES={stages} KS={ks} "
                       f"{'TMA store' if store else '16-byte stores'}")
            say(f"gemm-bwd train {label} {variant}: median of medians "
                f"{med:.4f} ms, rounds {', '.join(f'{t:.4f}' for t in ts)}"
                f" ok={ok}")
            out.append(dict(case=f"train {label} dW", variant=variant,
                            ms=med, rounds=ts, ok=ok))
        xt = x.view(G, E, C, din).permute(1, 3, 0, 2).reshape(E, din, G * C)
        dyt = dy.view(G, E, C, dout).transpose(0, 1).reshape(E, G * C, dout)
        for case, variant, run in (
                ("dW", "torch.bmm on the copies", lambda: torch.bmm(xt, dyt)),
                ("dX", "expert_gemm_dx", lambda: ops.expert_gemm_dx(dy, w)),
                ("dX", "torch.bmm, W as op T",
                 lambda: torch.bmm(dyt, w.mT))):
            ms = cuda_ms(run, REPS)
            say(f"gemm-bwd train {label} {case} {variant}: {ms:.4f} ms")
            out.append(dict(case=f"train {label} {case}", variant=variant,
                            ms=ms, ok=True))
        del x, w, dy, dw, want, xt, dyt
        torch.cuda.empty_cache()
    bad = [r for r in out if not r["ok"]]
    if bad:
        raise RuntimeError(f"gemm-bwd sweep: outputs off the plain version: "
                           f"{bad}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", choices=("reach", "gemm", "gemm-bwd", "all"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        say("kernel_sweep: needs a CUDA card")
        return 2
    from repro_torch.kernels.measure import card_line
    card = card_line()
    say(f"card: {card}")
    summary = {"card": card}
    if args.which in ("gemm", "all"):
        summary["gemm"] = sweep_gemm()
    if args.which in ("gemm-bwd", "all"):
        summary["gemm_bwd"] = sweep_gemm_bwd()
    if args.which in ("reach", "all"):
        summary["reach"] = sweep_reach()
    say(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
