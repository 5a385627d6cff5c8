#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (``nvidia-smi``) and the build of both ELL kernels from the
   sources in ``src/repro_torch/kernels/spmv_ell/csrc`` (one ``nvcc`` per
   source, started together);
2. each kernel against its plain PyTorch version on random ELL data at the
   full mirror's shapes (R 393,216 rows, K 64, n 262,144, d ∈ {4, 320},
   with shuffled spill rows, unallocated capacity rows and empty vertices):
   SpMM to max relative error ≤ 1e-5, reach bitwise; median kernel time
   from CUDA events, the plain version's time, ``torch.sparse.mm`` on the
   same matrix as a CSR tensor (a yardstick only — the port never calls
   it), and the byte/flop bound of the work;
3. a small-input check: the toy stream served on the card and on the CPU
   (plain versions) must give equal match deltas and stores;
4. serve-inc — ``MatchServer(FULL, query_zoo(16), ServingConfig(adaptive=
   False))`` on the ``transactions`` twin at full scale for 4 served steps,
   launch counters set to 0 before and read after; the inputs of the first
   label-RWR sweep, the first expansion sweep and the first BFS sweep are
   captured and the kernels held against their plain versions on them;
5. serve-batch — 2 steps of ``Engine(FULL, EngineConfig(mode="batch"))``
   on the same stream (full-graph label RWR and bank match), counters
   again set to 0 before and read after.

Then a ``{"kernels": [...]}`` JSON line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line. ``--profile`` adds a device-time profile of one step of each
served path.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # fp32 outside the tensor cores, data sheet
SPMM_RTOL = 1e-5
REPS = 20          # timed launches per kernel measurement
INC_STEPS = 4      # serve-inc steps
BATCH_STEPS = 2    # serve-batch steps


class SmokeFailure(RuntimeError):
    pass


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each bracketed
    by its own pair of CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 2: kernels against their plain versions -----------------------------

def random_ell(n: int, r_cap: int, k: int, seed: int, device="cuda"):
    """Random incoming-adjacency ELL tile shaped like the full mirror: one
    first row per vertex in vertex order, spill rows for vertices with
    more than ``k`` entries handed out in shuffled order after them,
    unallocated capacity rows (row_id 0, all masked) at the end, ~10 %
    empty vertices; entries packed at the front of each row."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 13, n)
    deg[rng.random(n) < 0.10] = 0
    heavy = rng.random(n) < 0.005
    deg[heavy] = rng.integers(k + 1, 5 * k, int(heavy.sum()))
    rows_per_v = np.maximum(1, -(-deg // k))
    spill_owner = np.repeat(np.arange(n), rows_per_v - 1)
    rng.shuffle(spill_owner)
    n_rows = n + len(spill_owner)
    assert n_rows <= r_cap
    row_ids = np.zeros(r_cap, np.int32)
    row_ids[:n] = np.arange(n)
    row_ids[n:n_rows] = spill_owner
    # the j-th row of vertex v: its first row, then its spill rows in the
    # order the shuffled cursor handed them out
    rows_of = [[v] for v in range(n)]
    for j, v in enumerate(spill_owner):
        rows_of[v].append(n + j)
    fill = np.zeros(r_cap, np.int64)
    for v in np.nonzero(deg > k)[0]:
        left = deg[v]
        for r in rows_of[v]:
            fill[r] = min(k, left)
            left -= fill[r]
    light = deg <= k
    fill[:n][light] = deg[light]
    mask = np.arange(k)[None, :] < fill[:, None]
    cols = rng.integers(0, n, (r_cap, k)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (r_cap, k)).astype(np.float32)
    vals[~mask] = 0.0
    return tuple(torch.as_tensor(a, device=device)
                 for a in (cols, vals, mask, row_ids))


def spmm_bound(mask, x, n: int, with_vals: bool):
    """Least card time for the function on these inputs: each input byte
    it needs read once, each output byte written once — the whole mask,
    the row ids, the column id (and weight) of every live entry, all of
    x — against its flops (2·nnz·d for the SpMM, nnz·d compares for the
    reach) at the fp32 peak."""
    r, k = mask.shape
    nnz = int(mask.sum())
    d = x.shape[1]
    nbytes = (r * k + r * 4 + nnz * (8 if with_vals else 4)
              + x.numel() * 4 + n * d * 4)
    ops = (2 if with_vals else 1) * nnz * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops


def spmm_errors(y, y_ref):
    import torch
    diff = (y - y_ref).abs()
    denom = y_ref.abs()
    rel = torch.where(denom > 0, diff / denom.clamp_min(1e-30),
                      torch.where(diff > 0, torch.full_like(diff, float("inf")),
                                  torch.zeros_like(diff)))
    return float(diff.max()), float(rel.max())


def compare_spmm(ops, ref, cols, vals, mask, row_ids, x, n, index, label):
    y = ops.ell_spmm(cols, vals, mask, row_ids, x, n, index=index)
    y2 = ops.ell_spmm(cols, vals, mask, row_ids, x, n, index=index)
    y_ref = ref.ell_spmm_ref(cols, vals, mask, row_ids, x, n)
    check(bool((y == y2).all()), f"ell_spmm {label}: two launches differ")
    abs_err, rel_err = spmm_errors(y, y_ref)
    say(f"  ell_spmm {label}: R={cols.shape[0]} K={cols.shape[1]} n={n} "
        f"d={x.shape[1]} max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e}"
        f" run-to-run bitwise equal")
    check(rel_err <= SPMM_RTOL,
          f"ell_spmm {label}: max relative error {rel_err} > {SPMM_RTOL}")
    return abs_err, rel_err


def compare_reach(ops, ref, cols, mask, row_ids, x, n, index, label):
    y = ops.ell_reach(cols, mask, row_ids, x, n, index=index)
    y_ref = ref.ell_reach_ref(cols, mask, row_ids, x, n)
    abs_err = float((y - y_ref).abs().max()) if y.numel() else 0.0
    bitwise = bool(y.equal(y_ref))
    say(f"  ell_reach {label}: R={cols.shape[0]} K={cols.shape[1]} n={n} "
        f"d={x.shape[1]} max_abs_err={abs_err:.3e} bitwise={bitwise}")
    check(bitwise, f"ell_reach {label}: not bitwise equal")
    return abs_err


def phase_kernels(ds, reps: int):
    import torch
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    n, k, r_cap = 262_144, 64, 393_216
    cols, vals, mask, row_ids = random_ell(n, r_cap, k, seed=0)
    index = build_row_index(mask, row_ids, n)
    nnz = int(mask.sum())
    say(f"phase kernels: synthetic ELL n={n} R={r_cap} K={k} nnz={nnz} "
        f"live_rows={index[0].shape[0]} "
        f"empty_vertices={int((index[1][1:] == index[1][:-1]).sum())}")
    live = mask.nonzero(as_tuple=True)
    coo = torch.sparse_coo_tensor(
        torch.stack([row_ids[live[0]].to(torch.int64),
                     cols[live].to(torch.int64)]),
        vals[live], (n, n)).coalesce()
    csr = coo.to_sparse_csr()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for d in ds:
        x = torch.rand((n, d), device="cuda", generator=gen)
        xb = (torch.rand((n, d), device="cuda", generator=gen)
              < 0.1).to(torch.float32)
        s_abs, s_rel = compare_spmm(ops, ref, cols, vals, mask, row_ids, x,
                                    n, index, f"synthetic d={d}")
        r_abs = compare_reach(ops, ref, cols, mask, row_ids, xb, n, index,
                              f"synthetic d={d}")
        s_ms = cuda_ms(lambda: ops.ell_spmm(cols, vals, mask, row_ids, x, n,
                                            index=index), reps)
        r_ms = cuda_ms(lambda: ops.ell_reach(cols, mask, row_ids, xb, n,
                                             index=index), reps)
        s_plain = cuda_ms(lambda: ref.ell_spmm_ref(cols, vals, mask, row_ids,
                                                   x, n), 3, warmup=1)
        r_plain = cuda_ms(lambda: ref.ell_reach_ref(cols, mask, row_ids, xb,
                                                    n), 3, warmup=1)
        s_lib = cuda_ms(lambda: torch.sparse.mm(csr, x), reps)
        s_bound, s_by, s_bytes, s_ops = spmm_bound(mask, x, n, True)
        r_bound, r_by, r_bytes, r_ops = spmm_bound(mask, xb, n, False)
        say(f"  d={d} ell_spmm: {s_ms:.4f} ms, plain {s_plain:.4f} ms, "
            f"torch.sparse.mm(csr) {s_lib:.4f} ms, bound {s_bound:.4f} ms "
            f"({s_by}: {s_bytes} B, {s_ops} flop)")
        say(f"  d={d} ell_reach: {r_ms:.4f} ms, plain {r_plain:.4f} ms, "
            f"bound {r_bound:.4f} ms ({r_by}: {r_bytes} B, {r_ops} op)")
        rows[("ell_spmm", d)] = dict(ms=s_ms, plain_ms=s_plain,
                                     library_ms=s_lib, bound_ms=s_bound,
                                     bound_by=s_by, bytes=s_bytes,
                                     max_abs_err=s_abs, max_rel_err=s_rel)
        rows[("ell_reach", d)] = dict(ms=r_ms, plain_ms=r_plain,
                                      library_ms=None, bound_ms=r_bound,
                                      bound_by=r_by, bytes=r_bytes,
                                      max_abs_err=r_abs)
        del x, xb
    torch.cuda.synchronize()
    return rows


# -- phase 3: CUDA vs CPU on a small stream ------------------------------------

def phase_small_agreement():
    from repro_torch.config.base import IGPMConfig, ServingConfig
    from repro_torch.core.query import query_zoo
    from repro_torch.data.temporal import TemporalGraphSpec, generate_stream
    from repro_torch.serving.server import MatchServer
    spec = TemporalGraphSpec("toy", "sparse_dense", n_vertices=512,
                             n_edges=4096, n_steps=40, seed=7)
    cfg = IGPMConfig(n_max=512, e_max=16384, rwr_iters=12,
                     rwr_iters_incremental=4, top_k_patterns=8,
                     init_community_size=32, backend="ell")
    out = {}
    for dev in ("cuda", "cpu"):
        st = generate_stream(spec, n_measured_steps=4, u_max=128, device=dev)
        srv = MatchServer(cfg, query_zoo(4), ServingConfig(adaptive=False),
                          device=dev)
        _, stats = srv.run(st.graph, st.updates)
        out[dev] = ([s.deltas for s in stats],
                    [dict(s._patterns) for s in srv.stores])
    check(out["cuda"][0] == out["cpu"][0],
          "small stream: CUDA and CPU match deltas differ")
    worst = 0.0
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        check(sorted(a) == sorted(b),
              "small stream: CUDA and CPU pattern stores differ")
        for key, (good, exact) in a.items():
            check(exact == b[key][1], "small stream: exact flags differ")
            worst = max(worst, abs(good - b[key][0]))
    n_pat = sum(len(s) for s in out["cuda"][1])
    check(n_pat > 0, "small stream: no patterns found")
    say(f"phase small-stream: CUDA == CPU plain on {len(out['cuda'][0])} "
        f"steps, {n_pat} patterns, max goodness diff {worst:.3e}")
    check(worst <= 1e-4, "small stream: goodness differs by more than 1e-4")


# -- phases 4-5: the main path ---------------------------------------------------

class Capture:
    """Wrap the ELL wrappers to keep copies of the first inputs of each
    kind the served path hands them: the label-RWR sweep (d = n_labels),
    the expansion sweep (wider d) and the BFS frontier sweep."""

    def __init__(self, ops, n_labels: int):
        self.ops = ops
        self.n_labels = n_labels
        self.inputs = {}
        self._spmm, self._reach = ops.ell_spmm, ops.ell_reach

    def __enter__(self):
        ops, inputs = self.ops, self.inputs
        spmm, reach, n_labels = self._spmm, self._reach, self.n_labels

        def spy_spmm(cols, vals, mask, row_ids, x, n, index=None):
            key = "label_rwr" if x.shape[1] == n_labels else "expansion_rwr"
            if key not in inputs:
                inputs[key] = tuple(t.clone() for t in
                                    (cols, vals, mask, row_ids, x)) + (n,)
            return spmm(cols, vals, mask, row_ids, x, n, index=index)

        def spy_reach(cols, mask, row_ids, x, n, index=None):
            if "bfs" not in inputs:
                inputs["bfs"] = tuple(t.clone() for t in
                                      (cols, mask, row_ids, x)) + (n,)
            return reach(cols, mask, row_ids, x, n, index=index)

        ops.ell_spmm, ops.ell_reach = spy_spmm, spy_reach
        return self

    def __exit__(self, *exc):
        self.ops.ell_spmm, self.ops.ell_reach = self._spmm, self._reach
        return False


class StepProfiler:
    """With ``enabled``, record step 1 (the first warm step) under
    ``torch.profiler`` and report device time by op and the device busy
    share of that step's wall time. A no-op otherwise."""

    def __init__(self, enabled: bool, label: str):
        self.enabled = enabled
        self.label = label

    def step(self, i: int, fn):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if not self.enabled or i != 1:
            return fn()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        from torch.autograd import DeviceType
        rows = []
        for ev in prof.key_averages():
            # device-side events only (kernels, copies): an aten op's own
            # device time repeats that of the kernels it launched
            if getattr(ev, "device_type", None) == DeviceType.CPU:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy_us = sum(r[0] for r in rows)
        say(f"  profile {self.label} step {i}: wall {wall_s * 1e3:.1f} ms "
            f"(profiled), device busy {busy_us / 1e3:.1f} ms "
            f"({100 * busy_us / 1e6 / wall_s:.1f} %)")
        for dev_us, count, key in rows[:12]:
            say(f"    {dev_us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        return out


def check_results(stats_deltas, where: str) -> int:
    total = sum(d.total for d in stats_deltas)
    check(total > 0, f"{where}: no patterns in the stores")
    return total


def phase_serve_inc(stream, n_steps: int, profile: bool = False):
    import torch
    from repro_torch.config.base import ServingConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.kernels.spmv_ell import ops
    from repro_torch.serving.server import MatchServer
    srv = MatchServer(FULL, query_zoo(16), ServingConfig(adaptive=False),
                      device="cuda")
    g = stream.graph
    ops.reset_launch_counts()
    per_step = []
    prof = StepProfiler(profile, "serve-inc")
    with Capture(ops, FULL.n_labels) as cap:
        for i, upd in enumerate(stream.updates[:n_steps]):
            t0 = time.perf_counter()
            srv.submit_update(upd)
            g, st = prof.step(i, lambda: srv.step(g))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_live = max(int(g.node_mask.sum()), 1)
            storm = st.n_recompute > srv.serving.full_graph_frac * n_live
            say(f"  serve-inc step {i}: {dt:.3f} s (pipeline {st.elapsed:.3f}"
                f" s, ell refresh {st.ell_refresh_s:.3f} s) n_recompute="
                f"{st.n_recompute} storm={storm} subgraph="
                f"{st.subgraph_nodes} vertices/{st.subgraph_edges} arcs "
                f"new_patterns={st.n_new_patterns}")
            if i == 0:
                say(f"  serve-inc louvain dendrogram build (host): "
                    f"{srv.pem.clustering_time:.3f} s")
            per_step.append(dict(step=i, s=dt, pipeline_s=st.elapsed,
                                 n_recompute=st.n_recompute, storm=storm,
                                 subgraph_nodes=st.subgraph_nodes,
                                 new_patterns=st.n_new_patterns))
    launches = dict(ops.LAUNCHES)
    say(f"  serve-inc launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"serve-inc never launched {name}")
    total = check_results(st.deltas, "serve-inc")
    for d in st.deltas:
        check(d.total >= d.exact >= 0, "serve-inc: inconsistent store counts")
    say(f"  serve-inc stores: {total} patterns over {len(st.deltas)} queries")
    return launches, per_step, cap.inputs, srv.pem.clustering_time


def phase_serve_batch(stream, n_steps: int, profile: bool = False):
    import numpy as np
    import torch
    from repro_torch.config.base import EngineConfig
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.core.query import query_zoo
    from repro_torch.engine import Engine
    from repro_torch.kernels.spmv_ell import ops
    eng = Engine(FULL, EngineConfig(mode="batch"), device="cuda")
    for q in query_zoo(16):
        eng.register(q)
    state = eng.init_state(stream.graph)
    ops.reset_launch_counts()
    per_step = []
    prof = StepProfiler(profile, "serve-batch")
    for i, upd in enumerate(stream.updates[:n_steps]):
        t0 = time.perf_counter()
        state, out = prof.step(i, lambda: eng.step(state, upd))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        say(f"  serve-batch step {i}: {dt:.3f} s (pipeline {out.elapsed:.3f}"
            f" s) patterns={out.n_new_patterns} rwr_sweeps={out.rwr_sweeps}")
        per_step.append(dict(step=i, s=dt, pipeline_s=out.elapsed,
                             new_patterns=out.n_new_patterns))
    launches = dict(ops.LAUNCHES)
    say(f"  serve-batch launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"serve-batch never launched {name}")
    check_results(out.deltas, "serve-batch")
    for qid, store in eng.stores.items():
        good = np.asarray([v[0] for v in store._patterns.values()])
        check(bool(np.isfinite(good).all()),
              f"serve-batch: non-finite goodness in {qid}")
    return launches, per_step


def check_captured(inputs):
    from repro_torch.kernels.spmv_ell import ops, ref
    from repro_torch.sparse.ell import build_row_index
    for key in ("label_rwr", "expansion_rwr", "bfs"):
        check(key in inputs, f"serve-inc handed no {key} sweep to a kernel")
    out = {}
    for key in ("label_rwr", "expansion_rwr"):
        cols, vals, mask, row_ids, x, n = inputs[key]
        index = build_row_index(mask, row_ids, n)
        out[key] = compare_spmm(ops, ref, cols, vals, mask, row_ids, x, n,
                                index, f"captured {key}")
    cols, mask, row_ids, x, n = inputs["bfs"]
    index = build_row_index(mask, row_ids, n)
    out["bfs"] = compare_reach(ops, ref, cols, mask, row_ids, x, n, index,
                               "captured bfs")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile serve step 1 of each path (device time "
                         "by op, device busy share)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        say("chip_smoke: FAIL torch.cuda.is_available() is False — this "
            "script needs a CUDA card")
        return 2
    if not (SRC / "repro_torch" / "kernels").is_dir():
        say(f"chip_smoke: FAIL no port package under {SRC} — run from a "
            "checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from repro_torch.kernels.spmv_ell import build
    t0 = time.perf_counter()
    built = build.build()
    say(f"phase build: {time.perf_counter() - t0:.2f} s wall "
        f"(per source: {', '.join(f'{k} {v:.2f} s' for k, v in built.items()) or 'cached'})")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  nvcc {name}: {line.strip()}")

    rows = phase_kernels((4, 320), REPS)
    phase_small_agreement()
    from repro_torch.configs.igpm_paper import FULL
    from repro_torch.data.temporal import generate_stream, scaled_twin
    spec = scaled_twin("transactions", 1.0)
    t0 = time.perf_counter()
    stream = generate_stream(spec, n_max=FULL.n_max, e_max=FULL.e_max,
                             n_measured_steps=max(INC_STEPS, BATCH_STEPS),
                             u_max=512, device="cuda")
    say(f"phase stream: {spec.name} n_vertices={spec.n_vertices} "
        f"warm arcs={int(stream.graph.edge_mask.sum())} "
        f"({time.perf_counter() - t0:.2f} s)")
    say("phase serve-inc:")
    launches_inc, inc_steps, captured, louvain_s = phase_serve_inc(
        stream, INC_STEPS, args.profile)
    cap = check_captured(captured)
    del captured
    say("phase serve-batch:")
    launches_batch, batch_steps = phase_serve_batch(
        stream, BATCH_STEPS, args.profile)
    serve = dict(inc_steps=inc_steps, batch_steps=batch_steps,
                 louvain_s=louvain_s, captured=cap)

    kernels = []
    for name, src, line in (
            ("ell_spmm", "src/repro_torch/kernels/spmv_ell/csrc/ell_spmm.cu",
             "src/repro/kernels/spmv_ell/spmv_ell.py:60"),
            ("ell_reach", "src/repro_torch/kernels/spmv_ell/csrc/ell_reach.cu",
             "src/repro/kernels/spmv_ell/spmv_ell.py:91")):
        head = rows[(name, 320)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches_inc[name],
            "launches_batch": launches_batch[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": "R=393216 K=64 n=262144 d=320",
            "by_d": {str(d): rows[(name, d)] for d in (4, 320)},
        })
    say(f"serve summary: {json.dumps(serve)}")
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        say(f"chip_smoke: FAIL {exc}")
        sys.exit(1)
