"""Measurement helpers for the kernels on a CUDA card.

Shared by ``chip_smoke.py``, ``tools/kernel_sweep.py`` and
``launch/roofline.py``: the H100's data-sheet rates that the bounds are
computed from, the card's name and
power limit, a CUDA-event timer that keeps the wrapper's host time out of
the measurement, and the synthetic full-mirror ELL tile with its gather
floor. Nothing in the port's serving path imports this module.
"""

from __future__ import annotations

import statistics
import subprocess

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # fp32 outside the tensor cores, data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores, data sheet
# NVLink 4: 900 GB/s per GPU in total, 450 GB/s in each direction, H100
# SXM data sheet
H100_NVLINK_BYTES_PER_S = 450e9
SPIN_CYCLES = 2_000_000  # card clock cycles spun before each timed run


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each bracketed
    by its own pair of CUDA events. Before each run the card spins for
    about 1 ms, so the host's work in ``fn`` before its launch overlaps
    the spin and the start event fires with the launch already queued:
    the time is the card's, not the wrapper's Python."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_ell(n: int, r_cap: int, k: int, seed: int, device="cuda"):
    """Random incoming-adjacency ELL tile shaped like the full mirror: one
    first row per vertex in vertex order, spill rows for vertices with
    more than ``k`` entries handed out in shuffled order after them,
    unallocated capacity rows (row_id 0, all masked) at the end, ~10 %
    empty vertices; entries packed at the front of each row. Returns
    (cols int32, vals float32, mask bool, row_ids int32)."""
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


def gather_floor(mask, d: int) -> float:
    """Milliseconds to read every live entry's row of x once from device
    memory (nnz · d · 4 bytes), as when x is far larger than L2."""
    return int(mask.sum()) * d * 4 / H100_BYTES_PER_S * 1e3
