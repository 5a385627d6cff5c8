"""Quickstart: adaptive incremental graph pattern matching (IGPM-PEM)
(PyTorch port of the JAX package's ``examples/quickstart.py``).

Builds a synthetic temporal social graph (a scaled statistical twin of the
paper's friends2008 stream), then watches the three matchers from the paper
process the same update stream:

  Batch      — re-run G-Ray from scratch every step
  Inc        — IGPM on update-touched communities (fixed size)
  Adaptive   — IGPM-PEM: a DQN adapts the community granularity online

On the card the sweeps run the ELL kernels (``backend="auto"`` resolves to
``ell`` there); on the CPU their plain COO versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

from repro_torch.config.base import IGPMConfig
from repro_torch.core.matcher import (AdaptiveMatcher, BatchMatcher,
                                      NaiveIncrementalMatcher)
from repro_torch.core.query import square
from repro_torch.data.temporal import generate_stream, scaled_twin

MATCHERS = {"batch": BatchMatcher, "inc": NaiveIncrementalMatcher,
            "adaptive": AdaptiveMatcher}


def stream_config(scale: float = 0.01, n_steps: int = 200):
    """The friends2008 twin at ``scale``, the matchers' config and the
    query."""
    spec = scaled_twin("friends2008", scale=scale, n_steps=n_steps)
    cfg = IGPMConfig(n_max=spec.n_vertices,
                     e_max=int(2.4 * spec.n_edges) + 4096,
                     rwr_iters=15, rwr_iters_incremental=4,
                     top_k_patterns=10, init_community_size=64)
    return spec, cfg, square()


def build(name: str, query, cfg: IGPMConfig, device="cuda", agent=None,
          reward_time: Optional[Callable[[float], float]] = None):
    """The ``name`` matcher on ``device``. ``agent``: a DQN state dict the
    adaptive matcher's PEM starts from (default: its own seeded init);
    ``reward_time``: maps each step's measured time to the time the PEM's
    reward reads (default: as measured)."""
    matcher = MATCHERS[name](query, cfg, device=device)
    pem = matcher.pem
    if agent is not None and pem.agent is not None:
        pem.agent.load_state_dict(agent)
    if reward_time is not None:
        feedback = pem.feedback
        pem.feedback = lambda g, frac, elapsed: feedback(
            g, frac, reward_time(elapsed))
    return matcher


def run(matcher, spec, device="cuda", n_measured: int = 8) -> dict:
    """A warm pass on the stream, ``reset``, then the measured pass on an
    identical stream: the summed pipeline time, wall time, the store and
    each measured step's stats."""
    # warm pass on an identical stream builds every bucket shape
    stream = generate_stream(spec, n_measured_steps=n_measured, device=device)
    g = stream.graph
    for upd in stream.updates:
        g, _ = matcher.step(g, upd)
    matcher.reset()

    stream = generate_stream(spec, n_measured_steps=n_measured, device=device)
    g = stream.graph
    t0 = time.time()
    elapsed, steps = 0.0, []
    for upd in stream.updates:
        g, st = matcher.step(g, upd)
        elapsed += st.elapsed
        steps.append(st)
    return dict(elapsed=elapsed, wall=time.time() - t0,
                patterns=matcher.store.total, exact=matcher.store.exact,
                steps=steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec, cfg, query = stream_config()
    print(f"stream: {spec.n_vertices} vertices, {spec.n_edges} edges "
          f"({spec.kind}); query: {query.name}")

    results = {}
    for name in MATCHERS:
        res = run(build(name, query, cfg, args.device), spec, args.device)
        results[name] = res
        print(f"{name:9s} igpm={res['elapsed']:7.3f}s "
              f"wall={res['wall']:6.1f}s patterns={res['patterns']:4d} "
              f"(exact={res['exact']}) "
              f"last-step recompute={res['steps'][-1].n_recompute}")

    b, i = results["batch"]["elapsed"], results["inc"]["elapsed"]
    print(f"\nincremental speedup vs batch: {b / max(i, 1e-9):.2f}x "
          f"(paper: 3.1-10.1x at full scale)")
    print(f"patterns found: batch={results['batch']['patterns']} "
          f"adaptive={results['adaptive']['patterns']} "
          f"(paper: incremental finds 25-73% more)")
    return results


if __name__ == "__main__":
    main()
