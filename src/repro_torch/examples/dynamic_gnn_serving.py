"""PEM-gated incremental GNN re-embedding on a dynamic graph (PyTorch port
of the JAX package's ``examples/dynamic_gnn_serving.py``).

The paper's Partial Execution Manager generalizes beyond pattern matching:
on a time-evolving graph served by a GNN encoder, each update step only
re-encodes the nodes whose Louvain communities were touched — the same
cluster-gated partial recomputation, applied to embeddings instead of
matches.

This script compares, per update step:
  full      — re-encode every node (the batch baseline)
  pem       — re-encode only PEM-selected communities; report the recompute
              fraction and the embedding staleness (max L2 drift vs full)

The encoder and the PEM's agent run on the card (MeshGraphNet aggregates
through ``sparse/segment.py``; no port kernel lies on this path).

Run:  PYTHONPATH=src python -m repro_torch.examples.dynamic_gnn_serving
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.config.base import GNNConfig, IGPMConfig
from repro_torch.core.graph import apply_update, updated_vertices
from repro_torch.core.pem import PartialExecutionManager
from repro_torch.data.temporal import TemporalGraphSpec, generate_stream
from repro_torch.models.gnn.common import GraphInputs
from repro_torch.models.gnn.meshgraphnet import MeshGraphNet

D_FEAT = 16


def encode(model, params, g, feats):
    em = g.edge_mask
    inputs = GraphInputs(node_feat=feats, senders=g.senders[em],
                         receivers=g.receivers[em],
                         targets=torch.zeros((feats.shape[0], 1),
                                             device=feats.device))
    return model.forward(params, inputs)


def build(device="cuda", params=None, feats=None, agent=None,
          n_vertices: int = 2048, n_edges: int = 16384,
          n_measured: int = 6) -> dict:
    """The stream, the encoder and its weights, the node features and the
    PEM on ``device``. ``params`` / ``feats``: the encoder's weights and
    the (n, 16) features (default: drawn from seeds 0 and 1); ``agent``: a
    DQN state dict the PEM starts from (default: its own seeded init)."""
    spec = TemporalGraphSpec("serving", "sparse_dense", n_vertices=n_vertices,
                             n_edges=n_edges, n_steps=200, seed=3)
    stream = generate_stream(spec, n_measured_steps=n_measured,
                             device=device)
    cfg = GNNConfig(kind="meshgraphnet", n_layers=3, d_hidden=32,
                    mlp_layers=2, d_out=1)
    model = MeshGraphNet(cfg)
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0),
                            d_feat=D_FEAT, d_edge=4)
    if feats is None:
        feats = torch.randn((spec.n_vertices, D_FEAT),
                            generator=torch.Generator(device).manual_seed(1),
                            device=device)
    pem = PartialExecutionManager(
        IGPMConfig(n_max=spec.n_vertices, e_max=stream.graph.e_max,
                   init_community_size=64), adaptive=True, seed=0,
        device=device)
    if agent is not None:
        pem.agent.load_state_dict(agent)
    return dict(spec=spec, stream=stream, model=model, params=params,
                feats=feats, pem=pem)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run(inputs: dict,
        reward_time: Optional[Callable[[float], float]] = None,
        print_fn=print) -> list:
    """Per update step: the full encode, then the PEM's recompute mask,
    the masked merge into the served embeddings, the staleness (max L2
    drift against the full encode) and the PEM's feedback with the PEM
    path's time (``reward_time`` maps it to the time the reward reads;
    default: as measured). Returns each step's record."""
    spec, model, params = inputs["spec"], inputs["model"], inputs["params"]
    feats, pem = inputs["feats"], inputs["pem"]
    g = inputs["stream"].graph
    emb = encode(model, params, g, feats)
    print_fn(f"{spec.n_vertices} nodes, {int(g.edge_mask.sum())} live arcs;"
             f" encoder: meshgraphnet 3L/32")
    out = []
    for step, upd in enumerate(inputs["stream"].updates):
        g = apply_update(g, upd)
        ids, mask = updated_vertices(g, upd, 4096)
        upd_ids = torch.where(mask, ids, -1).cpu().numpy()

        t0 = time.perf_counter()
        full = encode(model, params, g, feats)
        _sync(full)
        t_full = time.perf_counter() - t0

        t0 = time.perf_counter()
        rec_mask, frac = pem.recompute_mask(g, upd_ids)
        partial = encode(model, params, g, feats)  # same program; in a real
        # deployment the PEM mask gates an induced-subgraph encode (see
        # core.subgraph) — here we quantify what it MAY skip
        keep = torch.as_tensor(rec_mask, device=partial.device)
        stale = torch.where(keep[:, None], partial, emb)
        _sync(stale)
        t_pem = time.perf_counter() - t0
        drift = float(torch.linalg.vector_norm(full - stale, dim=1).max())
        emb = stale
        c, _ = pem.feedback(g, frac, t_pem if reward_time is None
                            else reward_time(t_pem))
        print_fn(f"step {step}: recompute {int(rec_mask.sum()):5d}/"
                 f"{spec.n_vertices} nodes ({rec_mask.mean():5.1%}) "
                 f"c={c:3d} staleness(maxL2)={drift:.4f} "
                 f"t_full={t_full*1e3:.0f}ms")
        out.append(dict(mask=rec_mask, frac=frac, c=c, drift=drift,
                        emb=emb, t_full=t_full, t_pem=t_pem))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(build(args.device))


if __name__ == "__main__":
    main()
