"""Roofline terms and the analytic model FLOPs and minimum bytes of every
cell (PyTorch port of ``repro.launch.roofline``).

Three terms per (arch × shape × mesh), in seconds, at the H100's
data-sheet rates (``kernels/measure.py``, the one source of them):

  compute    = FLOPs_per_chip / 989e12              (dense bf16 peak)
  memory     = bytes_per_chip / 3.35e12             (HBM3)
  collective = collective_bytes_per_chip / 450e9    (NVLink, each way)

The counts come from ``launch/dryrun.py``: executed FLOPs from
``torch.utils.flop_counter.FlopCounterMode``, op-level bytes from its
dispatch tracker, collective bytes from the mesh's per-collective counter
(``Mesh.bytes``). The reference parses them out of compiled HLO text
(``_shape_bytes``, ``_group_size``, ``_computation_multipliers``,
``collective_bytes``); eager torch has no HLO, so those parsers have no
counterpart here. The analytic model FLOPs and minimum bytes per family
are the reference's arithmetic, unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels.measure import (H100_BF16_FLOPS, H100_BYTES_PER_S,
                                         H100_NVLINK_BYTES_PER_S)

PEAK_FLOPS = H100_BF16_FLOPS          # bf16 / card
HBM_BW = H100_BYTES_PER_S             # bytes/s
LINK_BW = H100_NVLINK_BYTES_PER_S     # bytes/s, one direction


def remat_multiplier(arch, kind: str) -> float:
    """Executed-FLOPs multiplier over the analytic model FLOPs: activation
    rematerialization re-runs the forward pass during backward."""
    if kind != "train" or arch.family != "lm":
        return 1.0
    remat = getattr(arch.model, "remat", "none")
    return {"full": 4.0 / 3.0, "dots": 7.0 / 6.0, "none": 1.0}.get(remat, 1.0)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float,
                   analytic_mem_per_chip: Optional[float] = None,
                   analytic_flops_per_chip: Optional[float] = None
                   ) -> Dict[str, float]:
    """Three roofline terms in seconds, the reference's keys.

    The compute term is max(counted FLOPs, analytic model FLOPs × remat):
    on meta tensors the kernels run their plain versions, so the counted
    FLOPs are the plain versions' (``compute_s_hlo`` keeps them, under the
    reference's name). The op-level bytes (each op's inputs and outputs,
    before any fusion) overstate HBM traffic, so the memory term is the
    analytic minimum where there is one; the op-level term is
    ``memory_s_oplevel``."""
    f = flops_per_chip
    if analytic_flops_per_chip is not None:
        f = max(f, analytic_flops_per_chip)
    t_c = f / PEAK_FLOPS
    t_m_op = bytes_per_chip / HBM_BW
    t_m = (analytic_mem_per_chip / HBM_BW
           if analytic_mem_per_chip is not None else t_m_op)
    t_x = coll_bytes_per_chip / LINK_BW
    dominant = max((t_c, "compute"), (t_m, "memory"),
                   (t_x, "collective"))[1]
    bound = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c,
        "compute_s_hlo": flops_per_chip / PEAK_FLOPS,
        "memory_s": t_m,
        "memory_s_oplevel": t_m_op,
        "collective_s": t_x,
        "dominant": dominant,
        "roofline_s": bound,
        # fraction of the bound spent on useful compute — the score axis
        "compute_fraction": (t_c / bound) if bound > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (useful work), per family
# ---------------------------------------------------------------------------

def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6·N_active·D (train) / 2·N_active·D (fwd-only) + attention term."""
    n_active = cfg.active_param_count()
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
    if kind == "train":
        tokens = batch * seq
        attn = 3 * 4 * batch * seq * seq * H * hd * 0.5 * L  # causal, f+b
        return 6.0 * n_active * tokens + attn
    if kind == "prefill":
        tokens = batch * seq
        attn = 4 * batch * seq * seq * H * hd * 0.5 * L
        return 2.0 * n_active * tokens + attn
    # decode: one token/sequence; attention reads the whole cache
    attn = 4 * batch * seq * H * hd * L
    return 2.0 * n_active * batch + attn


def gnn_model_flops(cfg, n_nodes: int, n_edges: int, d_feat: int,
                    train: bool = True) -> float:
    d = cfg.d_hidden
    mult = 3.0 if train else 1.0
    if cfg.kind == "schnet":
        per_edge = 2 * (cfg.n_rbf * d + d * d)
        per_node = 2 * (d_feat * d + 3 * d * d)
        f = cfg.n_layers * (n_edges * per_edge + n_nodes * 2 * d * d) \
            + n_nodes * per_node
    elif cfg.kind == "dimenet":
        T = n_edges * cfg.triplets_per_edge
        sbf = cfg.n_spherical * cfg.n_radial
        per_trip = 2 * (sbf * cfg.n_bilinear + d * cfg.n_bilinear * d)
        per_edge = 2 * (4 * d * d + cfg.n_radial * d)
        f = cfg.n_layers * (T * per_trip + n_edges * per_edge) \
            + n_edges * 2 * (2 * d_feat + cfg.n_radial) * d
    elif cfg.kind == "graphcast":
        from repro_torch.models.gnn.graphcast import mesh_sizes
        msz = mesh_sizes(cfg.mesh_refinement)
        per_edge = 2 * (2 * d * d + d * d)
        per_node = per_edge
        f = cfg.n_layers * (msz["mesh_arcs"] * per_edge
                            + msz["mesh_nodes"] * per_node) \
            + n_nodes * 2 * (d_feat * d + 7 * d * d + 2 * d * cfg.d_out)
    else:  # meshgraphnet
        per_edge = 2 * (3 * d * d + d * d)
        per_node = 2 * (2 * d * d + d * d)
        f = cfg.n_layers * (n_edges * per_edge + n_nodes * per_node) \
            + n_nodes * 2 * (d_feat * d + d * d + d * cfg.d_out)
    return mult * f


def bst_model_flops(cfg, batch: int, kind: str,
                    candidates: int = 0) -> float:
    d = 2 * cfg.embed_dim
    s1 = cfg.seq_len + 1
    blk = cfg.n_blocks * (2 * s1 * (4 * d * d + 8 * d * d)
                          + 4 * s1 * s1 * d)
    mlp_in = s1 * d + cfg.n_user_feats * cfg.embed_dim
    dims = (mlp_in,) + tuple(cfg.mlp_dims) + (1,)
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    fwd = batch * (blk + mlp)
    if kind == "train":
        return 3.0 * fwd
    if candidates:
        return fwd + 2.0 * batch * candidates * d
    return fwd


def igpm_model_flops(meta: dict) -> float:
    """Label-RWR refresh: per sweep, each arc multiplies and accumulates an
    L-wide row (2 flops/entry) + the restart blend (2·n·L)."""
    return meta["rwr_iters"] * (2.0 * meta["n_edges"] * meta["n_labels"]
                                + 2.0 * meta["n_nodes"] * meta["n_labels"])


def analytic_model_flops(arch, shape, meta: dict) -> Optional[float]:
    if arch.family == "igpm":
        return igpm_model_flops(meta)
    if arch.family == "lm":
        return lm_model_flops(arch.model, shape.kind,
                              shape.dims["global_batch"],
                              shape.dims["seq_len"])
    if arch.family == "gnn":
        return gnn_model_flops(arch.model, meta["n_nodes"], meta["n_edges"],
                               shape.dims["d_feat"])
    if arch.family == "recsys":
        return bst_model_flops(arch.model, shape.dims["batch"],
                               "train" if shape.kind == "train" else "serve",
                               candidates=shape.dims.get("n_candidates", 0))
    return None


# ---------------------------------------------------------------------------
# Analytic minimum HBM traffic (global bytes per step)
# ---------------------------------------------------------------------------

def lm_memory_bytes(cfg, kind: str, batch: int, seq: int) -> float:
    """First-principles HBM traffic: parameter/optimizer streams +
    checkpointed activations (+ KV cache for serving)."""
    n = cfg.param_count()
    n_act = cfg.active_param_count()
    L, d = cfg.n_layers, cfg.d_model
    kv_bytes = 2 * L * batch * seq * cfg.n_kv_heads * cfg.head_dim * 2
    act = L * batch * seq * d * 2  # one bf16 residual checkpoint per layer
    if kind == "train":
        # fwd read (bf16-cast) + bwd read + grad write + AdamW m/v r/w + p r/w
        param_stream = n * (2 + 2) + n * 4 + n * 4 * 4 + n * 4 * 2
        # checkpoints written once, read once; recompute streams ~6 tensors
        act_stream = act * (2 + 6)
        return param_stream + act_stream
    if kind == "prefill":
        return n_act * 2 + act * 2 + kv_bytes
    # decode: stream active params + the whole KV cache once
    return n_act * 2 + kv_bytes


def gnn_memory_bytes(cfg, n_nodes: int, n_edges: int, d_feat: int) -> float:
    d = cfg.d_hidden
    gather_scatter = 3 * n_edges * d * 4  # msg read + write + scatter
    if cfg.kind == "dimenet":
        gather_scatter += 3 * n_edges * cfg.triplets_per_edge * d * 4
    if cfg.kind == "graphcast":
        from repro_torch.models.gnn.graphcast import mesh_sizes
        msz = mesh_sizes(cfg.mesh_refinement)
        gather_scatter += 3 * msz["mesh_arcs"] * d * 4 * cfg.n_layers
    feats = n_nodes * (d_feat + 2 * d) * 4
    return 3 * (cfg.n_layers * gather_scatter + feats)  # train ≈ 3× fwd


def bst_memory_bytes(cfg, batch: int, kind: str, candidates: int = 0) -> float:
    e = cfg.embed_dim
    lookups = batch * (cfg.seq_len + 1) * 2 * e * 4 \
        + batch * cfg.n_user_feats * e * 4
    mlp_in = (cfg.seq_len + 1) * 2 * e + cfg.n_user_feats * e
    dims = (mlp_in,) + tuple(cfg.mlp_dims) + (1,)
    params = sum(a * b for a, b in zip(dims[:-1], dims[1:])) * 4
    acts = batch * sum(dims) * 4
    base = lookups + params + acts
    if kind == "train":
        return 3 * base + 4 * params  # grads + opt streams
    if candidates:
        return base + candidates * 2 * e * 4
    return base


def igpm_memory_bytes(meta: dict) -> float:
    per_sweep = (meta["n_edges"] * (meta["n_labels"] * 4 * 2 + 8)
                 + meta["n_nodes"] * meta["n_labels"] * 4 * 2)
    return meta["rwr_iters"] * per_sweep


def analytic_memory_bytes(arch, shape, meta: dict) -> Optional[float]:
    if arch.family == "igpm":
        return igpm_memory_bytes(meta)
    if arch.family == "lm":
        return lm_memory_bytes(arch.model, shape.kind,
                               shape.dims["global_batch"],
                               shape.dims["seq_len"])
    if arch.family == "gnn":
        return gnn_memory_bytes(arch.model, meta["n_nodes"],
                                meta["n_edges"], shape.dims["d_feat"])
    if arch.family == "recsys":
        return bst_memory_bytes(arch.model, shape.dims["batch"],
                                "train" if shape.kind == "train" else "serve",
                                candidates=shape.dims.get("n_candidates", 0))
    return None
