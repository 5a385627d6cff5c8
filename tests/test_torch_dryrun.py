"""The port's roofline and dry run (``launch/roofline.py``,
``launch/dryrun.py``) on the CPU.

The analytic model FLOPs and minimum bytes must equal the reference's
(``repro.launch.roofline``) exactly on each of the 44 cells' published
dims; ``roofline_terms`` takes the H100's rates. The reference's
``repro.launch.dryrun`` is never imported: its first lines set
``XLA_FLAGS``.

The dry run of a reduced cell (an LM, the IGPM refresh, DimeNet's
edge-sharded step, BST's row-sharded train step) on a 2 × 2 meta mesh must
count exactly what the same step counts when it runs on ``["cpu"] * 4``
with values:
collective bytes by name and by receiving position, and per position the
FLOPs, the op bytes and the peak of the storage the step creates. The
concrete run is repeated under ``FlopCounterMode`` (``check_flops``), whose
total must equal the tracker's FLOPs; the meta runs count each AdamW leaf
update once per shape and charge the repeats (``Tracker.replay``, which
takes ``train.state``'s ``adamw_leaf`` while the tracker runs), so the
equality also checks that replay. On a mesh of more than one position the
tracker refuses an op that runs outside every ``Mesh.at``.
"""

import contextlib
import json
import math

import pytest
import torch

from repro_torch.config.registry import get_arch, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as RF
from repro_torch.launch.mesh import Mesh

torch.set_num_threads(1)

CELLS = dryrun.cell_list()


def _ref_meta(arch_id, shape):
    """The reference cell's ``meta`` for the analytic models (the GNN
    sizes padded as its cells pad them, the IGPM refresh's sizes)."""
    from repro.launch.cells import _pad512, gnn_cell_sizes
    from repro.config.registry import get_arch as rget
    arch = rget(arch_id)
    dims = shape.dims
    if arch.family == "gnn":
        n, e = gnn_cell_sizes(shape.name, dims, padded=True)
        return {"n_nodes": n, "n_edges": e}
    if arch.family == "igpm":
        return {"n_nodes": dims["n_vertices"],
                "n_edges": _pad512(2 * dims["n_edges"]),
                "rwr_iters": arch.model.rwr_iters_incremental,
                "n_labels": arch.model.n_labels}
    return {}


def test_cell_list_is_the_references():
    assert len(CELLS) == 44
    fams = [get_arch(a).family for a, _ in CELLS]
    assert fams.count("lm") == 20 and fams.count("igpm") == 4
    assert fams.count("gnn") == 16 and fams.count("recsys") == 4
    assert sorted({a for a, _ in CELLS}) == list_archs()


@pytest.mark.parametrize("arch_id,shape_name", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_analytic_models_equal_the_references(arch_id, shape_name):
    from repro.config.registry import get_arch as rget
    from repro.launch import roofline as R
    arch, rarch = get_arch(arch_id), rget(arch_id)
    shape, rshape = arch.shape(shape_name), rarch.shape(shape_name)
    meta = _ref_meta(arch_id, rshape)
    got = RF.analytic_model_flops(arch, shape, meta)
    want = R.analytic_model_flops(rarch, rshape, meta)
    assert got == want and got > 0
    assert RF.analytic_memory_bytes(arch, shape, meta) == \
        R.analytic_memory_bytes(rarch, rshape, meta)
    assert RF.remat_multiplier(arch, shape.kind) == \
        R.remat_multiplier(rarch, rshape.kind)
    if arch.family == "lm":
        for kind in ("train", "prefill", "decode"):
            assert RF.lm_model_flops(arch.model, kind, 3, 17) == \
                R.lm_model_flops(rarch.model, kind, 3, 17)
    if arch.family == "igpm":
        assert meta["n_edges"] % 512 == 0


@pytest.mark.parametrize("case", ["compute", "memory", "collective",
                                  "analytic_floor", "analytic_memory"])
def test_roofline_terms_on_the_h100(case):
    """One second of each resource at the H100's data-sheet rates; the
    analytic FLOPs floor the counted ones, the analytic bytes replace the
    op-level ones."""
    peak, hbm, link = 989e12, 3.35e12, 450e9
    if case == "compute":
        t = RF.roofline_terms(peak, 0, 0)
        assert t["dominant"] == "compute" and abs(t["compute_s"] - 1) < 1e-12
    elif case == "memory":
        t = RF.roofline_terms(0, hbm, 0)
        assert t["dominant"] == "memory" and abs(t["memory_s"] - 1) < 1e-12
    elif case == "collective":
        t = RF.roofline_terms(0, 0, link)
        assert t["dominant"] == "collective"
        assert abs(t["collective_s"] - 1) < 1e-12
    elif case == "analytic_floor":
        t = RF.roofline_terms(1.0, 0, 0, analytic_flops_per_chip=peak)
        assert abs(t["compute_s"] - 1) < 1e-12 and t["compute_s_hlo"] < 1e-12
    else:
        t = RF.roofline_terms(0, 2 * hbm, 0, analytic_mem_per_chip=hbm)
        assert abs(t["memory_s"] - 1) < 1e-12
        assert abs(t["memory_s_oplevel"] - 2) < 1e-12
    assert t["roofline_s"] == max(t["compute_s"], t["memory_s"],
                                  t["collective_s"])
    assert set(t) == {"compute_s", "compute_s_hlo", "memory_s",
                      "memory_s_oplevel", "collective_s", "dominant",
                      "roofline_s", "compute_fraction"}


RUNS = [("qwen3-moe-30b-a3b", "train_4k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
        ("qwen3-moe-30b-a3b", "decode_32k"), ("smollm-135m", "long_500k"),
        ("deepseek-7b", "train_4k"), ("igpm-pem", "friends2008"),
        ("dimenet", "full_graph_sm"), ("bst", "train_batch")]


@pytest.mark.parametrize("arch_id,shape_name", RUNS,
                         ids=[f"{a}-{s}" for a, s in RUNS])
def test_meta_run_counts_what_a_concrete_run_counts(arch_id, shape_name):
    recs = []
    for dev, check in (("meta", False), ("cpu", False), ("cpu", True)):
        mesh = Mesh((2, 2), ("data", "model"), [dev] * 4)
        recs.append(dryrun.run_cell(arch_id, shape_name, smoke=True,
                                    mesh=mesh, concrete=dev == "cpu",
                                    check_flops=check))
    meta, conc, counted = recs
    assert meta["collectives"] == conc["collectives"]
    assert meta["collectives"], "the step moved nothing between positions"
    for key in ("flops", "op_bytes", "temp_peak_bytes", "output_bytes",
                "argument_bytes", "collective_bytes_received"):
        assert meta["per_position"][key] == conc["per_position"][key], key
    # FlopCounterMode's own total (it decomposes some ops, so its run is
    # held on FLOPs only)
    assert counted["cost"]["flop_counter_total"] == \
        counted["cost"]["flops_total"] == conc["cost"]["flops_total"]
    if shape_name == "train_4k":
        assert meta["cost"]["replayed_calls"] > 0
    # the IGPM sweep's index_add_ counts one FLOP per message
    assert meta["cost"]["flops_total"] > 0
    if arch_id == "dimenet":
        # one backward over both edge homes: each home's edge work, forward
        # and backward, is charged to it (Mesh.charge_backward)
        flops = meta["per_position"]["flops"]
        assert flops[2] > 0 and flops[1] == flops[3] == 0
        assert {"edge_psum", "edge_gather", "edge_scatter"} <= \
            set(meta["collectives"])
    if arch_id == "bst":
        # the smoke batch (8 users) lies whole at position 0, which looks
        # its users' items and features up where the tables' rows lie
        import chip_smoke
        from repro_torch.config.registry import get_arch
        from repro_torch.launch.cells import BST_SMOKE_DIMS
        B = BST_SMOKE_DIMS["train_batch"]["batch"]
        want = chip_smoke.bst_lookup_want(get_arch("bst", smoke=True).model,
                                          (2, 2), [(0, B)])
        assert {k: v for k, v in meta["collectives"].items()
                if k.startswith("emb_")} == want
        assert set(want) == {"emb_ids_home", "emb_rows_fold",
                             "emb_grad_home"}


@pytest.mark.parametrize("where", ["outside", "inside", "one-position"])
def test_tracker_refuses_an_op_outside_every_position(where):
    mesh = Mesh((1, 1) if where == "one-position" else (2, 2),
                ("data", "model"), ["meta"] * (1 if where == "one-position"
                                               else 4))
    x = torch.empty((8, 8), device="meta")
    tracker = dryrun.Tracker(mesh)
    with tracker:
        if where == "outside":
            with pytest.raises(RuntimeError, match="outside every Mesh.at"):
                x @ x
            return
        with (mesh.at(3) if where == "inside" else contextlib.nullcontext()):
            x @ x
    pos = 3 if where == "inside" else 0
    assert tracker.flops[pos] == 2 * 8 ** 3 == sum(tracker.flops)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_meta_run_counts_the_recompute(remat, monkeypatch):
    """The reduced MoE config trained with the published configs' remat
    policies: the meta run counts the recompute as the concrete run does,
    and the counted FLOPs grow by it."""
    from repro_torch.config import registry
    arch = get_arch("qwen3-moe-30b-a3b", smoke=True).replace_model(
        remat=remat)
    name = f"qwen3-moe-smoke-remat-{remat}"
    monkeypatch.setitem(registry._REGISTERED, name, lambda: arch)
    monkeypatch.setitem(registry._REGISTERED_SMOKE, name, lambda: arch)
    recs = []
    for dev in ("meta", "cpu"):
        mesh = Mesh((2, 2), ("data", "model"), [dev] * 4)
        recs.append(dryrun.run_cell(name, "train_4k", smoke=True, mesh=mesh,
                                    concrete=dev == "cpu"))
    meta, conc = recs
    for key in ("flops", "op_bytes", "temp_peak_bytes"):
        assert meta["per_position"][key] == conc["per_position"][key], key
    plain = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", smoke=True,
                            mesh=Mesh((2, 2), ("data", "model"),
                                      ["meta"] * 4))
    assert meta["cost"]["flops_total"] > plain["cost"]["flops_total"]
    assert meta["model_flops_ratio"] == {"full": 0.75, "dots": 0.8571}[remat]


def test_record_keys():
    mesh = Mesh((2, 2), ("data", "model"), ["meta"] * 4)
    rec = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", smoke=True,
                          mesh=mesh)
    for key in ("arch", "shape", "kind", "mesh", "n_chips", "meta",
                "memory", "cost", "collectives", "collective_bytes_per_chip",
                "analytic_memory_bytes_total", "roofline",
                "model_flops_total", "model_flops_ratio", "run_s",
                "per_position", "per_chip"):
        assert key in rec, key
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_per_chip_gb"):
        assert key in rec["memory"]
    assert set(rec["cost"]) >= {"flops_per_chip", "bytes_per_chip"}
    assert rec["kind"] == "train" and rec["n_chips"] == 4
    # the step updates the state in place: its outputs are the metrics,
    # the state counts as aliased arguments, not as new storage
    assert rec["memory"]["output_bytes"] <= 16
    assert rec["memory"]["alias_bytes"] > rec["memory"]["argument_bytes"]
    assert rec["model_flops_ratio"] == 1.0     # the SMOKE config: no remat
    pp = rec["per_position"]
    assert rec["cost"]["flops_per_chip"] == max(pp["flops"])
    assert rec["collective_bytes_per_chip"] == \
        max(pp["collective_bytes_received"])
    assert sum(rec["collectives"].values()) == \
        sum(pp["collective_bytes_received"])
    assert "busiest" in rec["per_chip"]
    json.dumps(rec)


def test_all_lists_the_pending_cells_and_exits_0(tmp_path, capsys):
    """``--all`` runs every cell, the GNN and BST cells included: none is
    pending, and each record carries its roofline terms."""
    rc = dryrun.main(["--all", "--smoke", "--mesh", "2x2", "--out",
                      str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "44 dry-run cells ran OK" in out and "pending" not in out
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 44
    assert not any("pending" in r for r in recs)
    assert all("roofline" in r and "collectives" in r for r in recs)
    fams = [get_arch(r["arch"]).family for r in recs]
    assert fams.count("gnn") == 16 and fams.count("recsys") == 4


def test_a_cell_that_raises_exits_1(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no step")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    rc = dryrun.main(["--arch", "igpm-pem", "--shape", "friends2008",
                      "--smoke", "--mesh", "2x2", "--out", str(tmp_path)])
    assert rc == 1 and "1 FAILURES" in capsys.readouterr().out
    # a cell that runs exits 0
    monkeypatch.undo()
    assert dryrun.main(["--arch", "bst", "--shape", "serve_p99", "--smoke",
                        "--mesh", "2x2", "--out", str(tmp_path)]) == 0
    assert "1 dry-run cells ran OK" in capsys.readouterr().out


def test_tp2d_decode_cell_splits_as_the_reference():
    """qwen3-moe decode_32k (B 128, the batch over "data") on a 4 × 4 meta
    mesh (the production specs; 16 × 16 takes ≈ 15 min on the CPU: its
    copies and sums run per position, 256 of them) runs the reference's
    split: every collective's bytes by name equal
    ``chip_smoke.serve_tp2d_bytes_want`` — among them the lookup's as the
    reference's partitioner forms it: the 12 positions off the diagonal
    permuting their 32 ids, every position gathering the 3 other shards'
    ids along "model", taking its (V/4, d/4) block's rows of all 128 and
    receiving the 3 other vocab blocks' partial rows, then the port's
    re-layout of its shard's 32 rows from the 3 column blocks it lacks —
    every gathered weight byte and the MoE group's exchange (one
    group of 128 tokens spans the 4 batch shards) move along "data"
    (between positions of one "model" coordinate) and every sum along
    "model"; the busiest
    position holds its share of the parameters under the reference's
    specs (each leaf's bytes over its block count) plus its cache block
    within 5 %, and its peak is within 5 % of that plus one layer's
    gathered "model" blocks and the router's rows of the position's
    "model" block (the reference's scan gathers inside its loop body: one
    layer's blocks are live at a time). smollm-135m's long_500k
    (B 1, the batch whole) still moves no parameter."""
    import chip_smoke
    from repro_torch.distrib.sharding import (Layout, lm_param_specs,
                                              map_with_specs)
    from repro_torch.models.transformer import TransformerLM
    mesh = dryrun.meta_mesh(False, (4, 4))
    rec = dryrun.run_cell("qwen3-moe-30b-a3b", "decode_32k", mesh=mesh)
    cfg = get_arch("qwen3-moe-30b-a3b").model
    coll = rec["collectives"]
    assert coll == chip_smoke.serve_tp2d_bytes_want(
        cfg, mesh.shape, 128, 32768, "decode", 4096, 32768)
    d = cfg.d_model
    assert coll["emb_ids_permute"] == 4 * 3 * 32 * 4
    assert coll["emb_ids_gather"] == 16 * 3 * 32 * 4
    assert coll["emb_rows_model"] == 4 * 2 * 3 * 4 * 32 * d // 4 * 2
    assert coll["emb_rows_relayout"] == 16 * 3 * 32 * d // 4 * 2
    assert coll["tp_zero_gather"] > 0 and "all_gather" not in coll
    assert coll["moe_group_dispatch"] > 0
    for (name, a, b) in mesh.moves:
        ca, cb = mesh.coords(a), mesh.coords(b)
        if name in ("tp_zero_gather", "moe_group_probs",
                    "moe_group_dispatch"):
            assert ca["model"] == cb["model"] and ca["data"] != cb["data"]
        if name == "tp_model_sum":
            assert ca["data"] == cb["data"] and ca["model"] != cb["model"]
    params = TransformerLM(cfg).init(torch.Generator(), device="meta")
    specs = lm_param_specs(params, cfg)
    shares = []
    map_with_specs(lambda x, s: shares.append(
        x.numel() * x.element_size()
        // math.prod(Layout(mesh, s, x.shape).counts)),
        params, specs)
    share = sum(shares)
    cache = 2 * cfg.n_layers * (128 // 4) * (32768 // 4) \
        * cfg.n_kv_heads * cfg.head_dim * 2
    # one layer's gathered blocks: each column weight's "model" block,
    # whole along "data", and the router's rows of the position's "model"
    # block (re-split over "model", ``tp_resplit``)
    lp, sp = params["layers"][0], specs["layers"][0]
    layer = 0
    for x, s in [(lp[k], sp[k]) for k in ("wq", "wk", "wv")]:
        lay = Layout(mesh, s, x.shape)
        model = math.prod(mesh.axis_size(a) for axes in lay.axes
                          for a in axes if a == "model")
        layer += x.numel() * x.element_size() // model
    router = lp["moe"]["router"]
    layer += router.numel() * router.element_size() // mesh.axis_size(
        "model")
    mem = rec["memory"]
    assert abs(mem["argument_bytes"] - (share + cache)) <= 0.05 * (share
                                                                   + cache)
    peak = mem["peak_per_chip_gb"] * 1e9
    want = mem["argument_bytes"] + layer
    assert abs(peak - want) <= 0.05 * want, (peak, want)
    long = dryrun.run_cell("smollm-135m", "long_500k")
    assert set(long["collectives"]) <= {
        "tp_act", "tp_partial", "emb_rows_model", "emb_rows_home",
        "kv_write", "q_send",
        "attn_partial", "logits_gather"}, long["collectives"]


@pytest.mark.parametrize("arch_id", ["qwen3-moe-30b-a3b", "smollm-135m"])
def test_tp2d_train_cell_splits_as_the_reference(arch_id, monkeypatch):
    """The reduced train cell under ``REPRO_LM_POLICY=tp2d`` on a 2 × 2 mesh
    runs ``make_tp2d_train_step`` at the reference cell's one microbatch,
    split as the reference's partitioner splits it: each weight gathered
    along "data" (``tp_zero_gather``) and reduce-scattered back
    (``tp_zero_scatter``), the partial products summed over "model"
    (``tp_model_sum``), none of ``block_matmul``'s moves; the meta run counts what the run on ``["cpu"] * 4`` counts, by
    name and by receiving position; each position holds its share of the
    state under the reference's ``tp2d`` specs (each leaf's bytes over its
    block count, for params, m and v)."""
    from repro_torch.distrib.sharding import (Layout, lm_param_specs,
                                              map_with_specs)
    from repro_torch.models.transformer import TransformerLM
    monkeypatch.setenv("REPRO_LM_POLICY", "tp2d")
    recs = []
    for dev in ("meta", "cpu"):
        mesh = Mesh((2, 2), ("data", "model"), [dev] * 4)
        recs.append(dryrun.run_cell(arch_id, "train_4k", smoke=True,
                                    mesh=mesh, concrete=dev == "cpu"))
    meta, conc = recs
    # the reference cell's one microbatch, its rows split over the shards
    assert meta["meta"]["microbatches"] == conc["meta"]["microbatches"] == 1
    assert meta["collectives"] == conc["collectives"]
    for key in ("flops", "op_bytes", "temp_peak_bytes", "output_bytes",
                "argument_bytes", "collective_bytes_received"):
        assert meta["per_position"][key] == conc["per_position"][key], key
    coll = meta["collectives"]
    assert not {"all_gather", "all_gather_grad", "tp_act", "tp_partial",
                "tp_grad_act", "tp_grad_partial"} & set(coll)
    assert coll["tp_zero_gather"] > 0 and coll["tp_zero_scatter"] > 0
    assert coll["tp_model_sum"] > 0 and coll["xent_stats"] > 0
    cfg = get_arch(arch_id, smoke=True).model
    params = TransformerLM(cfg).init(torch.Generator(), dtype=torch.float32,
                                     device="meta")
    mesh = Mesh((2, 2), ("data", "model"), ["meta"] * 4)
    shares = []
    map_with_specs(lambda x, s: shares.append(
        x.numel() * 4 // math.prod(Layout(mesh, s, x.shape).counts)),
        params, lm_param_specs(params, cfg, "tp2d"))
    share = 3 * sum(shares) + 4            # params, m, v and the step
    batch = 2 * 2 * 32 * 4                 # tokens and labels, at 0
    assert meta["per_position"]["argument_bytes"] == \
        [share + batch] + [share] * 3


@pytest.mark.parametrize("arch_id,shape_name,dims", [
    ("qwen3-moe-30b-a3b", "train_4k", {"seq_len": 32, "global_batch": 16}),
    ("bst", "train_batch", {"batch": 32})], ids=["lm", "bst"])
def test_fsdp_train_cells_run_one_microbatch(arch_id, shape_name, dims,
                                             monkeypatch):
    """The ``fsdp`` LM train cell and BST's train cell, their SMOKE batch
    raised to 16 / 32 rows so that it splits over "data" (the cells' rule
    at B ≥ 16), on a 2 × 2 mesh: the reference cell's one microbatch, its
    rows over the 2 batch shards, run at once over both homes. The meta run
    counts what the run on ``["cpu"] * 4`` counts, by name and by
    receiving position, per position FLOPs, op bytes and peak; the loss's
    sum and count cross the homes (``loss_sum``: two 4-byte scalars each
    way), the LM's aux statistics too (``moe_aux_sum``: E f32 and E int32
    a layer each way); each position holds its share of the state under
    the ``fsdp`` specs, and position 0 the batch."""
    from repro_torch.distrib.sharding import (Layout, bst_param_specs,
                                              lm_param_specs,
                                              map_with_specs)
    from repro_torch.launch import cells
    table = (cells.LM_SMOKE_DIMS if arch_id != "bst"
             else cells.BST_SMOKE_DIMS)
    monkeypatch.setitem(table, shape_name, dims)
    monkeypatch.setenv("REPRO_LM_POLICY", "fsdp")
    recs = []
    for dev in ("meta", "cpu"):
        mesh = Mesh((2, 2), ("data", "model"), [dev] * 4)
        recs.append(dryrun.run_cell(arch_id, shape_name, smoke=True,
                                    mesh=mesh, concrete=dev == "cpu"))
    meta, conc = recs
    assert meta["meta"]["microbatches"] == conc["meta"]["microbatches"] == 1
    assert meta["collectives"] == conc["collectives"]
    for key in ("flops", "op_bytes", "temp_peak_bytes", "output_bytes",
                "argument_bytes", "collective_bytes_received"):
        assert meta["per_position"][key] == conc["per_position"][key], key
    coll = meta["collectives"]
    assert coll["loss_sum"] == 2 * 8
    cfg = get_arch(arch_id, smoke=True).model
    mesh = Mesh((2, 2), ("data", "model"), ["meta"] * 4)
    if arch_id == "bst":
        from repro_torch.models.recsys.bst import BST
        params = BST(cfg).init(torch.Generator(), device="meta")
        specs = bst_param_specs(params, cfg)
        batch = dims["batch"] * (2 * cfg.seq_len + 2 + cfg.n_user_feats
                                 + 1) * 4
    else:
        from repro_torch.models.transformer import TransformerLM
        params = TransformerLM(cfg).init(torch.Generator(),
                                         dtype=torch.float32, device="meta")
        specs = lm_param_specs(params, cfg, "fsdp")
        batch = 2 * dims["global_batch"] * dims["seq_len"] * 4
        assert coll["moe_aux_sum"] == \
            cfg.n_layers * 2 * 8 * cfg.moe.n_experts
    shares = []
    map_with_specs(lambda x, s: shares.append(
        x.numel() * 4 // math.prod(Layout(mesh, s, x.shape).counts)),
        params, specs)
    share = 3 * sum(shares) + 4            # params, m, v and the step
    assert meta["per_position"]["argument_bytes"] == \
        [share + batch] + [share] * 3
    print(f"\n{arch_id} {shape_name} at one microbatch on 2 x 2: per "
          f"position peak {meta['per_position']['temp_peak_bytes']}, "
          f"collectives {coll}")
