"""Dry run: every (architecture × input shape) cell built with meta inputs
on the meta production mesh and its step run once, with FLOPs, op bytes,
memory and collective bytes counted per mesh position (PyTorch port of
``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--force] [--jobs N]

The reference lowers and compiles each cell for 256 (or 512) host
devices and reads XLA's cost and memory analyses and the HLO's
collectives. Eager torch has no compiler to ask, so the port runs the
cell's step — the sharded train step, prefill, decode or the IGPM refresh
— once on a mesh of ``["meta"] * 256`` (``["meta"] * 512`` with
``--multi-pod``): meta tensors carry shapes and dtypes and allocate
nothing, and the kernels route to their plain versions, shapes only. The
run is counted by
  * a ``TorchDispatchMode`` (:class:`Tracker`), which charges each op to
    the working mesh position (``Mesh.at``): its executed
    FLOPs by ``torch.utils.flop_counter.FlopCounterMode``'s formula table
    (``flop_registry``; backward and remat recompute included, the plain
    versions' FLOPs), the bytes each op reads and writes (its tensor
    operands and outputs, the counterpart of XLA's pre-fusion "bytes
    accessed"; views, allocations and a collective's own copies
    excluded), and the bytes of live storage the step created (added
    when an op makes a new storage, subtracted when it is freed), whose
    peak is the temp memory. ``run_cell(check_flops=True)`` (the tests)
    also wraps the run in ``FlopCounterMode`` itself and records its
    total; the CLI does not, because that mode's own dispatch costs about
    80 µs an op on meta tensors and a production mesh runs millions;
  * ``Mesh.bytes`` / ``Mesh.received``, reset before the run: the bytes
    each collective moves, and those each position receives.
On meta tensors an AdamW leaf update (``train.state``'s ``adamw_leaf``),
whose work its shapes fix, is counted once per shape and charged again at
each repeat. An op outside every ``Mesh.at`` on a mesh of more than one
position raises, so a step cannot charge another position's work to
position 0 unseen. ``index_add_`` counts one FLOP per source element (a
formula added to the table, which FlopCounterMode then uses too).
Argument bytes per position come from the placed arguments
(``distrib.sharding.position_bytes``; whole tensors count at position 0).

The single controller's layout is not symmetric. Under ``fsdp`` (the
train and prefill cells) each batch shard's home computes and the other
positions store state (and run their experts); under ``tp2d`` the decode
cells' positions multiply their own weight blocks for the homes they
serve, and the homes run the norms, attention and the residual stream,
while the train step (``REPRO_LM_POLICY=tp2d``) runs every position alike:
each holds its batch shard's rows, multiplies its "model" block of each
weight gathered along "data", and repeats the norms and the residual
stream of its "model" group, as the reference's partitioner does.
So every ``*_per_chip`` value of the record is the busiest position's, and
``per_position`` keeps the lists. The roofline's compute term takes max(counted FLOPs, analytic model
FLOPs × remat) per chip as the reference does; the analytic terms per
chip divide the totals by the chip count.

The GNN cells and the LM train cells under ``tp2d`` run one backward over
every position: ``Mesh.charge_backward`` lets each autograd node charge
its backward to the position that made it (an autograd function's node,
a kernel's, to the position of the first op that reads its output), and
the autograd engine's own work between two nodes (the sum of a tensor's
gradients, a leaf's copy of its gradient) is charged to the position that
made its first input. The BST cells run the row-sharded
item table's train step and the per-shard serving steps. Records are
written to ``reports/dryrun_torch/`` (one JSON file per cell × mesh).
Figures from a dry run are host meta runs, not card times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import (FlopCounterMode, flop_registry,
                                      register_flop_formula)

from repro_torch.config.registry import get_arch, list_archs
from repro_torch.distrib.sharding import ShardedTensor, position_bytes
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.roofline import (analytic_memory_bytes,
                                         analytic_model_flops,
                                         remat_multiplier, roofline_terms)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import state as train_state

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"

PER_CHIP = ("the busiest mesh position's value: one process drives every "
            "position; under fsdp each batch shard's home computes and the "
            "other positions store state, under tp2d decode every "
            "position multiplies its weight blocks and the homes run the "
            "rest, so positions differ")

_ALLOC = {torch.ops.aten.empty.memory_format,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default}
# views whose schema declares no alias
_UNDECLARED_VIEWS = {torch.ops.aten._unsafe_view.default}
# a scalar read to the host (``int(t)``): no op on the device (nor are the
# "profiler" namespace's span markers)
_HOST_READ = {torch.ops.aten._local_scalar_dense.default}


_aten = torch.ops.aten
if _aten.index_add not in flop_registry:
    # a segment sum (the IGPM sweep's COO route): one add per source
    # element, which FlopCounterMode's table leaves out
    @register_flop_formula([_aten.index_add, _aten.index_add_])
    def _index_add_flops(self_shape, dim, index_shape, source_shape, *args,
                         **kwargs) -> int:
        return math.prod(source_shape)


_META = torch.device("meta")
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(args, kwargs) -> list:
    """An aten op's arguments, lists (a TensorList, an int list) opened one
    level: every tensor an op takes is in it."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


class Tracker(TorchDispatchMode):
    """Per mesh position (``Mesh.position``): FLOPs (by
    ``FlopCounterMode``'s formulas, ``flop_registry``), op bytes and the
    live and peak bytes of the storages ops create. On a mesh of more than
    one position an op that runs outside every ``Mesh.at`` raises: a step
    names the position of all its work. On meta tensors an op's output
    metadata is kept per (op, argument shapes, strides, dtypes and
    values), so a repeated op makes its outputs without running the meta
    kernel again (their shapes are a function of that key), and while the
    tracker is entered the train step's per-leaf ``adamw_leaf`` goes
    through :meth:`replay`."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh
        n_positions = mesh.size
        self.flops = [0] * n_positions
        self.op_bytes = [0] * n_positions
        self.live = [0] * n_positions
        self.peak = [0] * n_positions
        self._ids = set()
        self._where = {}        # storage id → the position it was made at
        self._kinds = {}
        self._cache = {}
        self._replays = {}
        self.replayed = 0

    def _kind(self, func) -> str:
        k = self._kinds.get(func)
        if k is None:
            schema = func._schema
            rets = schema.returns
            if func in _ALLOC:
                k = "alloc"
            elif func in _UNDECLARED_VIEWS:
                k = "view"
            elif not any(r.alias_info is not None for r in rets):
                k = "functional"
            elif (len(rets) == 1 and rets[0].alias_info is not None
                  and rets[0].alias_info.is_write and schema.arguments
                  and schema.arguments[0].alias_info is not None
                  and schema.arguments[0].alias_info.is_write
                  and not schema.arguments[0].kwarg_only):
                k = "inplace"
            elif any(r.alias_info is not None and r.alias_info.is_write
                     for r in rets):
                k = "call"        # out= variants and the like
            else:
                k = "view"
            self._kinds[func] = k
        return k

    def _meta_out(self, func, flat, args, kwargs, kind):
        key = [func]
        meta = kwargs.get("device") == _META
        for x in flat:
            if isinstance(x, torch.Tensor):
                if not x.is_meta:
                    return func(*args, **kwargs)
                meta = True
                key.append((x.shape, x.stride(), x.dtype))
            elif isinstance(x, _PLAIN):
                key.append(x)
            else:
                key.append(repr(x))
        if not meta:
            return func(*args, **kwargs)
        if kind == "inplace":
            return args[0]
        key = tuple(key)
        hit = self._cache.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                self._cache[key] = (out.shape, out.stride(), out.dtype)
            elif (isinstance(out, (tuple, list))
                  and all(isinstance(o, torch.Tensor) for o in out)):
                self._cache[key] = (type(out), [(o.shape, o.stride(), o.dtype)
                                                for o in out])
            return out
        if len(hit) == 3:
            return torch.empty_strided(hit[0], hit[1], dtype=hit[2],
                                       device=_META)
        return hit[0](torch.empty_strided(m[0], m[1], dtype=m[2],
                                          device=_META) for m in hit[1])

    def __enter__(self):
        self.mesh.tracked = True
        self._adamw_leaf = train_state.adamw_leaf
        train_state.adamw_leaf = lambda *args: self.replay(self._adamw_leaf,
                                                           args)
        return super().__enter__()

    def __exit__(self, *exc):
        self.mesh.tracked = False
        train_state.adamw_leaf = self._adamw_leaf
        return super().__exit__(*exc)

    def _position(self, what) -> int:
        pos = self.mesh.position
        if pos is None:
            if self.mesh.size > 1:
                raise RuntimeError(f"{what} ran outside every Mesh.at on a "
                                   f"mesh of {self.mesh.size} positions")
            return 0
        return pos

    def replay(self, fn, args):
        """``fn(*args)``, an update in place whose work its arguments'
        shapes, dtypes and scalar values fix (``adamw_leaf``): on meta
        tensors, which hold no values, counted once per signature and
        charged again at each repeat instead of running it."""
        key = [fn]
        for x in args:
            if isinstance(x, torch.Tensor):
                if not x.is_meta:
                    return fn(*args)
                key.append((x.shape, x.stride(), x.dtype))
            else:
                key.append(x)
        key = tuple(key)
        pos = self._position(getattr(fn, "__name__", fn))
        hit = self._replays.get(key)
        if hit is None:
            f0, b0, l0, p0 = (self.flops[pos], self.op_bytes[pos],
                              self.live[pos], self.peak[pos])
            self.peak[pos] = l0
            fn(*args)
            hit = (self.flops[pos] - f0, self.op_bytes[pos] - b0,
                   self.peak[pos] - l0, self.live[pos] - l0)
            self.peak[pos] = max(p0, self.peak[pos])
            self._replays[key] = hit
            return None
        self.flops[pos] += hit[0]
        self.op_bytes[pos] += hit[1]
        self.peak[pos] = max(self.peak[pos], self.live[pos] + hit[2])
        self.live[pos] += hit[3]
        self.replayed += 1
        return None

    def _free(self, key: int, pos: int, nbytes: int) -> None:
        self._ids.discard(key)
        self._where.pop(key, None)
        self.live[pos] -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READ or func.namespace == "profiler":
            return func(*args, **kwargs)
        kind = self._kinds.get(func) or self._kind(func)
        if kind == "view":
            return func(*args, **kwargs)
        flat = _flat(args, kwargs)
        if kind == "call":
            out = func(*args, **kwargs)
        else:
            out = self._meta_out(func, flat, args, kwargs, kind)
        ins = [x for x in flat if isinstance(x, torch.Tensor)]
        outs = [o for o in (out if isinstance(out, (tuple, list))
                            else (out,)) if isinstance(o, torch.Tensor)]
        if kind == "functional":
            held = {id(x.untyped_storage()) for x in ins}
            if any(id(o.untyped_storage()) in held for o in outs):
                # an alias its schema does not declare: a view
                self._kinds[func] = "view"
                return out
        pos = self._position(func)
        if self.mesh.shifted:
            # the autograd engine's work between two nodes (the sum of a
            # tensor's gradients, a leaf's copy of its gradient): charged
            # where its first input was made
            pos = next((self._where[k] for k in (
                id(x.untyped_storage()) for x in ins) if k in self._where),
                pos)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops[pos] += count(*args, **kwargs, out_val=out)
        if not self.mesh.is_moving and kind != "alloc":
            self.op_bytes[pos] += sum(map(_nbytes, ins)) \
                + sum(map(_nbytes, outs))
        if kind not in ("functional", "alloc"):
            return out        # written into its arguments: nothing new
        for o in outs:
            st = o.untyped_storage()
            key = id(st)
            if key in self._ids:
                continue
            n = st.nbytes()
            self._ids.add(key)
            self._where[key] = pos
            self.live[pos] += n
            if self.live[pos] > self.peak[pos]:
                self.peak[pos] = self.live[pos]
            weakref.finalize(st, self._free, key, pos, n)
        return out


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def argument_bytes(args, n_positions: int) -> List[int]:
    """Bytes per position of the placed arguments; whole tensors count at
    position 0."""
    out = position_bytes(args) or [0] * n_positions
    for x in tree_leaves(args):
        if isinstance(x, torch.Tensor):
            out[0] += _nbytes(x)
    return out


def _tensors(tree):
    for x in tree_leaves(tree):
        if isinstance(x, ShardedTensor):
            yield from x.shards
        elif isinstance(x, torch.Tensor):
            yield x


def meta_mesh(multi_pod: bool, shape: Optional[Tuple[int, ...]] = None
              ) -> Mesh:
    """The production mesh on meta devices, or a mesh of ``shape`` with
    its axis names (("data", "model"), with "pod" first under
    ``multi_pod``): a small one for the reduced cells, whose widths do not
    split 256 ways."""
    if shape is None:
        return make_production_mesh(
            multi_pod=multi_pod,
            devices=["meta"] * (512 if multi_pod else 256))
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, ["meta"] * math.prod(shape))


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             smoke: bool = False, mesh: Optional[Mesh] = None,
             concrete: bool = False, device="cpu",
             check_flops: bool = False) -> dict:
    """Build one cell on ``mesh`` (default: the meta production mesh) and
    run its step once under the counters; returns the record."""
    arch = get_arch(arch_id, smoke=smoke)
    shape = arch.shape(shape_name)
    if mesh is None:
        mesh = meta_mesh(multi_pod)
    rec = {"arch": arch_id, "shape": shape_name, "kind": shape.kind,
           "mesh": "x".join(map(str, mesh.shape))}
    n = mesh.size
    cell = build_cell(arch, shape_name, device=device, smoke=smoke,
                      mesh=mesh, multi_pod=multi_pod, concrete=concrete)
    rec.update(kind=cell.kind, n_chips=n, meta=cell.meta)
    args_b = argument_bytes(cell.args, n)
    arg_ids = {id(t.untyped_storage()) for t in _tensors(cell.args)}

    mesh.reset_bytes()
    tracker = Tracker(mesh)
    counter = (FlopCounterMode(display=False) if check_flops
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with tracker, counter:
        out = cell.step_fn(*cell.args)
    rec["run_s"] = round(time.perf_counter() - t0, 3)
    out_b = [0] * n
    alias = 0
    seen = set()
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        if id(st) in arg_ids:
            alias += st.nbytes()
    out_b = list(tracker.live)      # what the step made and still holds
    del out

    peak = [a + p for a, p in zip(args_b, tracker.peak)]
    busiest = max(range(n), key=lambda p: peak[p])
    rec["memory"] = {
        "argument_bytes": args_b[busiest],
        "output_bytes": out_b[busiest],
        "temp_bytes": max(tracker.peak[busiest] - out_b[busiest], 0),
        "alias_bytes": alias,
        "peak_per_chip_gb": round(peak[busiest] / 1e9, 3),
        "peak_position": busiest,
    }
    f_chip = float(max(tracker.flops))
    b_chip = float(max(tracker.op_bytes))
    rec["cost"] = {"flops_per_chip": f_chip, "bytes_per_chip": b_chip,
                   "flops_total": float(sum(tracker.flops)),
                   "replayed_calls": tracker.replayed}
    if check_flops:
        total = counter.get_total_flops()
        rec["cost"]["flop_counter_total"] = float(total)
        if tracker.replayed == 0 and sum(tracker.flops) != total:
            raise RuntimeError(f"FLOPs charged to positions "
                               f"({sum(tracker.flops)}) differ from "
                               f"FlopCounterMode's total ({total})")
    coll = {k: int(v) for k, v in sorted(mesh.bytes.items())}
    received = [int(mesh.received.get(p, 0)) for p in range(n)]
    rec["collectives"] = coll
    rec["collective_bytes_total"] = float(sum(coll.values()))
    rec["collective_bytes_per_chip"] = float(max(received))
    rec["per_chip"] = PER_CHIP
    rec["per_position"] = {
        "flops": tracker.flops, "op_bytes": tracker.op_bytes,
        "argument_bytes": args_b, "temp_peak_bytes": tracker.peak,
        "output_bytes": out_b, "collective_bytes_received": received}

    mem_an = analytic_memory_bytes(arch, shape, cell.meta)
    rec["analytic_memory_bytes_total"] = mem_an
    mf = analytic_model_flops(arch, shape, cell.meta)
    exec_flops = (mf * remat_multiplier(arch, cell.kind)) if mf else None
    rec["roofline"] = roofline_terms(
        f_chip, b_chip, rec["collective_bytes_per_chip"],
        analytic_mem_per_chip=(mem_an / n) if mem_an else None,
        analytic_flops_per_chip=(exec_flops / n) if exec_flops else None)
    if mf:
        rec["model_flops_total"] = mf
        rec["model_flops_ratio"] = round(mf / exec_flops, 4)
        rec["counted_flops_total"] = float(sum(tracker.flops))
    return rec


def cell_list():
    """The reference's 44 cells: 40 assigned plus the paper's own RWR
    data plane at the Table III sizes (arch igpm-pem)."""
    cells = []
    for arch_id in list_archs():
        arch = get_arch(arch_id)
        for s in arch.shapes:
            cells.append((arch_id, s.name))
    return cells


def _job(task):
    arch_id, shape_name, mp, smoke, shape, out = task
    try:
        rec = run_cell(arch_id, shape_name, multi_pod=mp, smoke=smoke,
                       mesh=meta_mesh(mp, shape))
        Path(out).write_text(json.dumps(rec, indent=1))
        return task, rec, None
    except Exception as e:   # reported by main, which exits 1
        return task, None, f"{e}\n{traceback.format_exc()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs and the cells' reduced "
                         "dims (tests)")
    ap.add_argument("--mesh", default=None,
                    help="a meta mesh of this shape, e.g. 2x2 (2x2x2 with "
                         "--multi-pod), in place of the production mesh "
                         "(for --smoke)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run in this many processes at once")
    ap.add_argument("--out", default=str(REPORT_DIR))
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    shape = (tuple(int(n) for n in args.mesh.split("x"))
             if args.mesh else None)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = cell_list() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    tasks = []

    def name(mp):
        return "x".join(map(str, shape)) if shape else mesh_name(mp)

    for arch_id, shape_name in todo:
        for mp in meshes:
            tag = f"{arch_id}_{shape_name}_{name(mp)}"
            out = out_dir / f"{tag}.json"
            if out.exists() and not args.force:
                print(f"[cached] {tag}")
                continue
            tasks.append((arch_id, shape_name, mp, args.smoke, shape,
                          str(out)))

    failures = []

    def report(task, rec, err):
        tag = f"{task[0]}_{task[1]}_{name(task[2])}"
        if err is not None:
            failures.append((tag, err))
            print(f"[dryrun] {tag}: FAIL {err}", flush=True)
            return
        r = rec["roofline"]
        print(f"[dryrun] {tag}: ok run={rec['run_s']}s "
              f"compute={r['compute_s']:.4g}s mem={r['memory_s']:.4g}s "
              f"coll={r['collective_s']:.4g}s dominant={r['dominant']} "
              f"peak={rec['memory']['peak_per_chip_gb']} GB "
              f"collectives={rec['collectives']}", flush=True)

    if args.jobs > 1 and len(tasks) > 1:
        import multiprocessing as mp_
        with mp_.get_context("spawn").Pool(args.jobs) as pool:
            for res in pool.imap_unordered(_job, tasks):
                report(*res)
    else:
        for task in tasks:
            print(f"[dryrun] {task[0]}_{task[1]}_{name(task[2])} ...",
                  flush=True)
            report(*_job(task))

    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err.splitlines()[0][:200]}")
        return 1
    print(f"\n{len(tasks)} dry-run cells ran OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
