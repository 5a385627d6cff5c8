"""Atomic, optionally asynchronous checkpoints of a tree of host arrays.

Layout per step, the JAX package's (``repro.checkpoint``), so a directory
written by either package restores in the other:

  <dir>/step_<n>.tmp/...   while writing
  <dir>/step_<n>/
    index.msgpack          leaf keys, shapes, dtypes
    arrays.npz             one entry per leaf, named by its key

A tree is nested dicts, lists, tuples and named tuples with numpy arrays,
scalars or CPU-copyable tensors at the leaves; ``None`` holds no leaf. A
leaf's key joins the dict keys (in sorted order), sequence indices and
named-tuple field names on its path with ``/`` — the JAX package's
``jax.tree_util`` paths.

Contract:
  * atomic commit — the directory is renamed only after fsync'd writes, so
    a crash mid-save never corrupts the latest checkpoint;
  * ``restore()`` picks the newest COMMITTED step (a half-written ``.tmp``
    is ignored);
  * keep-N garbage collection;
  * async mode writes on one thread (one save in flight; the next save
    joins the previous).

``index.msgpack`` is written by a small MessagePack encoder of the subset
the index uses (maps, arrays, str, non-negative int); restoring reads only
``arrays.npz``.

Dtypes follow the JAX package: a leaf that ``arrays.npz`` cannot hold
(bfloat16, fp8) is widened to float32 on disk, and ``restore`` casts every
stored array to the dtype of the matching ``like`` leaf with numpy's
unsafe casting (float → int truncates toward zero). A bfloat16 ``like``
leaf, which numpy cannot hold, comes back as a CPU tensor.
"""

from __future__ import annotations

import os
import re
import shutil
import struct
import threading
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

_NPZ_SAFE = {"float16", "float32", "float64", "int8", "int16", "int32",
             "int64", "uint8", "uint16", "uint32", "uint64", "bool"}


# -- MessagePack, the subset of the index -------------------------------------

def _pack_len(n: int, fix_base: int, fix_max: int, wide: Tuple[int, ...]
              ) -> bytes:
    if n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, top in zip(wide, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def packb(obj: Any) -> bytes:
    """MessagePack bytes of ``obj`` — maps with str keys, lists, str and
    non-negative int only, each in its shortest form (the bytes
    ``msgpack.packb`` gives for the same object)."""
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack subset: no {type(obj).__name__}")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError("msgpack subset: no negative int")
        if obj < 0x80:
            return bytes([obj])
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if obj <= top:
                return bytes([code]) + struct.pack(fmt, obj)
        raise ValueError(f"msgpack int {obj} too large")
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (list, tuple)):
        return (_pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD))
                + b"".join(packb(x) for x in obj))
    if isinstance(obj, dict):
        return (_pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF))
                + b"".join(packb(k) + packb(v) for k, v in obj.items()))
    raise TypeError(f"msgpack subset: no {type(obj).__name__}")


# -- tree paths ----------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in flattening order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, child in kids:
        out.extend(_leaf_paths(child, f"{prefix}/{k}" if prefix else k))
    return out


def _numpy_dtype(leaf) -> Optional[np.dtype]:
    """The numpy dtype of a leaf, or None for a tensor dtype numpy cannot
    hold (bfloat16, fp8)."""
    if isinstance(leaf, torch.Tensor):
        try:
            return torch.empty(0, dtype=leaf.dtype).numpy().dtype
        except TypeError:
            return None
    return np.asarray(leaf).dtype


def _host_array(leaf) -> np.ndarray:
    """The array stored for a leaf: float32 where ``arrays.npz`` cannot
    hold its dtype (the reference's ``_storable``)."""
    dt = _numpy_dtype(leaf)
    if isinstance(leaf, torch.Tensor):
        # a copy even on the CPU: an async save must not see later writes
        t = leaf.detach()
        if dt is None or dt.name not in _NPZ_SAFE:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    a = np.asarray(leaf)
    return a if dt.name in _NPZ_SAFE else a.astype(np.float32)


def _cast(arr: np.ndarray, leaf):
    """``arr`` in the dtype of the ``like`` leaf (unchanged when equal)."""
    want = _numpy_dtype(leaf)
    if want is None:   # bf16 and the like: a tensor, as numpy has no dtype
        return torch.from_numpy(arr).to(leaf.dtype)
    return arr if arr.dtype == want else arr.astype(want)


def _flatten(tree: Any) -> List[Tuple[str, np.ndarray]]:
    return [(k, _host_array(leaf)) for k, leaf in _leaf_paths(tree)]


def _rebuild(like: Any, leaves: Iterator[np.ndarray]) -> Any:
    """``like``'s structure with its leaves taken in flattening order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state: Any) -> None:
        flat = _flatten(state)  # device→host copy happens on the caller
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: List[Tuple[str, np.ndarray]]) -> None:
        tmp = self.dir / f"step_{step:012d}.tmp"
        final = self.dir / f"step_{step:012d}"
        if final.exists():
            return  # step already committed — save() is idempotent per step
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {
            "step": step,
            "leaves": [{"key": k, "shape": list(a.shape),
                        "dtype": str(a.dtype)} for k, a in flat],
        }
        with open(tmp / "index.msgpack", "wb") as f:
            f.write(packb(index))
            f.flush()
            os.fsync(f.fileno())
        np.savez(tmp / "arrays.npz", **{k: a for k, a in flat})
        with open(tmp / "arrays.npz", "rb+") as f:
            os.fsync(f.fileno())
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "index.msgpack").exists():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return step

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure of ``like`` (values replaced by numpy
        arrays of the dtype of ``like``'s leaves; CPU tensors for leaves
        numpy cannot hold)."""
        step = self._resolve(step)
        path = self.dir / f"step_{step:012d}"
        with np.load(path / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        leaves = []
        for key, leaf in _leaf_paths(like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            leaves.append(_cast(arrays[key], leaf))
        return _rebuild(like, iter(leaves)), step
