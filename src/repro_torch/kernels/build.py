"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source (``<package>/csrc/*.cu``) has a plain C interface and
compiles on its own, for ``sm_90a``, into a shared library under ``build/``
next to this file (git-ignored). The library's name carries a hash of its
source, of the headers it includes (``csrc/hopper.cuh``, shared by the
TMA + wgmma kernels; ``flash_attention/csrc/flash_mma.cuh``, shared by the
first flash kernels) and of the flags, so an edited source or header
builds anew and an unchanged one is reused. All missing libraries are
compiled at once, one ``nvcc`` process per source, started together; the
first use of any kernel builds them all, under one lock, so concurrent
first calls (the engine's per-bucket executor pool) build and load each
library once.
The TMA kernels find the driver's ``cuTensorMapEncodeTiled`` at run time
through ``cudaGetDriverEntryPoint``, so no library links against libcuda.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_HERE = Path(__file__).resolve().parent
INCLUDE_DIR = _HERE / "csrc"  # headers shared by several sources
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel name → (source under this directory, exported C function, argtypes)
KERNELS = {
    # cols, vals, mask, perm, row_ptr, x, y, n, d, K, variant, stream
    "ell_spmm": ("spmv_ell/csrc/ell_spmm.cu", "ell_spmm_f32",
                 [_P] * 7 + [_I] * 4 + [_P]),
    # cols, mask, perm, row_ptr, x, y, n, d, K, variant, stream
    "ell_reach": ("spmv_ell/csrc/ell_reach.cu", "ell_reach_f32",
                  [_P] * 6 + [_I] * 4 + [_P]),
    # q, k, v, o, lse, B, Sq, Sk, H, KV, hd, q_offset, causal, bf16, stream
    "flash_attention_fwd": (
        "flash_attention/csrc/flash_attention_fwd.cu", "flash_attention_fwd",
        [_P] * 5 + [_I] * 9 + [_P]),
    # q, k, v, o, lse, B, Sq, Sk, H, KV, hd, q_offset, causal, stream
    "flash_attention_fwd_wgmma": (
        "flash_attention/csrc/flash_attention_fwd_wgmma.cu",
        "flash_attention_fwd_wgmma", [_P] * 5 + [_I] * 8 + [_P]),
    # q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,
    # q_offset, causal, bf16, stream
    "flash_attention_bwd": (
        "flash_attention/csrc/flash_attention_bwd.cu", "flash_attention_bwd",
        [_P] * 9 + [_I] * 9 + [_P]),
    # q, k, v, o, dout, lse, dq, dk, dv, stats, partials, B, Sq, Sk, H,
    # KV, hd, q_offset, causal, stream
    "flash_attention_bwd_wgmma": (
        "flash_attention/csrc/flash_attention_bwd_wgmma.cu",
        "flash_attention_bwd_wgmma", [_P] * 11 + [_I] * 8 + [_P]),
    # x, w, y, N, E, C, d, f, bf16, stream
    "expert_gemm": ("expert_gemm/csrc/expert_gemm.cu", "expert_gemm",
                    [_P] * 3 + [_I] * 6 + [_P]),
    # x, w, y, N, E, C, d, f, variant (0 tiles, 1 skinny), stream
    "expert_gemm_wgmma": ("expert_gemm/csrc/expert_gemm_wgmma.cu",
                          "expert_gemm_wgmma", [_P] * 3 + [_I] * 6 + [_P]),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# held around the build and the dlopen of a first call: without it two
# threads could both run nvcc into one target, or both load a library
_BUILD_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}  # name → nvcc's output (ptxas register use)


def build_dir() -> Path:
    return _HERE / "build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels build only where "
                       "the CUDA toolkit is installed")


def _source(name: str) -> Path:
    return _HERE / KERNELS[name][0]


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path) -> List[Path]:
    """``path`` and every header it includes with ``#include "..."``,
    found beside the including file or in :data:`INCLUDE_DIR`."""
    seen = [path]
    for p in seen:
        for m in _INCLUDE.finditer(p.read_bytes()):
            name = m.group(1).decode()
            for where in (p.parent, INCLUDE_DIR):
                hit = (where / name).resolve()
                if hit.exists():
                    if hit not in seen:
                        seen.append(hit)
                    break
            else:
                raise FileNotFoundError(f"{p}: included {name} not found")
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(_source(name)):
        h.update(p.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, in parallel. Returns seconds per compiled name
    (empty when everything was built already). Raises on a failed build."""
    names = list(KERNELS if names is None else names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    times = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def kernel(name: str):
    """The C entry point of kernel ``name``; the first call builds every
    missing library of :data:`KERNELS` (so one use builds them all). Safe
    under concurrent first calls: the build and the load run under one
    lock, and a thread that waited on it finds the library loaded."""
    lib = _LIBS.get(name)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build()
                lib = ctypes.CDLL(str(_target(name)))
                _, fn_name, argtypes = KERNELS[name]
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _LIBS[name] = lib
    return getattr(lib, KERNELS[name][1])
