"""Public wrappers of the two ELL kernels.

``ell_spmm`` (the RWR sweep's sparse product) and ``ell_reach`` (the G-Ray
bridge's BFS frontier step) check their inputs, then:

* on CUDA tensors launch the hand-written kernel (``csrc/*.cu``, built on
  first use by :mod:`repro_torch.kernels.build`) on the current stream, or
  raise;
* on CPU tensors run the plain version from :mod:`.ref`.

Each keeps a plain-integer launch count in :data:`LAUNCHES`, bumped only
where its kernel is launched (under a lock: the engine's executor pool
launches from several threads), so a run can show that the main path went
through the kernels.

:func:`ell_variant` picks, by shape alone, which variant of either kernel
takes a call (lanes across K for d < 32, one walk per vertex with float4
or scalar gathers for wider d).

Both kernels walk a vertex's rows through the row index of
:func:`~repro_torch.sparse.ell.build_row_index`; callers that sweep one
mirror many times pass ``index=`` (``EllGraph.row_index()``) so it is built
once. ``ell_spmm_graph`` and ``ell_reach_graph`` take an
:class:`~repro_torch.sparse.ell.EllGraph` and pass its cached index;
``ell_spmm_kernel`` and ``ell_reach_kernel`` keep the JAX package's
signatures of the same names.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.spmv_ell.ref import ell_reach_ref, ell_spmm_ref
from repro_torch.sparse.ell import EllGraph, build_row_index

LAUNCHES: Dict[str, int] = {"ell_spmm": 0, "ell_reach": 0}
_COUNT_LOCK = threading.Lock()
# the `variant` argument of both C entry points (csrc/ell_spmm.cu,
# csrc/ell_reach.cu)
VARIANTS = {"small": 0, "wide_vec4": 1, "wide_scalar": 2}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name: str) -> None:
    """One launch of kernel ``name`` (a read-modify-write, so locked)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _check(name: str, cols: torch.Tensor, mask: torch.Tensor,
           row_ids: torch.Tensor, x: torch.Tensor, n: int,
           vals: Optional[torch.Tensor] = None) -> None:
    dev = cols.device
    tensors = {"cols": cols, "mask": mask, "row_ids": row_ids, "x": x}
    if vals is not None:
        tensors["vals"] = vals
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, cols on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise ValueError(f"{name}: cols must be int32[R, K], got "
                         f"{cols.dtype}{tuple(cols.shape)}")
    if mask.dtype != torch.bool or mask.shape != cols.shape:
        raise ValueError(f"{name}: mask must be bool{tuple(cols.shape)}")
    if vals is not None and (vals.dtype != torch.float32
                             or vals.shape != cols.shape):
        raise ValueError(f"{name}: vals must be float32{tuple(cols.shape)}")
    if row_ids.dtype != torch.int32 or row_ids.shape != cols.shape[:1]:
        raise ValueError(f"{name}: row_ids must be int32[{cols.shape[0]}]")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32[n, d], got "
                         f"{x.dtype}{tuple(x.shape)}")
    if n < 0:
        raise ValueError(f"{name}: n must be >= 0")


def _cuda_args(mask: torch.Tensor, row_ids: torch.Tensor, n: int,
               index: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    if mask.device.type != "cuda":
        raise RuntimeError(f"ELL kernels run on CUDA or CPU tensors, not "
                           f"{mask.device}")
    if index is None:
        index = build_row_index(mask, row_ids, n)
    perm, row_ptr = index
    if (perm.dtype != torch.int32 or row_ptr.dtype != torch.int32
            or row_ptr.shape != (n + 1,) or perm.device != mask.device):
        raise ValueError("row index must be (int32[R_live], int32[n+1]) on "
                         "the tiles' device")
    return perm, row_ptr


def ell_variant(d: int, x_ptr: int) -> str:
    """The variant of either ELL kernel (SpMM or reach) for x of width
    ``d`` at address ``x_ptr``: lanes across K below 32 columns, else one
    walk of each vertex's rows with float4 gathers where d % 4 == 0 and x
    is 16-byte aligned, scalar gathers otherwise."""
    if d < 32:
        return "small"
    return "wide_vec4" if d % 4 == 0 and x_ptr % 16 == 0 else "wide_scalar"


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
             row_ids: torch.Tensor, x: torch.Tensor, n: int,
             index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> torch.Tensor:
    """``y = A_ell @ x``: (R, K) ELL tile × (n_x, d) dense → (n, d) f32."""
    _check("ell_spmm", cols, mask, row_ids, x, n, vals=vals)
    if cols.device.type == "cpu":
        return ell_spmm_ref(cols, vals, mask, row_ids, x, n)
    perm, row_ptr = _cuda_args(mask, row_ids, n, index)
    d = x.shape[1]
    y = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return y
    variant = VARIANTS[ell_variant(d, x.data_ptr())]
    fn = build.kernel("ell_spmm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(cols.data_ptr(), vals.data_ptr(), mask.data_ptr(),
                perm.data_ptr(), row_ptr.data_ptr(), x.data_ptr(),
                y.data_ptr(), n, d, cols.shape[1], variant, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm kernel launch failed (cudaError {rc})")
    _count("ell_spmm")
    return y


def ell_reach(cols: torch.Tensor, mask: torch.Tensor, row_ids: torch.Tensor,
              x: torch.Tensor, n: int,
              index: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """``y[v] = max(0, max_{u in N(v)} x[u])`` for indicator ``x ∈ [0,1]``:
    one bounded-BFS frontier sweep, (n_x, d) → (n, d). Vertices with no
    live in-arcs get 0."""
    _check("ell_reach", cols, mask, row_ids, x, n)
    if cols.device.type == "cpu":
        return ell_reach_ref(cols, mask, row_ids, x, n)
    perm, row_ptr = _cuda_args(mask, row_ids, n, index)
    d = x.shape[1]
    y = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return y
    variant = VARIANTS[ell_variant(d, x.data_ptr())]
    fn = build.kernel("ell_reach")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(cols.data_ptr(), mask.data_ptr(), perm.data_ptr(),
                row_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), n, d,
                cols.shape[1], variant, stream)
    if rc != 0:
        raise RuntimeError(f"ell_reach kernel launch failed (cudaError {rc})")
    _count("ell_reach")
    return y


def ell_spmm_kernel(cols: torch.Tensor, vals: torch.Tensor,
                    mask: torch.Tensor, row_ids: torch.Tensor,
                    x: torch.Tensor, n: int) -> torch.Tensor:
    """``y = A_ell @ x``: (n, d) → (n, d), the JAX package's
    ``ell_spmm_kernel``. There it is two phases — the Pallas kernel's
    per-row partials, then a segment sum over ``row_ids`` in XLA — with a
    Pallas tile size ``block_rows`` and RHS blocks sized for VMEM. The CUDA
    kernel fuses both phases (each vertex's rows are walked and summed in
    registers, so no row partial is ever stored) and picks its tiling by
    variant, so this form has neither split nor tile argument; the
    unreduced partials are :func:`.ref.ell_row_partials_ref`."""
    return ell_spmm(cols, vals, mask, row_ids, x, n)


def ell_spmm_graph(g: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """``ell_spmm`` over an :class:`EllGraph`, with its cached row index on
    the card."""
    index = g.row_index() if g.cols.device.type == "cuda" else None
    return ell_spmm(g.cols, g.vals, g.mask, g.row_ids, x, g.n, index=index)


def ell_reach_kernel(cols: torch.Tensor, mask: torch.Tensor,
                     row_ids: torch.Tensor, x: torch.Tensor,
                     n: int) -> torch.Tensor:
    """``y[v] = max(0, max_{u in N(v)} x[u])``: (n, d) → (n, d), the JAX
    package's ``ell_reach_kernel``. As :func:`ell_spmm_kernel`, the CUDA
    kernel fuses the per-row maxima with the segment max over ``row_ids``
    and has no ``block_rows`` tile argument; the unreduced maxima are
    :func:`.ref.ell_row_maxima_ref`."""
    return ell_reach(cols, mask, row_ids, x, n)


def ell_reach_graph(g: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """``ell_reach`` over an :class:`EllGraph`, with its cached row index on
    the card."""
    index = g.row_index() if g.cols.device.type == "cuda" else None
    return ell_reach(g.cols, g.mask, g.row_ids, x, g.n, index=index)
