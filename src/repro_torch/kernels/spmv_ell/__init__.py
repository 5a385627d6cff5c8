"""ELL SpMM and reach sweeps: CUDA kernels (``csrc/``) + plain versions."""

from repro_torch.kernels.spmv_ell.ops import (LAUNCHES, ell_reach,
                                              ell_reach_graph,
                                              ell_reach_kernel, ell_spmm,
                                              ell_spmm_graph, ell_spmm_kernel,
                                              reset_launch_counts)

__all__ = ["ell_spmm", "ell_reach", "ell_spmm_kernel", "ell_spmm_graph",
           "ell_reach_kernel", "ell_reach_graph", "LAUNCHES",
           "reset_launch_counts"]
