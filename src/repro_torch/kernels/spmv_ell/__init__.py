"""ELL SpMM and reach sweeps: CUDA kernels (``csrc/``) + plain versions."""

from repro_torch.kernels.spmv_ell.ops import (LAUNCHES, ell_reach, ell_spmm,
                                              reset_launch_counts)

__all__ = ["ell_spmm", "ell_reach", "LAUNCHES", "reset_launch_counts"]
