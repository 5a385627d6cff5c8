"""Grouped per-expert GEMM: CUDA kernel (``csrc/``) + plain version."""

from repro_torch.kernels.expert_gemm.ops import (LAUNCHES, expert_gemm,
                                                 reset_launch_counts)

__all__ = ["expert_gemm", "LAUNCHES", "reset_launch_counts"]
