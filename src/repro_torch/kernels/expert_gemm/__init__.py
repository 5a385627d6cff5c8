"""Grouped per-expert GEMM: CUDA kernels (``csrc/``) + plain version."""

from repro_torch.kernels.expert_gemm.ops import (LAUNCHES, expert_gemm,
                                                 gemm_variant,
                                                 reset_launch_counts)

__all__ = ["expert_gemm", "gemm_variant", "LAUNCHES", "reset_launch_counts"]
