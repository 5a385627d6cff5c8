"""Grouped per-expert GEMM: CUDA kernels (``csrc/``) + plain version, with a
gradient (:class:`ExpertGemm`) built on the same kernels."""

from repro_torch.kernels.expert_gemm.ops import (LAUNCHES, ExpertGemm,
                                                 expert_gemm, gemm_variant,
                                                 reset_launch_counts)

__all__ = ["expert_gemm", "ExpertGemm", "gemm_variant", "LAUNCHES",
           "reset_launch_counts"]
