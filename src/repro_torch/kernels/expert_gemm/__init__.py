"""Grouped per-expert GEMM: CUDA kernels (``csrc/``) + plain versions, with
a gradient (:class:`ExpertGemm`) whose two products have kernels of their
own (``expert_gemm_dx``, ``expert_gemm_dw``)."""

from repro_torch.kernels.expert_gemm.ops import (LAUNCHES, ExpertGemm,
                                                 expert_gemm, expert_gemm_dw,
                                                 expert_gemm_dx,
                                                 gemm_bwd_variant,
                                                 gemm_variant,
                                                 reset_launch_counts)

__all__ = ["expert_gemm", "expert_gemm_dx", "expert_gemm_dw", "ExpertGemm",
           "gemm_variant", "gemm_bwd_variant", "LAUNCHES",
           "reset_launch_counts"]
