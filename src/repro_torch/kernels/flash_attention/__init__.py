"""Causal GQA flash attention: CUDA kernels (``csrc/``) + plain versions,
forward and backward."""

from repro_torch.kernels.flash_attention.ops import (LAUNCHES, FlashAttention,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_bwd_variant,
                                                     flash_variant,
                                                     reset_launch_counts)

__all__ = ["flash_attention", "flash_attention_bwd", "FlashAttention",
           "flash_variant", "flash_bwd_variant", "LAUNCHES",
           "reset_launch_counts"]
