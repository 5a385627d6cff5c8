"""Causal GQA flash attention: CUDA kernel (``csrc/``) + plain version."""

from repro_torch.kernels.flash_attention.ops import (LAUNCHES,
                                                     flash_attention,
                                                     reset_launch_counts)

__all__ = ["flash_attention", "LAUNCHES", "reset_launch_counts"]
