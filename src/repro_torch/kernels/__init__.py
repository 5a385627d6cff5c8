"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

The ELL sweeps (`spmv_ell`), flash attention (`flash_attention`) and the
grouped expert GEMM (`expert_gemm`), forward and, for the LM kernels,
backward; `build` compiles all eight sources,
and `measure` times them on a card.
"""

# devices whose tensors a wrapper hands to its kernel's plain version: the
# CPU's, and meta tensors (shapes only, as a dry run counts them)
PLAIN_DEVICES = ("cpu", "meta")
