"""repro_torch — the PyTorch/CUDA port of IGPM (incremental G-Ray matching
with partial execution, Kanezashi et al. 2018) for one NVIDIA H100.

The package mirrors the subpackage and module names of the JAX package
``repro`` so every module has a named counterpart to be checked against; it
imports neither JAX nor ``repro``. Entry points (``MatchServer``,
``Engine``) run on ``device="cuda"`` unless the caller asks for the CPU,
where the two hand-written ELL kernels fall back to their plain versions.
"""

__version__ = "0.1.0"
