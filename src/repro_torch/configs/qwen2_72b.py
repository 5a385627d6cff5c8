"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; GQA with QKV bias. [arXiv:2407.10671; hf]. Values match the
JAX package's ``repro.configs.qwen2_72b``."""

from repro_torch.config.base import LM_SHAPES, ArchConfig, TransformerConfig

SOURCE = "arXiv:2407.10671; hf"

FULL = TransformerConfig(
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=False, dtype="bfloat16", remat="full")

SMOKE = TransformerConfig(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
    vocab_size=512, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=False, dtype="float32", remat="none")


def full() -> ArchConfig:
    return ArchConfig("qwen2-72b", "lm", FULL, LM_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("qwen2-72b", "lm", SMOKE, LM_SHAPES, source=SOURCE)
