"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=11008 vocab=102400; llama-arch. [arXiv:2401.02954; hf]. Values match
the JAX package's ``repro.configs.deepseek_7b``."""

from repro_torch.config.base import LM_SHAPES, ArchConfig, TransformerConfig

SOURCE = "arXiv:2401.02954; hf"

FULL = TransformerConfig(
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=102400, qkv_bias=False, rope_theta=10000.0,
    tie_embeddings=False, dtype="bfloat16", remat="full")

SMOKE = TransformerConfig(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, qkv_bias=False, dtype="float32", remat="none")


def full() -> ArchConfig:
    return ArchConfig("deepseek-7b", "lm", FULL, LM_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("deepseek-7b", "lm", SMOKE, LM_SHAPES, source=SOURCE)
