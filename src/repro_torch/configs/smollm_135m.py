"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152; llama-arch small, tied embeddings.
[hf:HuggingFaceTB/SmolLM-135M; hf]. Values match the JAX package's
``repro.configs.smollm_135m``."""

from repro_torch.config.base import LM_SHAPES, ArchConfig, TransformerConfig

SOURCE = "hf:HuggingFaceTB/SmolLM-135M; hf"

FULL = TransformerConfig(
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49152, qkv_bias=False, rope_theta=10000.0,
    tie_embeddings=True, dtype="bfloat16", remat="dots")

SMOKE = TransformerConfig(
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_ff=192,
    vocab_size=512, qkv_bias=False, tie_embeddings=True, dtype="float32",
    remat="none")


def full() -> ArchConfig:
    return ArchConfig("smollm-135m", "lm", FULL, LM_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("smollm-135m", "lm", SMOKE, LM_SHAPES, source=SOURCE)
