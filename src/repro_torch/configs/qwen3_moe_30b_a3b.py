"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4, head_dim=128)
d_ff=768 (per expert) vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]. Values match the JAX package's
``repro.configs.qwen3_moe_30b_a3b``."""

from repro_torch.config.base import (LM_SHAPES, ArchConfig, MoEConfig,
                                     TransformerConfig)

SOURCE = "hf:Qwen/Qwen3-30B-A3B; hf"

FULL = TransformerConfig(
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=6144, vocab_size=151936, qkv_bias=False, rope_theta=1_000_000.0,
    tie_embeddings=False, dtype="bfloat16", remat="full",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                  moe_shard="expert"))

SMOKE = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=512, dtype="float32", remat="none",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, moe_shard="expert"))


def full() -> ArchConfig:
    return ArchConfig("qwen3-moe-30b-a3b", "lm", FULL, LM_SHAPES,
                      source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("qwen3-moe-30b-a3b", "lm", SMOKE, LM_SHAPES,
                      source=SOURCE)
