"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert)
vocab=100352, MoE 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]. Values match the JAX package's
``repro.configs.dbrx_132b``."""

from repro_torch.config.base import (LM_SHAPES, ArchConfig, MoEConfig,
                                     TransformerConfig)

SOURCE = "hf:databricks/dbrx-base; unverified"

FULL = TransformerConfig(
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, qkv_bias=False, rope_theta=500_000.0,
    tie_embeddings=False, dtype="bfloat16", remat="full",
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752,
                  moe_shard="expert"))

SMOKE = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, dtype="float32", remat="none",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, moe_shard="expert"))


def full() -> ArchConfig:
    return ArchConfig("dbrx-132b", "lm", FULL, LM_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("dbrx-132b", "lm", SMOKE, LM_SHAPES, source=SOURCE)
