"""bst [recsys] — embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256 interaction=transformer-seq; Behavior Sequence Transformer
(Alibaba). [arXiv:1905.06874; paper]. Values match the JAX package's
``repro.configs.bst``."""

from repro_torch.config.base import BST_SHAPES, ArchConfig, BSTConfig

SOURCE = "arXiv:1905.06874; paper"

FULL = BSTConfig(embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
                 mlp_dims=(1024, 512, 256), n_items=4_194_304,
                 n_cates=16_384, n_user_feats=8, user_feat_vocab=65_536)

SMOKE = BSTConfig(embed_dim=8, seq_len=8, n_blocks=1, n_heads=2,
                  mlp_dims=(32, 16), n_items=1024, n_cates=64,
                  n_user_feats=4, user_feat_vocab=128)


def full() -> ArchConfig:
    return ArchConfig("bst", "recsys", FULL, BST_SHAPES, source=SOURCE)


def smoke() -> ArchConfig:
    return ArchConfig("bst", "recsys", SMOKE, BST_SHAPES, source=SOURCE)
