"""The configurations of every arch of the JAX package's registry: the
paper's system (``igpm_paper``), the LMs qwen3-moe-30b-a3b, smollm-135m,
deepseek-7b, qwen2-72b and dbrx-132b, the GNNs schnet, dimenet,
meshgraphnet and graphcast, and the recommender bst (one module each).
``repro_torch.config.registry`` resolves ``--arch`` ids to them."""
