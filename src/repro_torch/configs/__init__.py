"""Configurations ported so far: the paper's system (``igpm_paper``) and
qwen3-moe-30b-a3b (``qwen3_moe_30b_a3b``). ``repro_torch.config.registry``
resolves ``--arch`` ids to them."""
