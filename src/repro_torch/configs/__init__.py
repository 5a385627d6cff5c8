"""Configurations ported so far: the paper's system (``igpm_paper``) and
the LMs qwen3-moe-30b-a3b, smollm-135m, deepseek-7b, qwen2-72b and
dbrx-132b (one module each). ``repro_torch.config.registry`` resolves
``--arch`` ids to them."""
