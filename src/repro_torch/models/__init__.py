"""Transformer LM (dense and MoE) for serving and training: ``layers``,
``moe``, ``transformer`` — the PyTorch port of ``repro.models``' LM side."""

from repro_torch.models import layers
from repro_torch.models.transformer import TransformerLM

__all__ = ["layers", "TransformerLM"]
