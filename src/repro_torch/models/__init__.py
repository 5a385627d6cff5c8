"""Transformer LM serving (dense and MoE): ``layers``, ``moe``,
``transformer`` — the PyTorch port of ``repro.models``' LM side."""
