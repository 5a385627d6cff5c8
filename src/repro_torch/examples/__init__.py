"""The JAX package's three ``examples/`` entry points on the port, each a
module so that tests and ``chip_smoke.py`` import it:

  quickstart            Batch, Inc and Adaptive (IGPM-PEM) on a stream twin
  dynamic_gnn_serving   PEM-gated MeshGraphNet re-embedding over a stream
  train_lm              the LM trainer with checkpoint and restart

Run one as ``PYTHONPATH=src python -m repro_torch.examples.<name>``; each
runs on the card unless given ``--device cpu``.
"""
