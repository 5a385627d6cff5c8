"""Fault tolerance for training: the straggler monitor (PyTorch port of
``repro.distrib.fault``). The GSPMD sharding rules, ``ElasticPlan`` and
``reshard`` wait for the distributed layers (ROADMAP item 13.5)."""
