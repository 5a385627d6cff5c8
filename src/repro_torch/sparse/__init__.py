"""Sparse layouts (ELL)."""
