"""Synthetic temporal graph streams."""
