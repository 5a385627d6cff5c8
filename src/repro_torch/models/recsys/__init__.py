"""The BST recommender (PyTorch port of ``repro.models.recsys``)."""

from repro_torch.models.recsys.bst import BST, BSTInputs

__all__ = ["BST", "BSTInputs"]
