from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
