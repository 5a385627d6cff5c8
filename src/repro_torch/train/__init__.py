"""Training: the train state, the train step (forward, backward, AdamW)
and the loop with checkpoints (PyTorch port of ``repro.train``)."""

from repro_torch.train.state import TrainState, make_train_step, new_train_state

__all__ = ["TrainState", "make_train_step", "new_train_state"]
