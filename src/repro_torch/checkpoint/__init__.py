"""Checkpoints (port of ``repro.checkpoint``): the msgpack tensor store,
byte-compatible with the reference's, and its ``CheckpointManager``."""
from repro_torch.checkpoint.store import (CheckpointManager, load_checkpoint,
                                          load_flat_checkpoint,
                                          load_train_checkpoint,
                                          save_checkpoint,
                                          save_flat_checkpoint,
                                          save_train_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "save_flat_checkpoint", "load_flat_checkpoint",
           "save_train_checkpoint", "load_train_checkpoint"]
