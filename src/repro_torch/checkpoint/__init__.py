"""Checkpoint substrate: atomic save/restore in the JAX package's format,
and the manager."""
from repro_torch.checkpoint.ckpt import (checkpoint_meta, checkpoint_step,
                                         restore_pytree, save_pytree)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["checkpoint_meta", "checkpoint_step", "restore_pytree",
           "save_pytree", "CheckpointManager"]
