"""npz checkpoints of tensor trees, in the JAX package's file layout."""
from .ckpt import (CheckpointError, checkpoint_path, latest_checkpoint,
                   leaf_paths, load_metadata, restore_checkpoint,
                   save_checkpoint, verify_checkpoint)

__all__ = ["CheckpointError", "checkpoint_path", "save_checkpoint",
           "restore_checkpoint", "latest_checkpoint", "leaf_paths",
           "load_metadata", "verify_checkpoint"]
