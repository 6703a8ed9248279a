"""Sharded checkpoints in the JAX package's on-disk format: ``ckpt`` does
the file I/O (save / restore / prune)."""

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import (IncompleteCheckpointError,
                                         RestorePolicy, ShardChecksumError,
                                         ShardReadError)

__all__ = ["ckpt", "IncompleteCheckpointError", "RestorePolicy",
           "ShardChecksumError", "ShardReadError"]
