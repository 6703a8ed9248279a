"""Elastic sharded checkpoints in the JAX package's on-disk format.

``ckpt`` does the file I/O (save / restore / reshard / heal / prune),
``spec.CheckpointSpec`` carries the placement-derived sharding contract,
and ``elastic`` prices writes, heals and bytes-actually-missing recovery
over the wide-area topology.
"""

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import (HealReport,
                                         IncompleteCheckpointError,
                                         RestorePolicy, ShardChecksumError,
                                         ShardReadError)
from repro_torch.checkpoint.elastic import (TransferCost, heal_cost,
                                            recovery_cost, state_layer_bytes,
                                            write_cost)
from repro_torch.checkpoint.spec import CheckpointSpec

__all__ = ["ckpt", "CheckpointSpec", "HealReport",
           "IncompleteCheckpointError", "RestorePolicy",
           "ShardChecksumError", "ShardReadError", "TransferCost",
           "heal_cost", "recovery_cost", "state_layer_bytes", "write_cost"]
