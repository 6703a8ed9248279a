"""Stage boundary math: the ONE place it lives.

The pipeline executor (:mod:`repro_torch.distributed.pipeline`) slices
each rank's layers with it and :mod:`repro_torch.checkpoint` shards and
reshards checkpoints with it, so a checkpoint written under one placement
re-slices exactly onto the stages another placement executes.  A leaf
module: it imports neither torch nor the executor, so the checkpoint's
metadata does not depend on the runtime above it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def stage_slices(bounds: Sequence[int]) -> List[Tuple[int, int]]:
    """Boundary list -> per-stage [start, stop) layer spans."""
    return list(zip(bounds[:-1], bounds[1:]))


def stage_counts(bounds: Sequence[int]) -> List[int]:
    """Per-stage layer counts for a boundary list."""
    return [b - a for a, b in zip(bounds[:-1], bounds[1:])]
