"""CheckpointSpec: the placement-derived sharding contract for elastic state
(the port's copy of ``repro.checkpoint.spec``).

A checkpoint is sharded *by the placement that produced it*: stage slot
``s`` persists the contiguous layer range ``boundaries[s]:boundaries[s+1]``
of every scan-stacked decoder leaf (plus its share of the placement-
independent leaves — embeddings, lm head, optimizer scalars).  Because the
manifest records those boundaries, the checkpoint can later be re-sliced
onto *any other* placement: :func:`repro_torch.checkpoint.ckpt.
restore_for_placement` reassembles layer ranges across different stage
boundaries, which is what lets training survive churn that changes the
stage count or the layer split (§5's "preemptible execution and fast
state recovery").

``replication`` models the paper's §5 partial proactive replication:
each stage's writer additionally persists its ``replication`` upstream
neighbours' shards, so losing one writer loses no state.  ``holders``
records which topology nodes physically hold each shard — the input to
:mod:`repro_torch.checkpoint.elastic`'s bytes-actually-missing recovery
pricing.

Layer-range math is the pipeline executor's
(:func:`repro_torch.distributed.stages.stage_slices`): the slice a stage
checkpoints is exactly the slice it executes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.distributed.stages import stage_counts, stage_slices


@dataclass(frozen=True)
class CheckpointSpec:
    """Layer-range sharding of a training-state checkpoint.

    ``boundaries`` is the placement's stage boundary list
    ``(0, ..., num_layers)``; shard ``s`` owns layers
    ``boundaries[s]:boundaries[s+1]``.  ``holders[s]`` (optional) lists
    the topology node ids holding a copy of shard ``s``.
    """
    num_layers: int
    boundaries: Tuple[int, ...]
    replication: int = 0
    holders: Tuple[Tuple[str, ...], ...] = ()

    def __post_init__(self):
        b = list(self.boundaries)
        if len(b) < 2 or b[0] != 0 or b[-1] != self.num_layers \
                or b != sorted(b) or len(set(b)) != len(b):
            raise ValueError(
                f"boundaries {b} must strictly ascend from 0 to "
                f"{self.num_layers}")
        if not 0 <= self.replication <= self.num_shards - 1:
            raise ValueError(
                f"replication={self.replication} needs 0 <= r <= "
                f"{self.num_shards - 1} neighbour copies")
        if self.holders and len(self.holders) != self.num_shards:
            raise ValueError(
                f"holders covers {len(self.holders)} shards, spec has "
                f"{self.num_shards}")

    # ------------------------------------------------------------- shape
    @property
    def num_shards(self) -> int:
        return len(self.boundaries) - 1

    def slices(self) -> List[Tuple[int, int]]:
        """Per-shard [start, stop) layer spans (pipeline boundary math)."""
        return stage_slices(self.boundaries)

    def layer_counts(self) -> List[int]:
        return stage_counts(self.boundaries)

    def held_shards(self, shard_id: int) -> List[int]:
        """Shards writer ``shard_id`` persists: its own plus its
        ``replication`` upstream neighbours' (§5 partial proactive
        replication — losing one writer loses no shard)."""
        S = self.num_shards
        return [(shard_id - k) % S for k in range(self.replication + 1)]

    # ------------------------------------------------------------ builders
    @classmethod
    def from_placement(cls, placement, replication: int = 0
                       ) -> "CheckpointSpec":
        """Derive the sharding from a
        :class:`repro_torch.core.placement.PlacementSpec`: shard ``s`` is stage
        ``s``'s layer range, held by every replica's stage-``s`` node
        (DP replicas carry identical state) plus, with ``replication``,
        the next ``replication`` downstream stages' nodes."""
        S = placement.num_stages
        rep = min(max(replication, 0), S - 1)
        holders: List[Tuple[str, ...]] = []
        for s in range(S):
            hs: List[str] = []
            for k in range(rep + 1):
                j = (s + k) % S
                for pipe in placement.pipelines:
                    hs.append(pipe[j].node)
            holders.append(tuple(dict.fromkeys(hs)))
        return cls(placement.num_layers, tuple(placement.boundaries),
                   rep, tuple(holders))

    @classmethod
    def single(cls, num_layers: int) -> "CheckpointSpec":
        """Trivial one-shard spec (a single writer holds everything)."""
        return cls(num_layers, (0, num_layers))

    def with_holders(self, holders: Sequence[Sequence[str]]
                     ) -> "CheckpointSpec":
        return CheckpointSpec(self.num_layers, self.boundaries,
                              self.replication,
                              tuple(tuple(h) for h in holders))
