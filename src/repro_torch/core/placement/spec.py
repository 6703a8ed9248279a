"""The PlacementSpec: device → topology node → stage, per DP replica (the
port's copy of ``repro.core.placement.spec``).

The spec is the *single* plan→place→execute contract:

* ``pipelines[r][i]`` is replica ``r``'s stage ``i``: the device spec,
  its node id in the wide-area topology, and the contiguous layer range
  the stage owns.  Every replica shares the **same** layer boundaries
  (DP gradient sync and the layer-sliced checkpoints match layer shards
  across replicas) but may sit on entirely different devices/regions.
* Boundaries are **non-uniform**: a laptop stage may own 5 layers while
  the smartphone next to it owns 2.
* ``dp_group(i)`` — the nodes holding stage ``i`` across replicas — is
  the gradient-sync group the collective cost models price, and
  ``region_groups()`` is how local-SGD maps its replicas onto regions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.energy.devices import DeviceSpec
from repro_torch.core.net import Topology


@dataclass(frozen=True)
class StagePlacement:
    """One pipeline stage of one replica, pinned to a topology node."""
    device: DeviceSpec
    node: str                       # topology node id
    layers: range                   # contiguous [start, stop)


@dataclass
class PlacementSpec:
    """Full fleet placement: ``pipelines[replica][stage]``."""
    model: str
    num_layers: int
    pipelines: List[List[StagePlacement]]
    topology: Topology
    strategy: str = "ordered"       # provenance: ordered | round_robin |
                                    # topology_aware | ...
    idle_nodes: List[str] = field(default_factory=list)   # devices the
                                    # placement left out (fleet > dp * S)
    dp_sync_nodes: List[List[str]] = field(default_factory=list)
    # ^ optional per-stage-slot override of the gradient-sync groups
    # (legacy dp_regions semantics: sync is priced from different
    # regions than the pipelines compute in); empty -> groups are the
    # pipeline nodes themselves
    search_stats: Dict[str, float] = field(default_factory=dict)
    # ^ provenance from the search that produced this spec: candidates
    # considered / priced / pruned (memoized or proxy-ranked away),
    # baseline prices, wall time

    # ------------------------------------------------------------- shape
    @property
    def data_parallel(self) -> int:
        return len(self.pipelines)

    @property
    def num_stages(self) -> int:
        return len(self.pipelines[0])

    @property
    def stages(self) -> List[StagePlacement]:
        """Replica 0's pipeline (the reference for uniform-fleet plans)."""
        return self.pipelines[0]

    @property
    def boundaries(self) -> List[int]:
        """Layer boundaries, length num_stages + 1: [0, ..., num_layers]."""
        return [s.layers.start for s in self.pipelines[0]] \
            + [self.num_layers]

    @property
    def layer_counts(self) -> List[int]:
        return [len(s.layers) for s in self.pipelines[0]]

    @property
    def max_stage_layers(self) -> int:
        return max(self.layer_counts)

    # ------------------------------------------------------------ groups
    def dp_group(self, stage: int) -> List[str]:
        """Nodes holding ``stage`` across replicas — the grad-sync group."""
        if self.dp_sync_nodes:
            return list(self.dp_sync_nodes[stage])
        return [pipe[stage].node for pipe in self.pipelines]

    def dp_groups(self) -> List[List[str]]:
        return [self.dp_group(i) for i in range(self.num_stages)]

    def replica_regions(self, replica: int) -> List[str]:
        """Regions replica ``replica``'s stages occupy (stage order)."""
        return [self.topology.device_region[s.node]
                for s in self.pipelines[replica]]

    def region_groups(self) -> Dict[str, List[int]]:
        """region → replicas whose stage-0 device sits there (local-SGD's
        replica→region mapping for hierarchical sync)."""
        groups: Dict[str, List[int]] = {}
        for r, pipe in enumerate(self.pipelines):
            groups.setdefault(
                self.topology.device_region[pipe[0].node], []).append(r)
        return groups

    def canonical_key(self) -> tuple:
        """Hashable identity of the *placement itself* — per-replica
        (node, layer-range) tuples plus any sync-group overrides.  Two
        candidate specs with the same key price identically, which is
        what the search memoizes on (different orderings frequently
        carve into the same grid)."""
        return (
            tuple(tuple((s.node, s.layers.start, s.layers.stop)
                        for s in pipe) for pipe in self.pipelines),
            tuple(tuple(g) for g in self.dp_sync_nodes),
        )

    def cross_region_edges(self) -> int:
        """Stage boundaries whose two devices sit in different regions,
        summed over replicas — each one puts activations on the WAN."""
        n = 0
        reg = self.topology.device_region
        for pipe in self.pipelines:
            for a, b in zip(pipe[:-1], pipe[1:]):
                if reg[a.node] != reg[b.node]:
                    n += 1
        return n

    # ---------------------------------------------------------- checking
    def validate(self) -> "PlacementSpec":
        """Raise ValueError unless the spec is a well-formed placement."""
        if not self.pipelines or not self.pipelines[0]:
            raise ValueError("placement has no pipeline stages")
        S = self.num_stages
        ref = [(s.layers.start, s.layers.stop) for s in self.pipelines[0]]
        for r, pipe in enumerate(self.pipelines):
            if len(pipe) != S:
                raise ValueError(
                    f"replica {r} has {len(pipe)} stages, replica 0 has {S}")
            spans = [(s.layers.start, s.layers.stop) for s in pipe]
            if spans != ref:
                raise ValueError(
                    f"replica {r} layer boundaries {spans} differ from "
                    f"replica 0's {ref}; DP shards would not line up")
            for s in pipe:
                if s.node not in self.topology.device_region:
                    raise ValueError(
                        f"stage node {s.node!r} is not in the topology")
                if len(s.layers) == 0:
                    raise ValueError(
                        f"replica {r} has an empty stage at {s.layers}; "
                        "drop idle devices instead")
        cover = [x for st, sp in ref for x in range(st, sp)]
        if cover != list(range(self.num_layers)):
            raise ValueError(
                f"stage layers {ref} do not tile 0..{self.num_layers} "
                "contiguously")
        nodes = [s.node for pipe in self.pipelines for s in pipe]
        if len(set(nodes)) != len(nodes):
            raise ValueError("a topology node holds more than one stage")
        if self.dp_sync_nodes:
            if len(self.dp_sync_nodes) != S:
                raise ValueError(
                    f"dp_sync_nodes covers {len(self.dp_sync_nodes)} "
                    f"stage slots, placement has {S}")
            for i, group in enumerate(self.dp_sync_nodes):
                if len(group) != self.data_parallel:
                    raise ValueError(
                        f"dp_sync_nodes[{i}] has {len(group)} nodes for "
                        f"{self.data_parallel} replicas")
                for n in group:
                    if n not in self.topology.device_region:
                        raise ValueError(
                            f"sync node {n!r} is not in the topology")
        return self

    def describe(self) -> str:
        reg = self.topology.device_region
        lines = [f"placement[{self.strategy}] {self.model}: "
                 f"{self.data_parallel} replicas x {self.num_stages} "
                 f"stages, boundaries {self.boundaries}"]
        for r, pipe in enumerate(self.pipelines):
            parts = [f"L{s.layers.start}-{s.layers.stop}:"
                     f"{s.device.name}@{reg[s.node]}" for s in pipe]
            lines.append(f"  r{r}: " + "  ".join(parts))
        if self.idle_nodes:
            lines.append(f"  idle: {', '.join(self.idle_nodes)}")
        return "\n".join(lines)
