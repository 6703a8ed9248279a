"""Wide-area network model: topology graph + collective cost models, scalar
and batched over :class:`FleetArrays`."""

from repro_torch.core.net.collectives import (COLLECTIVES,
                                              BatchedCollectiveCost,
                                              CollectiveCost,
                                              batched_collective_cost,
                                              batched_sync_cost,
                                              collective_cost,
                                              gossip_average,
                                              hierarchical_allreduce,
                                              ring_allgather, ring_allreduce,
                                              sync_cost, tree_allreduce)
from repro_torch.core.net.fleet_arrays import FleetArrays, synthetic_fleet
from repro_torch.core.net.topology import BACKBONE, Link, NetParams, Topology

__all__ = [
    "BACKBONE", "Link", "NetParams", "Topology",
    "COLLECTIVES", "CollectiveCost", "collective_cost",
    "ring_allreduce", "tree_allreduce", "hierarchical_allreduce",
    "gossip_average", "ring_allgather", "sync_cost",
    "FleetArrays", "synthetic_fleet",
    "BatchedCollectiveCost", "batched_collective_cost",
    "batched_sync_cost",
]
