"""Wide-area network model: topology graph + collective cost models."""

from repro_torch.core.net.collectives import (COLLECTIVES, CollectiveCost,
                                              collective_cost,
                                              gossip_average,
                                              hierarchical_allreduce,
                                              ring_allgather, ring_allreduce,
                                              sync_cost, tree_allreduce)
from repro_torch.core.net.topology import BACKBONE, Link, NetParams, Topology

__all__ = [
    "BACKBONE", "Link", "NetParams", "Topology",
    "COLLECTIVES", "CollectiveCost", "collective_cost",
    "ring_allreduce", "tree_allreduce", "hierarchical_allreduce",
    "gossip_average", "ring_allgather", "sync_cost",
]
