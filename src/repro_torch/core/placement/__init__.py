"""Topology-aware placement: the contract between planning and execution
(the port's copy of ``repro.core.placement``).

A :class:`PlacementSpec` says, for every data-parallel replica, which
device holds which pipeline stage, where that device sits in the
wide-area :class:`~repro_torch.core.net.Topology`, and which
**non-uniform** contiguous layer range each stage owns.  The DT-FM
planner prices placements (:mod:`repro_torch.core.planner.dtfm`),
:func:`search_placement` picks the cheapest, local SGD maps its replicas
onto the spec's region groups (per-region inner-step counts, per-slot
sync pricing) and the elastic checkpoints shard the training state by its
stage boundaries.

This package exports the spec and the search.  The batched fleet-scale
search (``repro.core.placement.fleet``) waits for the port of
``core/net/fleet_arrays.py`` and the batched collectives.
"""

from repro_torch.core.placement.spec import PlacementSpec, StagePlacement
from repro_torch.core.placement.search import (balanced_boundaries,
                                               ordered_placement,
                                               round_robin_placement,
                                               search_placement)

__all__ = [
    "PlacementSpec", "StagePlacement",
    "balanced_boundaries", "ordered_placement", "round_robin_placement",
    "search_placement",
]
