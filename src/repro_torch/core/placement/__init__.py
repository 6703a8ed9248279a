"""Topology-aware placement: the contract between planning and execution
(the port's copy of ``repro.core.placement``).

A :class:`PlacementSpec` says, for every data-parallel replica, which
device holds which pipeline stage, where that device sits in the
wide-area :class:`~repro_torch.core.net.Topology`, and which
**non-uniform** contiguous layer range each stage owns.  The DT-FM
planner prices placements (:mod:`repro_torch.core.planner.dtfm`),
:func:`search_placement` picks the cheapest, local SGD maps its replicas
onto the spec's region groups (per-region inner-step counts, per-slot
sync pricing), the elastic checkpoints shard the training state by its
stage boundaries, and the orchestrator replans through the same search on
churn.  :func:`search_placement_fleet` is the batched search over
:class:`~repro_torch.core.net.FleetArrays` for fleets of 10⁴–10⁶ devices.
"""

from repro_torch.core.placement.spec import PlacementSpec, StagePlacement
from repro_torch.core.placement.search import (balanced_boundaries,
                                               ordered_placement,
                                               round_robin_placement,
                                               search_placement)
from repro_torch.core.placement.fleet import (FleetPlacement,
                                              price_fleet_grid,
                                              search_placement_fleet)

__all__ = [
    "PlacementSpec", "StagePlacement",
    "balanced_boundaries", "ordered_placement", "round_robin_placement",
    "search_placement",
    "FleetPlacement", "price_fleet_grid", "search_placement_fleet",
]
