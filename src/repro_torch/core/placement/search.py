"""Placement construction and topology-aware search (the port's copy of
``repro.core.placement.search``).

Three ways to turn a fleet into a :class:`PlacementSpec`:

* :func:`ordered_placement` — caller order, one pipeline of the given
  devices with ``data_parallel`` analytic clone replicas (the legacy
  :func:`repro_torch.core.planner.dtfm.plan` contract, kept as the
  backward-compatible path).
* :func:`round_robin_placement` — the naive fleet carve-up: device ``j``
  goes to replica ``j % dp``, stage ``j // dp``, regions ignored.  This
  is the baseline topology-aware search must beat.
* :func:`search_placement` — enumerate region-aware candidate layouts
  (regions kept contiguous along each pipeline so stage-boundary
  activations ride intra-region links; replicas carved region-first so
  DP sync crosses the WAN O(regions) times; fast devices aligned across
  replicas so the slot minimum gates least), price every candidate with
  the DT-FM cost model, and return the cheapest.  The round-robin and
  caller-order layouts are always in the candidate set, so the search
  never returns something worse than either.

Layer boundaries are **non-uniform**: proportional to the slowest
replica's effective FLOP/s in each stage slot
(:func:`balanced_boundaries`), which balances per-stage time under
heterogeneous compute.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.energy.devices import DeviceSpec
from repro_torch.core.net import Topology
from repro_torch.core.placement.spec import PlacementSpec, StagePlacement
from repro_torch.models.config import ModelConfig

# (device, node) pairs arranged as grid[replica][stage_slot]
_Grid = List[List[Tuple[DeviceSpec, str]]]


def balanced_boundaries(num_layers: int, weights: Sequence[float]
                        ) -> List[int]:
    """Contiguous boundaries (len ``len(weights)+1``) ∝ per-slot weight.

    Monotone and clamped to [prev, L]: more slots than layers yields
    EMPTY slots rather than phantom layers (the caller drops them).
    """
    total = sum(weights)
    bounds = [0]
    acc = 0.0
    for w in weights[:-1]:
        acc += w
        bounds.append(min(max(round(num_layers * acc / total),
                              bounds[-1]), num_layers))
    bounds.append(num_layers)
    return bounds


def _spec_from_grid(cfg: ModelConfig, grid: _Grid, topology: Topology,
                    strategy: str, idle: Optional[List[str]] = None,
                    dp_sync_nodes: Optional[List[List[str]]] = None
                    ) -> PlacementSpec:
    """Shared boundaries over the grid, empty slots dropped everywhere."""
    slots = len(grid[0])
    # the slowest replica in a slot gates synchronous DP: weight by min
    weights = [min(grid[r][i][0].effective_flops
                   for r in range(len(grid))) for i in range(slots)]
    bounds = balanced_boundaries(cfg.num_layers, weights)
    idle = list(idle or [])
    kept = [i for i in range(slots) if bounds[i + 1] > bounds[i]]
    pipelines: List[List[StagePlacement]] = []
    for row in grid:
        pipe = []
        for i, (dev, node) in enumerate(row):
            rng = range(bounds[i], bounds[i + 1])
            if len(rng) == 0:
                if node not in idle:
                    idle.append(node)       # idle device: no pipeline stage
                continue
            pipe.append(StagePlacement(dev, node, rng))
        pipelines.append(pipe)
    sync = [dp_sync_nodes[i] for i in kept] if dp_sync_nodes else []
    return PlacementSpec(cfg.name, cfg.num_layers, pipelines, topology,
                         strategy=strategy, idle_nodes=idle,
                         dp_sync_nodes=sync).validate()


# --------------------------------------------------------------------------- #
# Legacy single-pipeline path (dtfm.plan's contract)
# --------------------------------------------------------------------------- #

def _extend_for_dp(topology: Topology, devices: Sequence[DeviceSpec],
                   nodes: Sequence[str], data_parallel: int,
                   dp_regions: Optional[Sequence[str]]
                   ) -> Tuple[Topology, _Grid, List[List[str]]]:
    """ONE extended topology holding every replica's clone nodes — this
    replaces the old per-stage ``Topology.from_specs`` clone graphs with
    a single reuse of the existing nodes and links.

    Each clone pipeline mirrors the REAL nodes' regions, so boundary
    activations are priced over the same intra/cross-region structure
    the caller's topology describes.  ``dp_regions`` keeps its legacy
    meaning — it spreads the *gradient-sync* replicas across regions —
    via per-slot sync clone nodes (replica ``r`` syncing from
    ``dp_regions[r % len(dp_regions)]``) returned as the
    ``dp_sync_nodes`` override.
    """
    ext = Topology(links=dict(topology.links),
                   device_region=dict(topology.device_region),
                   device_spec=dict(topology.device_spec),
                   params=topology.params)
    grid: _Grid = []
    for r in range(data_parallel):
        row = []
        for dev, node in zip(devices, nodes):
            cid = f"dp{r}:{node}"
            ext.add_device(cid, topology.device_region[node], dev,
                           bw_Bps=topology.access_bw_Bps(node))
            row.append((dev, cid))
        grid.append(row)
    sync_nodes: List[List[str]] = []
    if dp_regions:
        for i, (dev, node) in enumerate(zip(devices, nodes)):
            group = []
            for r in range(data_parallel):
                sid = f"dpsync{r}:{node}"
                ext.add_device(sid, dp_regions[r % len(dp_regions)], dev,
                               bw_Bps=topology.access_bw_Bps(node))
                group.append(sid)
            sync_nodes.append(group)
    return ext, grid, sync_nodes


def ordered_placement(cfg: ModelConfig, devices: Sequence[DeviceSpec], *,
                      topology: Optional[Topology] = None,
                      nodes: Optional[Sequence[str]] = None,
                      data_parallel: int = 1,
                      dp_regions: Optional[Sequence[str]] = None,
                      strategy: str = "ordered") -> PlacementSpec:
    """Caller-order pipeline of ``devices``; ``data_parallel`` clones.

    ``topology``/``nodes`` place the devices in an existing wide-area
    graph; omitted, a single-region topology is synthesized.  With
    ``data_parallel > 1`` each replica is an analytic clone pipeline,
    grouped into ``dp_regions`` for gradient-sync pricing.
    """
    if topology is None:
        topology = Topology.from_specs(devices)
        nodes = [str(i) for i in range(len(devices))]
    if nodes is None:
        raise ValueError("an explicit topology needs nodes= mapping each "
                         "device to its topology node id")
    if data_parallel == 1:
        grid: _Grid = [list(zip(devices, nodes))]
        topo = topology
        sync: List[List[str]] = []
    else:
        topo, grid, sync = _extend_for_dp(topology, devices, nodes,
                                          data_parallel, dp_regions)
    return _spec_from_grid(cfg, grid, topo, strategy,
                           dp_sync_nodes=sync or None)


# --------------------------------------------------------------------------- #
# Fleet carve-ups: round-robin baseline + topology-aware search
# --------------------------------------------------------------------------- #

def _carve(devices: Sequence[DeviceSpec], nodes: Sequence[str],
           order: Sequence[int], data_parallel: int, contiguous: bool
           ) -> Tuple[_Grid, List[str]]:
    """Split ``order`` (indices into devices) into dp pipelines of equal
    length; the remainder idles.  ``contiguous``: pipeline r is a block
    of S consecutive entries; else round-robin (entry j → pipeline
    j % dp)."""
    S = len(order) // data_parallel
    used = order[:S * data_parallel]
    idle = [nodes[i] for i in order[S * data_parallel:]]
    grid: _Grid = []
    for r in range(data_parallel):
        if contiguous:
            idx = used[r * S:(r + 1) * S]
        else:
            idx = used[r::data_parallel]
        grid.append([(devices[i], nodes[i]) for i in idx])
    return grid, idle


def round_robin_placement(cfg: ModelConfig, devices: Sequence[DeviceSpec],
                          *, topology: Topology, nodes: Sequence[str],
                          data_parallel: int = 1) -> PlacementSpec:
    """The naive baseline: caller order, device ``j`` → replica
    ``j % dp``, stage ``j // dp`` — blind to regions.  Depending on how
    the arrival order interleaves regions, that puts stage boundaries on
    the WAN, or (when dp happens to match the interleave stride) lands
    every DP gradient-sync group across regions instead; either way it
    pays WAN costs the search can avoid or trade off deliberately."""
    if len(devices) < data_parallel:
        raise ValueError(f"{len(devices)} devices cannot host "
                         f"{data_parallel} pipelines")
    grid, idle = _carve(devices, nodes, list(range(len(devices))),
                        data_parallel, contiguous=False)
    return _spec_from_grid(cfg, grid, topology, "round_robin", idle)


def _candidate_orders(devices: Sequence[DeviceSpec], nodes: Sequence[str],
                      topology: Topology) -> List[Tuple[str, List[int]]]:
    """Device orderings to evaluate: caller order + region-contiguous
    orders (fast devices first within a region, regions permuted)."""
    cands: List[Tuple[str, List[int]]] = [
        ("caller", list(range(len(devices))))]
    by_region: Dict[str, List[int]] = {}
    for i, n in enumerate(nodes):
        by_region.setdefault(topology.device_region[n], []).append(i)
    for ids in by_region.values():
        ids.sort(key=lambda i: (-devices[i].effective_flops, nodes[i]))
    regions = sorted(by_region)
    if len(regions) <= 4:
        perms = list(itertools.permutations(regions))
    else:
        # too many to enumerate: biggest-capacity-first + name order
        cap = {g: sum(devices[i].effective_flops for i in by_region[g])
               for g in regions}
        perms = [tuple(sorted(regions, key=lambda g: -cap[g])),
                 tuple(regions)]
    for perm in perms:
        order = [i for g in perm for i in by_region[g]]
        cands.append((f"regions:{'>'.join(perm)}", order))
    return cands


def search_placement(cfg: ModelConfig, devices: Sequence[DeviceSpec], *,
                     topology: Topology, nodes: Sequence[str],
                     data_parallel: int = 1, batch: int, seq_len: int,
                     microbatches: int = 8, train: bool = True,
                     collective: str = "hierarchical",
                     compress=None, sync_interval: int = 1
                     ) -> PlacementSpec:
    """Topology-aware placement: price candidate layouts with the DT-FM
    cost model and return the cheapest (step time, then WAN bytes).

    The round-robin and caller-order layouts are always candidates, so
    the result never prices worse than either on the same fleet.

    Pricing is memoized on each candidate's
    :meth:`~repro_torch.core.placement.spec.PlacementSpec.canonical_key`:
    different orderings frequently carve into the same (node, layers)
    grid, and re-running the DT-FM model on them is pure waste.  The
    winning spec's ``search_stats`` reports ``candidates_pruned`` (the
    memo hits) alongside the totals.
    """
    import time as _time
    from repro_torch.core.planner import dtfm       # deferred: dtfm imports us
    t0 = _time.perf_counter()
    if len(devices) != len(nodes):
        raise ValueError(f"{len(devices)} devices vs {len(nodes)} nodes")
    if len(devices) < data_parallel:
        raise ValueError(f"{len(devices)} devices cannot host "
                         f"{data_parallel} pipelines")

    specs: List[PlacementSpec] = [
        round_robin_placement(cfg, devices, topology=topology, nodes=nodes,
                              data_parallel=data_parallel)]
    for tag, order in _candidate_orders(devices, nodes, topology):
        grid, idle = _carve(devices, nodes, order, data_parallel,
                            contiguous=True)
        specs.append(_spec_from_grid(cfg, grid, topology, tag, idle))

    memo: Dict[tuple, tuple] = {}

    def price(spec: PlacementSpec):
        key = spec.canonical_key()
        if key not in memo:
            p = dtfm.plan_placement(cfg, spec, batch=batch,
                                    seq_len=seq_len,
                                    microbatches=microbatches,
                                    train=train, collective=collective,
                                    compress=compress,
                                    sync_interval=sync_interval)
            memo[key] = (p.step_time_s, p.wan_bytes_per_step,
                         spec.cross_region_edges())
        return memo[key]

    best = min(specs, key=price)
    best.strategy = f"topology_aware({best.strategy})"
    best.search_stats = {
        "candidates_total": len(specs),
        "candidates_priced": len(memo),
        "candidates_pruned": len(specs) - len(memo),
        "search_wall_s": _time.perf_counter() - t0,
    }
    return best
