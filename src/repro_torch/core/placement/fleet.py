"""Hierarchical placement search over :class:`FleetArrays` (the port's
copy of ``repro.core.placement.fleet``).

``search_placement`` prices every candidate with the full DT-FM cost
model over the dict topology — fine at tens of devices, hopeless at
10⁵.  This module makes fleet-scale search tractable in two moves:

1. **Vectorized exact pricing** (:func:`price_fleet_grid`): a candidate
   is a ``(dp, S)`` grid of fleet rows; makespan, stage-boundary
   activations, and DP gradient sync (via
   :func:`~repro_torch.core.net.collectives.batched_sync_cost`) are priced as
   array ops with loops only over *stages*, bit-identical to
   ``dtfm.plan_placement`` on the equivalent ``PlacementSpec``.
2. **Hierarchical candidate ranking** (:func:`search_placement_fleet`):
   candidates are first scored on O(regions) summaries — used-device
   bottleneck FLOP/s from per-region prefix minima, cross-region edge
   counts from region block boundaries — and only the top few survivors
   (plus the round-robin baseline and caller order, always) get the
   exact device-level pricing.  Search cost scales with the number of
   regions, not the number of devices.

The exact pricing key matches the scalar search: minimize
``(step_time_s, wan_bytes_per_step, cross_region_edges)``.
"""

from __future__ import annotations

import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import flops as F
from repro_torch.core.net.collectives import batched_sync_cost
from repro_torch.core.net.fleet_arrays import FleetArrays
from repro_torch.core.placement.search import balanced_boundaries
from repro_torch.models.config import ModelConfig


@dataclass
class FleetPlacement:
    """A fleet-rows placement: ``grid[replica, stage]`` is a row into the
    priced :class:`FleetArrays`.  ``to_spec`` materializes the equivalent
    :class:`~repro_torch.core.placement.PlacementSpec` (for parity tests and
    for handing the winner to the executor path)."""
    fleet: FleetArrays
    grid: np.ndarray                      # (dp, S) int64 fleet rows
    boundaries: List[int]                 # length S+1
    idle: np.ndarray                      # fleet rows left out
    strategy: str
    step_time_s: float
    wan_bytes_per_step: float
    wire_bytes_per_step: float
    cross_region_edges: int
    search_stats: Dict[str, float] = field(default_factory=dict)

    @property
    def data_parallel(self) -> int:
        return int(self.grid.shape[0])

    @property
    def num_stages(self) -> int:
        return int(self.grid.shape[1])

    def price_key(self) -> Tuple[float, float, int]:
        return (self.step_time_s, self.wan_bytes_per_step,
                self.cross_region_edges)

    def to_spec(self, cfg: ModelConfig, topology=None):
        from repro_torch.core.placement.spec import (PlacementSpec,
                                               StagePlacement)
        from repro_torch.core.net.fleet_arrays import _spec_for_row
        topo = topology if topology is not None \
            else self.fleet.to_topology()
        b = self.boundaries
        pipelines = []
        for row in self.grid:
            pipelines.append([
                StagePlacement(_spec_for_row(self.fleet, int(r)),
                               str(self.fleet.node_names[int(r)]),
                               range(b[i], b[i + 1]))
                for i, r in enumerate(row)])
        spec = PlacementSpec(cfg.name, cfg.num_layers, pipelines, topo,
                             strategy=self.strategy,
                             idle_nodes=[str(self.fleet.node_names[i])
                                         for i in self.idle])
        spec.search_stats = dict(self.search_stats)
        return spec.validate()


def price_fleet_grid(fleet: FleetArrays, cfg: ModelConfig,
                     grid: np.ndarray, *, batch: int, seq_len: int,
                     microbatches: int = 8, train: bool = True,
                     collective: str = "hierarchical", compress=None,
                     sync_interval: int = 1,
                     idle: Optional[np.ndarray] = None,
                     strategy: str = "grid") -> FleetPlacement:
    """Exact DT-FM pricing of a ``(dp, S)`` fleet-row grid.

    Replays ``dtfm.plan_placement``'s op sequence with loops only over
    stage slots: same balanced boundaries (empty slots dropped to idle),
    same GPipe makespan, same per-replica boundary folds, same batched
    collective sync — bit-identical ``step_time_s`` / ``wan_bytes`` /
    ``cross_region_edges``.
    """
    grid = np.asarray(grid, dtype=np.int64)
    dp, _ = grid.shape
    if dp > batch:
        raise ValueError(f"data_parallel={dp} exceeds batch={batch}")
    eff_all = fleet.eff_flops[grid]
    weights = [float(w) for w in np.minimum.reduce(eff_all, axis=0)]
    bounds = balanced_boundaries(cfg.num_layers, weights)
    lens = np.diff(np.asarray(bounds, dtype=np.int64))
    kept = lens > 0
    dropped = grid[:, ~kept].ravel()
    idle = dropped if idle is None \
        else np.concatenate([np.asarray(idle, np.int64), dropped])
    grid = grid[:, kept]
    lens_k = lens[kept]
    S = grid.shape[1]
    bounds = [0] + list(np.cumsum(lens_k).astype(int))

    total_flops = F.train_flops(cfg, batch // dp, seq_len, remat=False) \
        if train else F.fwd_flops(cfg, batch // dp, seq_len)
    per_layer = total_flops / cfg.num_layers
    mb = microbatches
    t_mb = ((per_layer * lens_k) / mb) / fleet.eff_flops[grid]
    makespan = (mb + S - 1) * float(t_mb.max())

    # stage-boundary activations: per-replica sequential fold over stage
    # pairs, slowest replica gates; wire/wan accumulate scalar-order
    act_bytes = (batch // dp) * seq_len * cfg.d_model * 2
    directions = 2 if train else 1
    nbytes_mb = act_bytes / mb
    rid = fleet.region_of[grid].astype(np.int64)
    da = fleet.acc_delay[grid]
    abw = fleet.acc_bw[grid]
    wd = fleet.wan_delay[rid]
    wb = fleet.wan_bw[rid]
    t_rep = np.zeros(dp)
    for i in range(S - 1):
        cross = rid[:, i] != rid[:, i + 1]
        delay = np.where(cross,
                         ((da[:, i] + wd[:, i]) + wd[:, i + 1])
                         + da[:, i + 1],
                         da[:, i] + da[:, i + 1])
        bw = np.where(cross,
                      np.minimum(np.minimum(abw[:, i], wb[:, i]),
                                 np.minimum(wb[:, i + 1], abw[:, i + 1])),
                      np.minimum(abw[:, i], abw[:, i + 1]))
        t_rep = t_rep + (directions * mb) * (delay + nbytes_mb / bw)
    boundary_s = float(t_rep.max()) if S > 1 and dp else 0.0
    boundary_s = max(0.0, boundary_s)
    cross_all = rid[:, :-1] != rid[:, 1:]
    cross_edges = int(cross_all.sum())
    v = float(directions * act_bytes)
    n_pairs = dp * (S - 1)
    boundary_wire = float(np.cumsum(np.full(n_pairs, v))[-1]) \
        if n_pairs else 0.0
    wan_add = np.where(cross_all.ravel(), v, 0.0)
    boundary_wan = float(np.cumsum(wan_add)[-1]) if n_pairs else 0.0

    # DP gradient sync: one batched collective call prices all S slots
    dp_sync_s = 0.0
    dp_wire = 0.0
    dp_wan = 0.0
    if train and dp > 1:
        n_elems_total = F.param_bytes(cfg, 1)
        shards = [int(n_elems_total * int(l) / cfg.num_layers)
                  for l in lens_k]
        c = batched_sync_cost(
            fleet, grid.T.ravel(), np.repeat(np.arange(S), dp),
            np.asarray(shards), algorithm=collective, compress=compress,
            dtype_bytes=2, sync_interval=sync_interval)
        for i in range(S):       # scalar per-slot folds, slot order
            dp_sync_s = max(dp_sync_s, float(c.time_s[i]))
            dp_wire += float(c.wire_bytes[i])
            dp_wan += float(c.wan_bytes[i])
    comm_s = boundary_s + dp_sync_s

    return FleetPlacement(
        fleet=fleet, grid=grid, boundaries=bounds, idle=idle,
        strategy=strategy,
        step_time_s=makespan + comm_s,
        wan_bytes_per_step=boundary_wan + dp_wan,
        wire_bytes_per_step=boundary_wire + dp_wire,
        cross_region_edges=cross_edges)


# ------------------------------------------------------------------ search

def _region_tables(fleet: FleetArrays):
    """Per-region device rows sorted fast-first (the scalar search's
    within-region order: (-effective_flops, node_name))."""
    tables = {}
    for g in range(fleet.num_regions):
        rows = np.flatnonzero(fleet.region_of == g)
        if rows.shape[0] == 0:
            continue
        order = np.lexsort((fleet.node_names[rows],
                            -fleet.eff_flops[rows]))
        rows = rows[order]
        tables[g] = (rows, np.minimum.accumulate(fleet.eff_flops[rows]))
    return tables


def _proxy_score(fleet: FleetArrays, perm: Sequence[int], tables,
                 dp: int, cfg: ModelConfig, batch: int, seq_len: int,
                 microbatches: int) -> Tuple[float, int]:
    """O(regions) candidate score: estimated gated stage time from the
    used-device bottleneck FLOP/s + cross-region edge count from region
    block boundaries.  Ranks candidates only — winners are re-priced
    exactly, and the round-robin/caller layouts are always re-priced —
    so a coarse proxy costs recall, never correctness."""
    counts = [tables[g][0].shape[0] for g in perm]
    n = sum(counts)
    S = n // dp
    used = S * dp
    if S == 0:
        return (np.inf, 0)
    # bottleneck = min over regions of each region's used-prefix min
    remaining = used
    bottleneck = np.inf
    starts = []
    pos = 0
    for g, c in zip(perm, counts):
        take = min(c, remaining)
        if take > 0:
            bottleneck = min(bottleneck, float(tables[g][1][take - 1]))
        starts.append(pos)
        pos += c
        remaining -= take
        if remaining <= 0:
            break
    # cross edges: region block starts falling strictly inside a replica
    # row of the contiguous carve (row r spans [r*S, (r+1)*S))
    blocks = np.asarray(starts[1:], dtype=np.int64)
    blocks = blocks[blocks < used]
    interior = blocks[blocks % S != 0].shape[0]
    total_flops = F.train_flops(cfg, batch // dp, seq_len, remat=False)
    t_stage = (total_flops / S) / microbatches / bottleneck
    est = (microbatches + S - 1) * t_stage
    return (est, interior)


def search_placement_fleet(fleet: FleetArrays, cfg: ModelConfig, *,
                           data_parallel: int, batch: int, seq_len: int,
                           microbatches: int = 8, train: bool = True,
                           collective: str = "hierarchical",
                           compress=None, sync_interval: int = 1,
                           refine_top_k: int = 3) -> FleetPlacement:
    """Two-stage topology-aware search over a fleet of any size.

    Stage 1 ranks every region-contiguous candidate ordering on region
    summaries (O(R) each); stage 2 exactly prices the ``refine_top_k``
    survivors plus the round-robin baseline and caller order, returning
    the cheapest by ``(step_time, wan_bytes, cross_region_edges)``.
    ``search_stats`` records how many candidates the ranking pruned.
    """
    t0 = _time.perf_counter()
    dp = data_parallel
    N = fleet.num_devices
    if N < dp:
        raise ValueError(f"{N} devices cannot host {dp} pipelines")
    tables = _region_tables(fleet)
    regions = sorted(tables)
    if len(regions) <= 4:
        perms = list(itertools.permutations(regions))
    else:
        cap = {g: float(fleet.eff_flops[tables[g][0]].sum())
               for g in regions}
        perms = [tuple(sorted(regions, key=lambda g: -cap[g])),
                 tuple(regions)]

    scored = sorted(
        (( _proxy_score(fleet, perm, tables, dp, cfg, batch, seq_len,
                        microbatches), perm) for perm in perms),
        key=lambda t: t[0])
    survivors = [perm for _, perm in scored[:max(1, refine_top_k)]]
    pruned = len(perms) - len(survivors)

    def carve(order: np.ndarray, contiguous: bool) -> Tuple[np.ndarray,
                                                            np.ndarray]:
        S = order.shape[0] // dp
        used, rest = order[:S * dp], order[S * dp:]
        g = used.reshape(dp, S) if contiguous \
            else used.reshape(S, dp).T
        return g, rest

    candidates: List[FleetPlacement] = []

    def price(order, contiguous, tag):
        g, rest = carve(np.asarray(order, np.int64), contiguous)
        candidates.append(price_fleet_grid(
            fleet, cfg, g, batch=batch, seq_len=seq_len,
            microbatches=microbatches, train=train,
            collective=collective, compress=compress,
            sync_interval=sync_interval, idle=rest, strategy=tag))

    price(np.arange(N), False, "round_robin")      # baseline, always
    price(np.arange(N), True, "caller")            # caller order, always
    for perm in survivors:
        order = np.concatenate([tables[g][0] for g in perm])
        names = ">".join(str(fleet.regions[g]) for g in perm)
        price(order, True, f"regions:{names}")

    best = min(candidates, key=FleetPlacement.price_key)
    rr = candidates[0]
    best.strategy = f"topology_aware({best.strategy})"
    best.search_stats = {
        "candidates_total": len(perms) + 2,
        "candidates_priced": len(candidates),
        "candidates_pruned": pruned,
        "round_robin_step_time_s": rr.step_time_s,
        "round_robin_wan_bytes": rr.wan_bytes_per_step,
        "search_wall_s": _time.perf_counter() - t0,
    }
    return best
