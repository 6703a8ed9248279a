"""Struct-of-arrays fleet representation for massive-scale simulation
(the port's copy of ``repro.core.net.fleet_arrays``).

The dict-of-``Link`` :class:`~repro_torch.core.net.topology.Topology` is the
right *authoring* surface — heterogeneous per-device links, incremental
churn — but every cost query walks Python objects, which caps the
orchestrator sim and placement search at tens of devices.
:class:`FleetArrays` is the same fleet flattened into dense numpy
columns (device flops / access bandwidth / region / power / carbon,
region-blocked WAN link parameters), which is what the batched
collective kernels (:func:`repro_torch.core.net.collectives.
batched_collective_cost`), the hierarchical placement search
(:mod:`repro_torch.core.placement.fleet`) and the vectorized churn sweep
(:mod:`repro_torch.core.sched.fleet_sim`) price 10⁴–10⁶ devices against.

The contract: for any fleet expressible as a ``Topology`` built through
``add_device`` (per-device access links + per-region WAN uplinks), the
batched kernels over the arrays are **numerically identical** — same
IEEE-754 operations in the same order — to the scalar cost models over
the dict topology.  ``name_rank`` precomputes the ``(region_name,
node_name)`` string sort the scalar ``_by_region`` ring order uses, so
batched group sorts are integer lexsorts instead of string sorts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.carbon.intensity import INTENSITY_BY_REGION
from repro_torch.core.energy.devices import CATALOG, DeviceSpec
from repro_torch.core.net.topology import BACKBONE, NetParams, Topology


@dataclass
class FleetArrays:
    """Dense per-device columns + per-region WAN parameters."""
    node_names: np.ndarray          # (N,) str — topology node ids
    region_of: np.ndarray           # (N,) int32 — index into ``regions``
    regions: np.ndarray             # (R,) str — region names, SORTED
    acc_bw: np.ndarray              # (N,) float64 — access link bytes/s
    acc_delay: np.ndarray           # (N,) float64 — access latency+jitter
    eff_flops: np.ndarray           # (N,) float64
    power_active_w: np.ndarray      # (N,) float64
    power_idle_w: np.ndarray        # (N,) float64
    power_comm_w: np.ndarray        # (N,) float64
    carbon_kg_per_kwh: np.ndarray   # (N,) float64 — region grid intensity
    wan_bw: np.ndarray              # (R,) float64 — region uplink bytes/s
    wan_delay: np.ndarray           # (R,) float64 — uplink latency+jitter
    params: NetParams = field(default_factory=NetParams)
    spec_names: Optional[np.ndarray] = None     # (N,) str, provenance
    name_rank: np.ndarray = field(default=None)  # (N,) int64, see below

    def __post_init__(self) -> None:
        if self.name_rank is None:
            # rank of each device under the scalar _by_region sort key
            # (region_name, node_name); regions[] is name-sorted so the
            # int pair (region_of, node_name) sorts identically
            order = np.lexsort((self.node_names, self.region_of))
            rank = np.empty(len(order), dtype=np.int64)
            rank[order] = np.arange(len(order))
            self.name_rank = rank

    # ---------------------------------------------------------------- shape
    @property
    def num_devices(self) -> int:
        return int(self.node_names.shape[0])

    @property
    def num_regions(self) -> int:
        return int(self.regions.shape[0])

    def row_of(self) -> Dict[str, int]:
        return {str(n): i for i, n in enumerate(self.node_names)}

    def region_counts(self) -> np.ndarray:
        return np.bincount(self.region_of, minlength=self.num_regions)

    def region_flops(self) -> np.ndarray:
        """Aggregate effective FLOP/s per region (the region summary the
        hierarchical search ranks candidates on)."""
        return np.bincount(self.region_of, weights=self.eff_flops,
                           minlength=self.num_regions)

    # --------------------------------------------------------- constructors
    @classmethod
    def from_topology(cls, topo: Topology) -> "FleetArrays":
        devices = topo.devices
        regions = np.array(sorted({topo.device_region[d] for d in devices}))
        ridx = {r: i for i, r in enumerate(regions)}
        n = len(devices)
        acc_bw = np.empty(n)
        acc_delay = np.empty(n)
        region_of = np.empty(n, dtype=np.int32)
        eff = np.empty(n)
        p_act = np.empty(n)
        p_idle = np.empty(n)
        p_comm = np.empty(n)
        names = []
        for i, d in enumerate(devices):
            r = topo.device_region[d]
            link = topo.links[(d, topo._region_node(r))]
            acc_bw[i] = link.bw_Bps
            acc_delay[i] = link.delay_s
            region_of[i] = ridx[r]
            spec = topo.device_spec[d]
            eff[i] = spec.effective_flops
            p_act[i] = spec.power_active_w
            p_idle[i] = spec.power_idle_w
            p_comm[i] = spec.power_comm_w
            names.append(spec.name)
        wan_bw = np.empty(len(regions))
        wan_delay = np.empty(len(regions))
        for r, i in ridx.items():
            up = topo.links[(topo._region_node(r), BACKBONE)]
            wan_bw[i] = up.bw_Bps
            wan_delay[i] = up.delay_s
        carbon = np.array([_region_intensity(str(r)) for r in regions])
        return cls(node_names=np.array([str(d) for d in devices]),
                   region_of=region_of, regions=regions,
                   acc_bw=acc_bw, acc_delay=acc_delay, eff_flops=eff,
                   power_active_w=p_act, power_idle_w=p_idle,
                   power_comm_w=p_comm,
                   carbon_kg_per_kwh=carbon[region_of],
                   wan_bw=wan_bw, wan_delay=wan_delay,
                   params=topo.params,
                   spec_names=np.array(names))

    @classmethod
    def from_fleet(cls, fleet: Sequence, *,
                   params: Optional[NetParams] = None) -> "FleetArrays":
        """From ``FleetDevice``s, without materializing the dict graph —
        identical columns to ``from_topology(Topology.from_fleet(...))``."""
        params = params or NetParams()
        regions = np.array(sorted({d.region for d in fleet}))
        ridx = {r: i for i, r in enumerate(regions)}
        acc_delay_v = params.access_latency_s + params.access_jitter_s
        wan_delay_v = params.wan_latency_s + params.wan_jitter_s
        n = len(fleet)
        return cls(
            node_names=np.array([str(d.device_id) for d in fleet]),
            region_of=np.array([ridx[d.region] for d in fleet], np.int32),
            regions=regions,
            acc_bw=np.array([d.spec.net_bw_Bps for d in fleet]),
            acc_delay=np.full(n, acc_delay_v),
            eff_flops=np.array([d.spec.effective_flops for d in fleet]),
            power_active_w=np.array([d.spec.power_active_w for d in fleet]),
            power_idle_w=np.array([d.spec.power_idle_w for d in fleet]),
            power_comm_w=np.array([d.spec.power_comm_w for d in fleet]),
            carbon_kg_per_kwh=np.array(
                [_region_intensity(d.region) for d in fleet]),
            wan_bw=np.full(len(regions), params.wan_bw_Bps),
            wan_delay=np.full(len(regions), wan_delay_v),
            params=params,
            spec_names=np.array([d.spec.name for d in fleet]))

    def to_topology(self) -> Topology:
        """Materialize the dict graph (the scalar reference the parity
        tests and the ≥50× speedup baseline price against)."""
        topo = Topology(params=self.params)
        for i in range(self.num_devices):
            spec = _spec_for_row(self, i)
            topo.add_device(str(self.node_names[i]),
                            str(self.regions[self.region_of[i]]), spec,
                            bw_Bps=float(self.acc_bw[i]))
        return topo

    # ------------------------------------------------------------- subsets
    def take(self, rows: np.ndarray) -> "FleetArrays":
        """Sub-fleet view over device ``rows`` (regions table shared)."""
        rows = np.asarray(rows)
        return FleetArrays(
            node_names=self.node_names[rows],
            region_of=self.region_of[rows], regions=self.regions,
            acc_bw=self.acc_bw[rows], acc_delay=self.acc_delay[rows],
            eff_flops=self.eff_flops[rows],
            power_active_w=self.power_active_w[rows],
            power_idle_w=self.power_idle_w[rows],
            power_comm_w=self.power_comm_w[rows],
            carbon_kg_per_kwh=self.carbon_kg_per_kwh[rows],
            wan_bw=self.wan_bw, wan_delay=self.wan_delay,
            params=self.params,
            spec_names=self.spec_names[rows]
            if self.spec_names is not None else None,
            name_rank=None)


def _region_intensity(region: str) -> float:
    table = INTENSITY_BY_REGION.get(region)
    if table:
        return table[max(table)]
    return 0.30                      # generic-grid fallback, kg/kWh


def _spec_for_row(fleet: FleetArrays, i: int) -> DeviceSpec:
    name = str(fleet.spec_names[i]) if fleet.spec_names is not None \
        else f"dev{i}"
    base = CATALOG.get(name)
    if base is not None and base.effective_flops == fleet.eff_flops[i]:
        return base
    return DeviceSpec(
        name=name, kind="edge",
        peak_flops=float(fleet.eff_flops[i]), mfu=1.0,
        power_active_w=float(fleet.power_active_w[i]),
        power_idle_w=float(fleet.power_idle_w[i]),
        power_comm_w=float(fleet.power_comm_w[i]),
        mem_gb=8.0, net_bw_Bps=float(fleet.acc_bw[i]),
        embodied_kgco2e=0.0, lifetime_years=3.0)


def synthetic_fleet(n: int, *, regions: Sequence[str] = ("europe",
                                                         "north_america",
                                                         "east_asia",
                                                         "nordics"),
                    spec_names: Sequence[str] = ("smartphone-sd888",
                                                 "laptop-m2pro"),
                    spec_weights: Optional[Sequence[float]] = None,
                    params: Optional[NetParams] = None,
                    region_mix: str = "round_robin",
                    seed: int = 0) -> FleetArrays:
    """Deterministic synthetic edge fleet at arbitrary scale.

    Devices draw a spec from ``spec_names`` (seeded) and land in a
    region round-robin — the same shape ``make_fleet`` produces, but
    array-native so a 10⁶-device fleet costs milliseconds, not a
    million dict inserts.  ``region_mix="shuffled"`` draws each device's
    region uniformly instead (the arrival order a real volunteer fleet
    presents: interleaved, not striped — what naive carve-ups trip on).
    """
    params = params or NetParams()
    rng = np.random.default_rng(seed)
    w = np.asarray(spec_weights if spec_weights is not None
                   else np.ones(len(spec_names)), float)
    pick = rng.choice(len(spec_names), size=n, p=w / w.sum())
    specs = [CATALOG[s] for s in spec_names]
    reg_sorted = np.array(sorted(regions))
    ridx = {r: i for i, r in enumerate(reg_sorted)}
    if region_mix == "shuffled":
        reg_map = np.array([ridx[r] for r in regions], np.int32)
        region_of = reg_map[rng.integers(0, len(regions), size=n)]
    elif region_mix == "round_robin":
        region_of = np.array([ridx[regions[i % len(regions)]]
                              for i in range(n)], np.int32)
    else:
        raise ValueError(f"unknown region_mix {region_mix!r}")
    eff = np.array([s.effective_flops for s in specs])[pick]
    acc_delay_v = params.access_latency_s + params.access_jitter_s
    wan_delay_v = params.wan_latency_s + params.wan_jitter_s
    carbon = np.array([_region_intensity(str(r)) for r in reg_sorted])
    # zero-padded decimal node ids keep string sort == numeric sort,
    # so ring orders stay stable under fleet growth
    width = len(str(max(n - 1, 1)))
    names = np.array([str(i).zfill(width) for i in range(n)])
    return FleetArrays(
        node_names=names, region_of=region_of, regions=reg_sorted,
        acc_bw=np.array([s.net_bw_Bps for s in specs])[pick],
        acc_delay=np.full(n, acc_delay_v),
        eff_flops=eff,
        power_active_w=np.array([s.power_active_w for s in specs])[pick],
        power_idle_w=np.array([s.power_idle_w for s in specs])[pick],
        power_comm_w=np.array([s.power_comm_w for s in specs])[pick],
        carbon_kg_per_kwh=carbon[region_of],
        wan_bw=np.full(len(reg_sorted), params.wan_bw_Bps),
        wan_delay=np.full(len(reg_sorted), wan_delay_v),
        params=params,
        spec_names=np.array([specs[p].name for p in pick]))
