"""Wide-area network topology for edge fleets (the port's own copy of
``repro.core.net.topology``, which has no JAX in it).

The fleets this repo plans over talk across *heterogeneous wide-area
links*, not a datacenter fabric: a smartphone on WiFi behind a home
router, a laptop on campus ethernet, a cloud GPU on 25 GbE — all in
different regions joined by a backbone.  A single ``min(net_bw_Bps)``
scalar (the seed planner's model) cannot express why hierarchical
collectives or local-update training help, because it prices an
intra-region hop and a trans-continental hop identically.

This module models the fleet as a three-level hierarchy:

    device --access link--> region router --WAN link--> backbone

Every edge is a :class:`Link` with its own bandwidth, propagation
latency, and jitter (the p95-p50 spread that a straggler-synchronous
collective actually waits for).  Routing is hierarchical and
deterministic: two devices in the same region meet at their region
router; across regions the path transits the backbone.  The analytic
collective cost models in :mod:`repro_torch.core.net.collectives` consume
these paths.

Defaults follow the paper's §4.2 edge setting (10 MB/s symmetric device
links) with WAN numbers typical of inter-region internet paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.energy.devices import DeviceSpec

# Typical wide-area constants (per-flow; see e.g. M-Lab / RIPE Atlas
# inter-region medians).  All overridable in NetParams.
DEFAULT_ACCESS_LATENCY_S = 0.005     # device <-> region router (WiFi/LAN)
DEFAULT_ACCESS_JITTER_S = 0.002
DEFAULT_WAN_BW_BPS = 37.5e6          # per-flow inter-region: 300 Mb/s
DEFAULT_WAN_LATENCY_S = 0.050        # one-way inter-region propagation
DEFAULT_WAN_JITTER_S = 0.010

BACKBONE = "backbone"


@dataclass(frozen=True)
class Link:
    """One directed network edge (modelled symmetric unless stated)."""
    bw_Bps: float
    latency_s: float = 0.0
    jitter_s: float = 0.0

    @property
    def delay_s(self) -> float:
        """Effective per-transfer fixed cost: propagation + jitter margin."""
        return self.latency_s + self.jitter_s

    def transfer_s(self, nbytes: float) -> float:
        return self.delay_s + nbytes / self.bw_Bps


@dataclass(frozen=True)
class NetParams:
    """Knobs for the synthesized hierarchy (access/WAN defaults above)."""
    access_latency_s: float = DEFAULT_ACCESS_LATENCY_S
    access_jitter_s: float = DEFAULT_ACCESS_JITTER_S
    wan_bw_Bps: float = DEFAULT_WAN_BW_BPS
    wan_latency_s: float = DEFAULT_WAN_LATENCY_S
    wan_jitter_s: float = DEFAULT_WAN_JITTER_S


@dataclass
class Topology:
    """Hierarchical device→region→backbone graph with per-link costs.

    Node ids: devices are arbitrary strings (``str(device_id)``), region
    routers are ``region:<name>``, the backbone is ``backbone``.
    """
    links: Dict[Tuple[str, str], Link] = field(default_factory=dict)
    device_region: Dict[str, str] = field(default_factory=dict)
    device_spec: Dict[str, DeviceSpec] = field(default_factory=dict)
    params: NetParams = field(default_factory=NetParams)
    # region -> member devices, maintained incrementally: ``regions`` /
    # ``devices_in_region`` used to rescan every device per call, which
    # the orchestrator replan loop hit once per region per churn event
    _region_devices: Dict[str, List[str]] = field(default_factory=dict,
                                                  repr=False)

    def __post_init__(self) -> None:
        # constructed-from-dicts path (e.g. search's _extend_for_dp):
        # build the index from whatever device_region already holds
        self._region_devices = {}
        for d, r in self.device_region.items():
            self._region_devices.setdefault(r, []).append(d)

    # -------------------------------------------------------------- building
    @staticmethod
    def _region_node(region: str) -> str:
        return f"region:{region}"

    def add_device(self, dev_id: str, region: str, spec: DeviceSpec, *,
                   bw_Bps: Optional[float] = None) -> None:
        p = self.params
        r = self._region_node(region)
        if (r, BACKBONE) not in self.links:
            wan = Link(p.wan_bw_Bps, p.wan_latency_s, p.wan_jitter_s)
            self.links[(r, BACKBONE)] = wan
            self.links[(BACKBONE, r)] = wan
        access = Link(bw_Bps if bw_Bps is not None else spec.net_bw_Bps,
                      p.access_latency_s, p.access_jitter_s)
        self.links[(dev_id, r)] = access
        self.links[(r, dev_id)] = access
        if dev_id in self.device_region:
            old = self.device_region[dev_id]
            if old != region:
                self._region_devices[old].remove(dev_id)
                self._region_devices.setdefault(region, []).append(dev_id)
        else:
            self._region_devices.setdefault(region, []).append(dev_id)
        self.device_region[dev_id] = region
        self.device_spec[dev_id] = spec

    @classmethod
    def from_fleet(cls, fleet: Sequence, *,
                   params: Optional[NetParams] = None) -> "Topology":
        """Build from fleet devices: anything with ``.device_id``,
        ``.region`` and ``.spec`` (the scheduler's ``FleetDevice``)."""
        topo = cls(params=params or NetParams())
        for d in fleet:
            topo.add_device(str(d.device_id), d.region, d.spec)
        return topo

    @classmethod
    def from_specs(cls, devices: Sequence[DeviceSpec], *,
                   regions: Optional[Sequence[str]] = None,
                   params: Optional[NetParams] = None) -> "Topology":
        """Build from bare DeviceSpecs; single region unless given."""
        topo = cls(params=params or NetParams())
        for i, spec in enumerate(devices):
            region = regions[i % len(regions)] if regions else "local"
            topo.add_device(str(i), region, spec)
        return topo

    # -------------------------------------------------------------- queries
    @property
    def devices(self) -> List[str]:
        return list(self.device_region)

    @property
    def regions(self) -> List[str]:
        """Regions in first-device-seen order (O(R), not a device scan)."""
        return [r for r, ds in self._region_devices.items() if ds]

    def devices_in_region(self, region: str) -> List[str]:
        return list(self._region_devices.get(region, ()))

    def path(self, a: str, b: str) -> List[Link]:
        """Hierarchical route: same-region via router, else via backbone."""
        if a == b:
            return []
        ra = self._region_node(self.device_region[a])
        rb = self._region_node(self.device_region[b])
        if ra == rb:
            hops = [(a, ra), (ra, b)]
        else:
            hops = [(a, ra), (ra, BACKBONE), (BACKBONE, rb), (rb, b)]
        return [self.links[h] for h in hops]

    def path_bw_Bps(self, a: str, b: str) -> float:
        return min(l.bw_Bps for l in self.path(a, b))

    def path_delay_s(self, a: str, b: str) -> float:
        return sum(l.delay_s for l in self.path(a, b))

    def p2p_time_s(self, nbytes: float, a: str, b: str) -> float:
        """Store-and-forward approximated as bottleneck + total delay."""
        if a == b:
            return 0.0
        return self.path_delay_s(a, b) + nbytes / self.path_bw_Bps(a, b)

    def access_bw_Bps(self, dev: str) -> float:
        return self.links[(dev, self._region_node(self.device_region[dev]))] \
            .bw_Bps

    def group_bottleneck_bw_Bps(self, group: Sequence[str]) -> float:
        """Slowest pairwise path bandwidth within a participant group."""
        bws = [self.access_bw_Bps(d) for d in group]
        if len({self.device_region[d] for d in group}) > 1:
            bws.append(self.params.wan_bw_Bps)
        return min(bws)

    def group_max_delay_s(self, group: Sequence[str]) -> float:
        """Worst one-hop neighbour delay a ring/tree step can see."""
        best = 0.0
        for i, a in enumerate(group):
            for b in group[i + 1:]:
                best = max(best, self.path_delay_s(a, b))
        return best
