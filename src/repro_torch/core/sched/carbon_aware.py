"""Carbon-aware device selection (§5: "thermal- and carbon-aware device
selection", "reward participation in low-carbon energy windows"; the
port's copy of ``repro.core.sched.carbon_aware``).

Each candidate device is priced in gCO2e per useful GFLOP:

    marginal carbon rate = (P_active · CI_region(t)) / (peak · MFU · perf(T))
    [+ embodied surcharge if participation shortens device lifetime]

The scheduler greedily picks the cheapest-carbon devices until the fleet
meets a throughput target, preferring devices currently in a clean-energy
window and derating thermally-hot devices — directly operationalizing the
paper's two §5 bullets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.carbon.intensity import IntensityTrace
from repro_torch.core.energy.devices import DeviceSpec
from repro_torch.core.sched.thermal import (LAPTOP_THERMALS, PHONE_THERMALS,
                                      ThermalParams, ThermalState,
                                      sustained_perf)


@dataclass
class FleetDevice:
    spec: DeviceSpec
    region: str = "europe"
    tz_offset: float = 0.0
    charging: bool = True
    wear_surcharge: float = 0.0      # extra embodied gCO2e/h if wear matters
    thermal: Optional[ThermalParams] = None
    device_id: int = 0

    def thermal_params(self) -> ThermalParams:
        if self.thermal is not None:
            return self.thermal
        return PHONE_THERMALS if self.spec.kind == "smartphone" \
            else LAPTOP_THERMALS


@dataclass(frozen=True)
class Selection:
    device_id: int
    gco2e_per_gflop: float
    effective_flops: float


def carbon_rate(dev: FleetDevice, hour_utc: float,
                trace_cache: Dict[str, IntensityTrace]) -> Tuple[float, float]:
    """(gCO2e per GFLOP of useful work, sustained effective FLOP/s)."""
    trace = trace_cache.setdefault(dev.region, IntensityTrace(dev.region))
    ci = trace.at_hour(hour_utc, dev.tz_offset)          # kg/kWh
    perf = sustained_perf(dev.thermal_params(), dev.spec.power_active_w)
    eff = dev.spec.effective_flops * perf
    kg_per_s = dev.spec.power_active_w / 1000.0 / 3600.0 * ci
    g_per_gflop = kg_per_s * 1000.0 / (eff / 1e9) + dev.wear_surcharge
    return g_per_gflop, eff


def select_fleet(candidates: Sequence[FleetDevice], *,
                 target_flops: float, hour_utc: float = 12.0,
                 require_charging: bool = True) -> List[Selection]:
    """Greedy min-carbon selection meeting a throughput target."""
    cache: Dict[str, IntensityTrace] = {}
    priced: List[Selection] = []
    for d in candidates:
        if require_charging and not d.charging:
            continue
        rate, eff = carbon_rate(d, hour_utc, cache)
        priced.append(Selection(d.device_id, rate, eff))
    priced.sort(key=lambda s: s.gco2e_per_gflop)
    out: List[Selection] = []
    acc = 0.0
    for s in priced:
        if acc >= target_flops:
            break
        out.append(s)
        acc += s.effective_flops
    return out


def fleet_carbon_rate(selection: Sequence[Selection]) -> float:
    """Aggregate gCO2e/GFLOP of a selected fleet (throughput-weighted)."""
    tot_f = sum(s.effective_flops for s in selection)
    if tot_f == 0:
        return 0.0
    return sum(s.gco2e_per_gflop * s.effective_flops
               for s in selection) / tot_f
