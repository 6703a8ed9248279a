"""CO2e accounting: embodied amortization + operational energy (§2.2; a
copy of ``repro.core.carbon.accounting``).

``CarbonLedger`` tracks both components for a device or fleet exactly as the
paper decomposes them:

* embodied: manufacturing/transport/EoL, amortized over the device lifetime
  — incurred by ownership, NOT by our workload (the offloading argument's
  crux: using idle devices adds only operational carbon),
* operational: kWh x grid intensity x PUE.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.carbon.intensity import paper_average_intensity
from repro_torch.core.energy.devices import DeviceSpec

EDGE_PUE = 1.0          # no cooling infrastructure at the edge
DATACENTER_PUE = 1.1    # modern hyperscale PUE (paper cites [1, 67])


@dataclass
class CarbonEntry:
    label: str
    embodied_kg: float = 0.0
    operational_kg: float = 0.0

    @property
    def total_kg(self) -> float:
        return self.embodied_kg + self.operational_kg


@dataclass
class CarbonLedger:
    intensity_kg_per_kwh: float = field(default_factory=paper_average_intensity)
    entries: List[CarbonEntry] = field(default_factory=list)

    def add_embodied(self, label: str, device: DeviceSpec,
                     share_of_lifetime: float = 1.0, count: int = 1
                     ) -> CarbonEntry:
        e = CarbonEntry(label,
                        embodied_kg=device.embodied_kgco2e
                        * share_of_lifetime * count)
        self.entries.append(e)
        return e

    def add_operational_kwh(self, label: str, kwh: float,
                            pue: float = EDGE_PUE,
                            intensity: Optional[float] = None) -> CarbonEntry:
        ci = self.intensity_kg_per_kwh if intensity is None else intensity
        e = CarbonEntry(label, operational_kg=kwh * pue * ci)
        self.entries.append(e)
        # gCO2e rides the enclosing span (if any) onto the timeline
        from repro_torch.obs.trace import get_tracer
        get_tracer().annotate(carbon_g=e.operational_kg * 1000.0)
        return e

    def add_operational_wh(self, label: str, wh: float,
                           pue: float = EDGE_PUE,
                           intensity: Optional[float] = None) -> CarbonEntry:
        return self.add_operational_kwh(label, wh / 1000.0, pue, intensity)

    # ------------------------------------------------------------- totals
    @property
    def embodied_kg(self) -> float:
        return sum(e.embodied_kg for e in self.entries)

    @property
    def operational_kg(self) -> float:
        return sum(e.operational_kg for e in self.entries)

    @property
    def total_kg(self) -> float:
        return self.embodied_kg + self.operational_kg

    def breakdown(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for e in self.entries:
            d = out.setdefault(e.label, {"embodied_kg": 0.0,
                                         "operational_kg": 0.0})
            d["embodied_kg"] += e.embodied_kg
            d["operational_kg"] += e.operational_kg
        return out


def device_operational_kwh(device: DeviceSpec, hours_active_per_day: float,
                           years: float, *, baseline_hours: float = 0.0
                           ) -> float:
    """kWh over ``years`` of use: active training hours + baseline use."""
    days = years * 365.0
    return days * (hours_active_per_day * device.power_active_w
                   + baseline_hours * device.power_idle_w) / 1000.0
