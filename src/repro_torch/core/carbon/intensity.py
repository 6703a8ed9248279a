"""Grid carbon intensity (kgCO2e/kWh) — data per carbonfootprint.com [20].

The paper's Figs 4-5 use the average across North America and Europe for
2021-23.  A small per-region table and a diurnal solar-availability proxy
support the carbon-aware scheduler (§5: "charging during cleaner energy
hours").  A copy of ``repro.core.carbon.intensity``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

# yearly averages, kgCO2e/kWh [20]
INTENSITY_BY_REGION: Dict[str, Dict[int, float]] = {
    "north_america": {2021: 0.38, 2022: 0.37, 2023: 0.36},
    "europe": {2021: 0.28, 2022: 0.30, 2023: 0.26},
    "nordics": {2021: 0.03, 2022: 0.03, 2023: 0.03},
    "east_asia": {2021: 0.55, 2022: 0.54, 2023: 0.53},
    "india": {2021: 0.71, 2022: 0.71, 2023: 0.70},
}

PAPER_YEARS = (2021, 2022, 2023)


def paper_average_intensity() -> float:
    """Mean over NA+EU, 2021-23 — the Figs 4-5 convention."""
    vals = [INTENSITY_BY_REGION[r][y]
            for r in ("north_america", "europe") for y in PAPER_YEARS]
    return sum(vals) / len(vals)


@dataclass(frozen=True)
class IntensityTrace:
    """Diurnal intensity model: base grid CI modulated by solar availability
    (clean window around local noon).  Supports §5 carbon-aware scheduling."""

    region: str = "europe"
    year: int = 2023
    solar_fraction: float = 0.35    # max midday CI reduction

    def at_hour(self, hour_utc: float, tz_offset: float = 0.0) -> float:
        base = INTENSITY_BY_REGION[self.region][self.year]
        local = (hour_utc + tz_offset) % 24.0
        # clean window 8:00-18:00 peaking at 13:00
        solar = max(0.0, math.cos((local - 13.0) / 5.5 * math.pi / 2))
        return base * (1.0 - self.solar_fraction * solar)

    def daily_mean(self, tz_offset: float = 0.0) -> float:
        return sum(self.at_hour(h, tz_offset) for h in range(24)) / 24.0
