"""Grid carbon intensity (kgCO2e/kWh) — data per carbonfootprint.com [20].

The paper's Figs 4-5 use the average across North America and Europe for
2021-23 (a copy of the table in ``repro.core.carbon.intensity``).
"""

from __future__ import annotations

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
