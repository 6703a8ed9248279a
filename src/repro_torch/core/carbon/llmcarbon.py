"""LLMCarbon-style end-to-end footprint estimates (paper Fig. 2; the
port's copy of ``repro.core.carbon.llmcarbon``).

For each foundation model: training compute (PFLOP/s-days) from 6·N·D and
the resulting tCO2e on an H100-class cluster, following the MLCO2/LLMCarbon
methodology the paper uses where official numbers are unavailable.
Models/data from the papers cited in Fig. 2 [18, 22, 65, 69, 70, 84].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.carbon.accounting import DATACENTER_PUE
from repro_torch.core.carbon.intensity import paper_average_intensity
from repro_torch.core.energy.devices import CLOUD_H100


@dataclass(frozen=True)
class TrainedModel:
    name: str
    params: float                  # N
    tokens: float                  # D
    mmlu: Optional[float] = None   # post-training accuracy (Fig. 2a)
    reported_tco2e: Optional[float] = None   # from the model's own paper
    mfu: Optional[float] = None    # training MFU disclosed by the model paper
    grid_intensity: Optional[float] = None   # kgCO2e/kWh disclosed by paper
    source: str = ""


# Fig. 2 model range (public numbers)
FIG2_MODELS = [
    TrainedModel("xlm-r", 0.55e9, 6.3e12, mmlu=0.28, source="XLM-R"),
    TrainedModel("gpt-3", 175e9, 300e9, mmlu=0.439,
                 reported_tco2e=552.0, source="[18] + Patterson et al."),
    TrainedModel("gopher", 280e9, 300e9, mmlu=0.60,
                 reported_tco2e=380.0, source="[69]"),
    TrainedModel("chinchilla", 70e9, 1.4e12, mmlu=0.675, source="[40]"),
    TrainedModel("palm", 540e9, 780e9, mmlu=0.693,
                 reported_tco2e=271.4, mfu=0.462, grid_intensity=0.079,
                 source="[22]: 46.2% MFU, Oklahoma DC clean grid"),
    TrainedModel("llama2-70b", 70e9, 2e12, mmlu=0.689,
                 reported_tco2e=291.4, source="[84]"),
    TrainedModel("gpt-4", 1.8e12, 13e12, mmlu=0.864, source="[65] (est.)"),
]


def train_flops(m: TrainedModel) -> float:
    return 6.0 * m.params * m.tokens


def pflops_day(m: TrainedModel) -> float:
    """Fig. 2a x-axis: PFLOP/s needed to finish training in one day."""
    return train_flops(m) / 86_400.0 / 1e15


def estimated_tco2e(m: TrainedModel, *, mfu: Optional[float] = None,
                    intensity: Optional[float] = None,
                    include_embodied: bool = True) -> float:
    """LLMCarbon-style estimate on an H100 cluster.

    Uses the model paper's own disclosed MFU / grid intensity where
    available (LLMCarbon's convention), catalog defaults otherwise.
    """
    if mfu is None:
        mfu = m.mfu if m.mfu is not None else CLOUD_H100.mfu
    if intensity is None and m.grid_intensity is not None:
        intensity = m.grid_intensity
    ci = paper_average_intensity() if intensity is None else intensity
    gpu_seconds = train_flops(m) / (CLOUD_H100.peak_flops * mfu)
    kwh = gpu_seconds * CLOUD_H100.power_active_w / 3600.0 / 1000.0
    operational = kwh * DATACENTER_PUE * ci
    embodied = 0.0
    if include_embodied:
        gpu_years = gpu_seconds / (3600 * 24 * 365)
        embodied = CLOUD_H100.embodied_kgco2e \
            * gpu_years / CLOUD_H100.lifetime_years
    return (operational + embodied) / 1000.0


def footprint(m: TrainedModel) -> float:
    """Reported number when the model's paper provides one, else estimate."""
    return m.reported_tco2e if m.reported_tco2e else estimated_tco2e(m)


def fig2_table() -> Dict[str, Dict[str, float]]:
    out = {}
    for m in FIG2_MODELS:
        out[m.name] = {
            "params_B": m.params / 1e9,
            "tokens_B": m.tokens / 1e9,
            "pflops_day": pflops_day(m),
            "mmlu": m.mmlu or 0.0,
            "tco2e": footprint(m),
        }
    return out
