"""Device catalog — the analytic edge/cloud substrate (a copy of
``repro.core.energy.devices``; the trainer, the serving engine and the
scheduler price with it).

Every constant cites its source.  MFU values are calibrated ONCE against the
paper's Table 1 wall-times (OPT-125m, 100 steps, batch 16, seq 512) and then
held fixed for every other reproduction (Tables 2, Figs 3-5) — the same
discipline the paper applies.

Calibration arithmetic (Table 1):
  model flops  = 6 · 125.2e6 · (16·512·100)  =  6.16e14
  smartphone   : 3510 s  ->  1.76e11 FLOP/s effective
  laptop       : 480 s   ->  1.28e12 FLOP/s effective
  cloud GPU    : 250 s   ->  2.46e12 FLOP/s effective
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    kind: str                      # smartphone | laptop | cloud_gpu | tpu
    peak_flops: float              # fp16/bf16 peak, FLOP/s
    mfu: float                     # calibrated model-flops utilization
    power_active_w: float          # package power under training load
    power_idle_w: float            # baseline draw while waiting/stalled
    power_comm_w: float            # network module power (WiFi ~0.5 W [82])
    mem_gb: float
    net_bw_Bps: float              # symmetric network bandwidth, bytes/s
    embodied_kgco2e: float         # manufacturing+transport+EoL
    lifetime_years: float          # replacement cycle
    hbm_bw_Bps: float = 0.0        # accelerator memory bandwidth
    link_bw_Bps: float = 0.0       # interconnect per link (cloud)
    power_typical_w: float = 0.0   # draw under *typical user* load (Fig. 4);
                                   # 0 -> falls back to power_active_w
    source: str = ""

    @property
    def typical_power_w(self) -> float:
        return self.power_typical_w or self.power_active_w

    @property
    def effective_flops(self) -> float:
        return self.peak_flops * self.mfu


# ----------------------------------------------------------------------- #
# The paper's three measured devices (Table 1) + Fig. 4/5 carbon devices
# ----------------------------------------------------------------------- #

SMARTPHONE_SD888 = DeviceSpec(
    name="smartphone-sd888", kind="smartphone",
    peak_flops=1.5e12,             # Adreno 660 fp16 ~1.49 TFLOPS (vendor)
    mfu=0.117,                     # calibrated: 1.76e11 / 1.5e12
    power_active_w=10.0,           # paper Table 1
    power_idle_w=0.2,              # race-to-sleep between microbatches
    power_comm_w=0.5,              # WiFi module [82]
    mem_gb=8.0,
    net_bw_Bps=10e6,               # paper §4.2: 10 MB/s symmetric
    embodied_kgco2e=56.0,          # iPhone 15 Pro PER [10]: ~66 kg, >80% emb.
    lifetime_years=3.0,
    power_typical_w=3.0,           # interactive use (web/video), not training
    source="paper Table 1 + Apple PER [10] + [82]",
)

LAPTOP_M2PRO = DeviceSpec(
    name="laptop-m2pro", kind="laptop",
    peak_flops=6.8e12,             # M2 Pro 19-core GPU fp16 ~6.8 TFLOPS
    mfu=0.189,                     # calibrated: 1.28e12 / 6.8e12
    power_active_w=15.0,           # paper Table 1
    power_idle_w=3.0,
    power_comm_w=0.5,
    mem_gb=16.0,
    net_bw_Bps=10e6,
    embodied_kgco2e=223.0,         # 16" MacBook Pro PER [9]: 290 kg, ~77% emb.
    lifetime_years=3.0,
    source="paper Table 1 + Apple PER [9]",
)

CLOUD_A5000 = DeviceSpec(
    name="cloud-a5000", kind="cloud_gpu",
    peak_flops=27.8e12,            # A5000 fp16 tensor (dense)
    mfu=0.0886,                    # calibrated: 2.46e12 / 27.8e12
    power_active_w=220.0,          # paper Table 1
    power_idle_w=52.0,
    power_comm_w=0.0,              # NIC power folded into server overhead
    mem_gb=24.0,
    net_bw_Bps=3.125e9,            # 25 GbE
    embodied_kgco2e=150.0,         # MLCO2-style server/8 share
    lifetime_years=3.0,
    hbm_bw_Bps=768e9,
    link_bw_Bps=8e9,
    source="paper Table 1 + MLCO2 [53]",
)

CLOUD_H100 = DeviceSpec(
    name="cloud-h100", kind="cloud_gpu",
    peak_flops=267e12,             # paper §4.2 quotes 267 TFLOPS FP16
    mfu=0.35,                      # typical large-scale training MFU
    power_active_w=700.0,
    power_idle_w=100.0,
    power_comm_w=0.0,
    mem_gb=80.0,
    net_bw_Bps=50e9,
    embodied_kgco2e=960.0,         # 1/8 of a ~7.7 t GPU server [67]
    lifetime_years=3.0,
    hbm_bw_Bps=3.35e12,
    link_bw_Bps=450e9,
    source="paper §4.2 (Figs 4-5) + [67]",
)

TPU_V5E = DeviceSpec(
    name="tpu-v5e", kind="tpu",
    peak_flops=197e12,             # bf16 (assignment constants)
    mfu=0.5,
    power_active_w=170.0,          # chip+share of host, typical
    power_idle_w=60.0,
    power_comm_w=0.0,
    mem_gb=16.0,
    net_bw_Bps=50e9,
    embodied_kgco2e=700.0,
    lifetime_years=3.0,
    hbm_bw_Bps=819e9,              # assignment constants
    link_bw_Bps=50e9,              # ICI per link
    source="assignment hardware constants",
)

CATALOG: Dict[str, DeviceSpec] = {d.name: d for d in [
    SMARTPHONE_SD888, LAPTOP_M2PRO, CLOUD_A5000, CLOUD_H100, TPU_V5E]}


def get_device(name: str) -> DeviceSpec:
    return CATALOG[name]


def train_time_s(device: DeviceSpec, flops: float) -> float:
    return flops / device.effective_flops


def train_energy_wh(device: DeviceSpec, flops: float) -> float:
    """Single-device training energy (paper Table 1 reproduction)."""
    return device.power_active_w * train_time_s(device, flops) / 3600.0
