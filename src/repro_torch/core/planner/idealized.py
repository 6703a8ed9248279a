"""The paper's idealized distributed-training method (§4.2, footnote 1;
the port's copy of ``repro.core.planner.idealized``).

Training is modeled as a DAG of operators distributed by a controller:

* total data transmitted per batch = model size + Σ per-layer intermediate
  results (each transmitted once; gradients aggregated locally, no p2p
  broadcast),
* compute is perfectly divisible across devices (factor out the specifics
  of any real partitioning method),
* per-device energy = active power x compute time + comm-module power x
  comm time + idle power x stall time.

Used for Fig. 3 (cloud vs edge energy across OPT sizes) exactly as the
paper specifies, and as the lower-bound reference the DT-FM planner is
compared against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core import flops as F
from repro_torch.core.energy.devices import DeviceSpec
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class IdealizedPlan:
    model: str
    device: str
    num_devices: int
    compute_s: float
    comm_s: float
    energy_wh: float
    comm_energy_wh: float
    total_energy_wh: float


def devices_required(cfg: ModelConfig, device: DeviceSpec,
                     *, bytes_per_param: float = 16.0) -> int:
    """Devices needed to hold params + optimizer states (fp32 Adam: 16 B)."""
    need = cfg.param_count() * bytes_per_param
    per_dev = device.mem_gb * (2 ** 30) * 0.7       # 70% usable
    return max(1, -(-int(need) // int(per_dev)))


def plan(cfg: ModelConfig, device: DeviceSpec, *, batch: int, seq_len: int,
         steps: int, num_devices: int = 0) -> IdealizedPlan:
    n = num_devices or devices_required(cfg, device)
    total_flops = F.train_flops(cfg, batch, seq_len, remat=False) * steps

    # perfectly divided compute
    compute_s = total_flops / (n * device.effective_flops)

    # idealized communication volume per batch (footnote 1): each device
    # transmits ITS OWN parameters' gradients and ITS OWN layers'
    # intermediates, once, in parallel over its own link — the total volume
    # (model + Σ intermediates) is spread across the fleet, so per-device
    # transfer time divides by n.
    if n > 1:
        vol_per_step = F.param_bytes(cfg, 2) \
            + F.activation_bytes(cfg, batch, seq_len, 2)
        comm_s = vol_per_step * steps / (n * device.net_bw_Bps)
    else:
        comm_s = 0.0

    compute_wh = n * device.power_active_w * compute_s / 3600.0
    comm_wh = n * device.power_comm_w * comm_s / 3600.0
    return IdealizedPlan(cfg.name, device.name, n, compute_s, comm_s,
                         compute_wh, comm_wh, compute_wh + comm_wh)


def fig3_energy(cfg: ModelConfig, device: DeviceSpec, *, batch: int = 16,
                seq_len: int = 512, steps: int = 100) -> Dict[str, float]:
    p = plan(cfg, device, batch=batch, seq_len=seq_len, steps=steps)
    return {"devices": p.num_devices, "energy_wh": p.total_energy_wh,
            "compute_wh": p.energy_wh, "comm_wh": p.comm_energy_wh}
