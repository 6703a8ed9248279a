"""Component-level energy monitoring (a copy of
``repro.core.energy.monitor``; §5: "holistic, reliable and efficient
energy consumption monitoring").

The paper's proposed direction: accurate component-level energy MODELS that
infer fine-grained consumption, with coarse-grained measurements used for
periodic CALIBRATION.  Implemented here:

* ``ComponentModel`` — per-op energy from first principles: compute J/FLOP,
  memory J/byte, network J/byte (the 0.001 kWh/GB WAN / 0.02 kWh/GB local
  figures from §5 are the defaults),
* ``EnergyMonitor``  — accumulates per-component estimates per training
  step and recalibrates a global scale factor whenever a coarse measurement
  (e.g. a battery/wall-meter reading) arrives — the calibration loop the
  paper asks for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.obs.trace import get_tracer

# §5: WAN transmission ~0.001 kWh/GB; "local computation >= 0.02 kWh/GB"
# (the paper's per-GB *processing* figure, used for comm-vs-compute
# trade-offs, NOT a memory-access energy).  Memory access itself is
# ~100-150 pJ/byte on LPDDR5/HBM — the component model uses that.
WAN_J_PER_BYTE = 0.001 * 3.6e6 / 1e9        # 3.6e-6 J/B
LOCAL_PROCESS_J_PER_BYTE = 0.02 * 3.6e6 / 1e9
MEM_J_PER_BYTE = 1.2e-10                    # ~120 pJ/byte (LPDDR5 class)


@dataclass(frozen=True)
class ComponentModel:
    compute_j_per_flop: float          # P_active / effective_flops
    hbm_j_per_byte: float = MEM_J_PER_BYTE
    net_j_per_byte: float = WAN_J_PER_BYTE
    static_w: float = 0.5              # always-on rail

    @classmethod
    def for_device(cls, device) -> "ComponentModel":
        return cls(compute_j_per_flop=device.power_active_w
                   / device.effective_flops,
                   static_w=device.power_idle_w)


@dataclass
class StepSample:
    flops: float
    hbm_bytes: float
    net_bytes: float
    duration_s: float


@dataclass
class EnergyMonitor:
    model: ComponentModel
    scale: float = 1.0                 # calibration factor
    samples: List[StepSample] = field(default_factory=list)
    estimates_j: List[float] = field(default_factory=list)
    # unscaled per-step estimates: ``estimates_j[i] == raw_j[i] * scale``
    # holds at all times (calibrate rescales every entry), so totals and
    # breakdowns never mix pre-/post-calibration scales
    raw_j: List[float] = field(default_factory=list)

    def record_step(self, *, flops: float, hbm_bytes: float = 0.0,
                    net_bytes: float = 0.0, duration_s: float = 0.0
                    ) -> float:
        """Returns the (calibrated) energy estimate for this step, J."""
        m = self.model
        raw = (flops * m.compute_j_per_flop
               + hbm_bytes * m.hbm_j_per_byte
               + net_bytes * m.net_j_per_byte
               + duration_s * m.static_w)
        e = raw * self.scale
        self.samples.append(StepSample(flops, hbm_bytes, net_bytes,
                                       duration_s))
        self.raw_j.append(raw)
        self.estimates_j.append(e)
        # attach the attribution to whatever phase span is open (trainer
        # step, engine step, sync round) — J lands on the timeline
        get_tracer().annotate(energy_j=e)
        return e

    def calibrate(self, measured_j: float, window: int = 0) -> float:
        """Align the model to a coarse measurement (battery/wall meter)
        over the last ``window`` steps (0 = all), then rescale EVERY
        recorded estimate to the new scale so ``total_j`` /
        ``breakdown_j`` stay on one consistent scale.  The new scale
        divides the window's *unscaled* raw estimates (each entry's raw
        is its estimate divided by the scale in effect when it was
        recorded), so repeated calibrations don't compound.  Returns the
        new scale factor."""
        raw = self.raw_j[-window:] if window else self.raw_j
        if not raw or sum(raw) == 0:
            return self.scale
        self.scale = measured_j / sum(raw)
        self.estimates_j = [r * self.scale for r in self.raw_j]
        return self.scale

    def reset(self) -> None:
        """Drop recorded samples/estimates; calibration scale persists."""
        self.samples.clear()
        self.estimates_j.clear()
        self.raw_j.clear()

    @property
    def total_j(self) -> float:
        return sum(self.estimates_j)

    @property
    def total_wh(self) -> float:
        return self.total_j / 3600.0

    def breakdown_j(self) -> Dict[str, float]:
        m = self.model
        out = {"compute": 0.0, "memory": 0.0, "network": 0.0, "static": 0.0}
        for s in self.samples:
            out["compute"] += s.flops * m.compute_j_per_flop * self.scale
            out["memory"] += s.hbm_bytes * m.hbm_j_per_byte * self.scale
            out["network"] += s.net_bytes * m.net_j_per_byte * self.scale
            out["static"] += s.duration_s * m.static_w * self.scale
        return out
