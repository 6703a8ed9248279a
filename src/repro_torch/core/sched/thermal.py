"""Thermal-throttling model for edge devices (§5: "susceptible to thermal
throttling... sustained compute loads cause slowdowns"; the port's copy
of ``repro.core.sched.thermal``).

First-order RC model: package temperature follows
    dT/dt = (P · R_th − (T − T_amb)) / τ
with hardware-imposed frequency scaling once T crosses the throttle point
(linear derating to ``min_perf`` at T_max).  Parameters bracket published
SoC sustained-performance measurements (passively cooled phones throttle to
~60-70% after minutes; actively cooled laptops barely throttle).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


@dataclass(frozen=True)
class ThermalParams:
    r_th_c_per_w: float       # thermal resistance
    tau_s: float              # time constant
    t_ambient_c: float = 25.0
    t_throttle_c: float = 42.0
    t_max_c: float = 48.0
    min_perf: float = 0.55    # floor performance fraction


PHONE_THERMALS = ThermalParams(r_th_c_per_w=2.4, tau_s=90.0)
LAPTOP_THERMALS = ThermalParams(r_th_c_per_w=1.1, tau_s=240.0,
                                t_throttle_c=70.0, t_max_c=95.0,
                                min_perf=0.85)


@dataclass
class ThermalState:
    params: ThermalParams
    temp_c: float = 25.0

    def step(self, power_w: float, dt_s: float) -> float:
        """Advance the RC model; returns the performance factor in [min,1]."""
        p = self.params
        target = p.t_ambient_c + power_w * p.r_th_c_per_w
        alpha = 1.0 - pow(2.718281828, -dt_s / p.tau_s)
        self.temp_c += (target - self.temp_c) * alpha
        return self.perf_factor()

    def perf_factor(self) -> float:
        p = self.params
        if self.temp_c <= p.t_throttle_c:
            return 1.0
        if self.temp_c >= p.t_max_c:
            return p.min_perf
        frac = (self.temp_c - p.t_throttle_c) / (p.t_max_c - p.t_throttle_c)
        return 1.0 - frac * (1.0 - p.min_perf)


@functools.lru_cache(maxsize=None)
def sustained_perf(params: ThermalParams, power_w: float) -> float:
    """Steady-state performance factor under constant load.

    A pure function of its (frozen, hashable) arguments, so it is cached:
    the scheduler prices every candidate device every step, and the
    20·τ-step integration (4,800 steps for a laptop) took 99 % of an
    orchestrator run.  The values are the uncached loop's, bit for bit."""
    st = ThermalState(params)
    for _ in range(int(20 * params.tau_s)):
        f = st.step(power_w * st.perf_factor(), 1.0)
    return st.perf_factor()
