"""Edge-fleet orchestration demo on the PyTorch port: the paper's §4-§5
vision, end to end.

    PYTHONPATH=src python examples/torch_edge_carbon_sim.py [--steps 300] \\
        [--torch-device cpu]

The torch twin of ``examples/edge_carbon_sim.py``, with its flags,
defaults and printout: simulates training OPT-125m over a dynamic,
heterogeneous edge fleet (laptops + smartphones across clean/dirty grids)
with the port's orchestration layer (carbon-aware admission, thermal
throttling, churn, checkpoint-based fault tolerance), compares
carbon-blind vs carbon-aware policies and prints the offloading analysis
of §4.2 Figs. 4-5 for the fleet's device classes.  The simulation runs on
the host; like every entry point of the port it asks for the card unless
``--torch-device cpu`` is given.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.opt import opt_config
from repro_torch.core.carbon.offload import (baseline_footprint,
                                             offload_analysis)
from repro_torch.core.energy.devices import (CLOUD_H100, LAPTOP_M2PRO,
                                             SMARTPHONE_SD888)
from repro_torch.core.sched.carbon_aware import carbon_rate
from repro_torch.core.sched.orchestrator import (Orchestrator, SimConfig,
                                                 make_fleet)
from repro_torch.device import resolve_device


def example_fleet():
    """8 laptops and 16 phones over nordics, europe and india (seed 3)."""
    return make_fleet({"laptop-m2pro": 8, "smartphone-sd888": 16},
                      regions=("nordics", "europe", "india"), seed=3)


def median_rate(fleet) -> float:
    """The fleet's median gCO2e/GFLOP at noon UTC: the carbon-aware
    policy's admission threshold."""
    rates = sorted(carbon_rate(d, 12.0, {})[0] for d in fleet)
    return rates[len(rates) // 2]


def run_policy(cfg, fleet, steps: int, threshold: float, label: str):
    sim = SimConfig(total_steps=steps, seed=7,
                    carbon_threshold_g_per_gflop=threshold)
    res = Orchestrator(cfg, fleet, sim).run()
    print(f"\n--- {label} ---")
    print(f"  wall time          : {res.wall_time_s/3600:.2f} h")
    print(f"  throughput         : {res.throughput_steps_per_hour:.1f} steps/h")
    print(f"  energy             : {res.energy_wh:.1f} Wh")
    print(f"  operational carbon : {res.carbon_kg*1000:.2f} gCO2e")
    print(f"  rework (fault)     : {res.rework_steps} steps")
    print(f"  membership changes : {res.membership_changes}")
    print(f"  mean active devices: {res.mean_active_devices:.1f}")
    return res


def compare_policies(cfg, fleet, steps: int):
    """Carbon-blind (threshold infinity) against carbon-aware (the median
    rate).  Returns (blind, aware) ``SimResult``s."""
    blind = run_policy(cfg, fleet, steps, float("inf"),
                       "carbon-blind (admit everyone charging)")
    aware = run_policy(cfg, fleet, steps, median_rate(fleet),
                       "carbon-aware (admit below median gCO2e/GFLOP)")
    if aware.carbon_kg > 0:
        print(f"\ncarbon-aware saves "
              f"{(1 - aware.carbon_kg/blind.carbon_kg)*100:.0f}% CO2e at "
              f"{aware.throughput_steps_per_hour/blind.throughput_steps_per_hour:.2f}x"
              " the throughput")
    return blind, aware


def offload_table():
    """The paper's offloading headline, §4.2 Fig. 5, for this fleet's
    classes; returns {device name: (footprint, analysis)}."""
    print("\n--- offloading analysis (one H100 replaced, 3 years) ---")
    rows = {}
    for dev in (SMARTPHONE_SD888, LAPTOP_M2PRO):
        fp = baseline_footprint(dev)
        out = offload_analysis(dev, CLOUD_H100, use_paper_counts=True)
        print(f"  {dev.name:18s} ownership {fp.total_kg:7.1f} kg "
              f"({fp.embodied_pct:.0f}% embodied) | fleet of "
              f"{out['device_count']:3d} -> net reduction "
              f"{out['net_reduction_x_no_comm']:.1f}x")
        rows[dev.name] = (fp, out)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--torch-device", default="cuda",
                    help="the port's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.torch_device)

    compare_policies(opt_config("opt-125m"), example_fleet(), args.steps)
    offload_table()


if __name__ == "__main__":
    main()
