"""Quickstart on the PyTorch port: train a small foundation model with the
carbon ledger on.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 200] \\
        [--arch opt-125m] [--torch-device cpu]

The torch twin of ``examples/quickstart.py``, with its flags, defaults and
printout: trains a reduced OPT-style model (``--full`` for the published
widths) on the synthetic token pipeline through ``repro_torch``'s trainer,
with attention through the FA-2 CUDA kernels, records per-step energy
through the paper's component-level monitor, and prints the resulting
operational-carbon entry — the paper's §2.2 accounting run on a real
training loop.  It runs on the card; ``--torch-device cpu`` runs the
kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core.carbon.accounting import EDGE_PUE, CarbonLedger
from repro_torch.core.energy.devices import LAPTOP_M2PRO
from repro_torch.core.energy.monitor import ComponentModel, EnergyMonitor
from repro_torch.device import resolve_device
from repro_torch.train.trainer import TrainerConfig, train


def run(cfg, *, steps: int, batch: int, seq: int, device=None,
        params=None):
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device`` (the card unless "cpu" is asked for) under the laptop's
    component energy model, and price the energy on the edge ledger.
    ``params`` are the initial weights (random from seed 0 by default).
    Prints the example's report; returns (trainer result, ledger,
    monitor)."""
    monitor = EnergyMonitor(ComponentModel.for_device(LAPTOP_M2PRO))
    res = train(cfg, TrainerConfig(steps=steps, batch=batch, seq_len=seq,
                                   log_every=20),
                monitor=monitor, params=params, device=device)

    ledger = CarbonLedger()
    ledger.add_operational_wh("quickstart-train", res.energy_wh,
                              pue=EDGE_PUE)
    print(f"\nfinal loss      : {res.final_loss:.4f}")
    print(f"throughput      : {res.steps_per_s:.2f} steps/s")
    print(f"modelled energy : {res.energy_wh:.4f} Wh "
          f"(component model: {LAPTOP_M2PRO.name})")
    print(f"operational CO2 : {ledger.operational_kg*1000:.4f} gCO2e "
          f"(grid {ledger.intensity_kg_per_kwh:.3f} kgCO2e/kWh)")
    return res, ledger, monitor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the arch's full geometry (slow on CPU)")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(num_layers=4, d_model=256, vocab_size=2048)
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")
    run(cfg, steps=args.steps, batch=args.batch, seq=args.seq, device=dev)


if __name__ == "__main__":
    main()
