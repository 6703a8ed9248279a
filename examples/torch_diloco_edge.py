"""DiLoCo-style low-communication training over a two-region edge fleet, on
the PyTorch port.

    PYTHONPATH=src python examples/torch_diloco_edge.py [--rounds 8] \\
        [--inner 8] [--torch-device cpu]

The torch twin of ``examples/diloco_edge.py``, with its flags, defaults
and printout: trains a reduced OPT-style model with the port's
local-update trainer (:mod:`repro_torch.train.local_sgd`): each replica
runs K inner AdamW steps, then the fleet synchronizes pseudo-gradients
with an int8-compressed hierarchical allreduce (the quant8 CUDA kernels
on the card) whose wide-area cost is priced on the
:mod:`repro_torch.core.net` topology.  ``--torch-device cpu`` runs the
kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.core.energy.devices import LAPTOP_M2PRO
from repro_torch.core.net import NetParams, Topology, sync_cost
from repro_torch.core.sched.carbon_aware import FleetDevice
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.compress import CompressConfig
from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
from repro_torch.train.trainer import TrainerConfig

WAN_BPS = 4e6                   # the example's wide-area link, bytes/s


def edge_topology(replicas: int) -> Topology:
    """One laptop per replica, alternating between europe and north
    america, over a 4 MB/s WAN."""
    fleet = [FleetDevice(spec=LAPTOP_M2PRO,
                         region=("europe", "north_america")[i % 2],
                         device_id=i) for i in range(replicas)]
    return Topology.from_fleet(fleet, params=NetParams(wan_bw_Bps=WAN_BPS))


def run(cfg, *, replicas: int, rounds: int, inner: int, batch: int,
        seq: int, device=None, params=None):
    """``rounds`` sync rounds of ``inner`` AdamW steps a replica on
    ``device`` (the card unless "cpu" is asked for), int8 pseudo-gradient
    sync priced as a hierarchical allreduce over :func:`edge_topology`.
    ``params`` are the initial global weights (random from seed 0 by
    default).  Prints the example's report; returns (local-SGD result,
    the naive every-step fp32 ring's cost)."""
    topo = edge_topology(replicas)
    steps = rounds * inner
    ls = LocalSGDConfig(replicas=replicas, inner_steps=inner,
                        outer_lr=0.7, outer_momentum=0.9,
                        compress=CompressConfig(method="int8"))
    res = train_local_sgd(
        cfg, TrainerConfig(steps=steps, batch=batch,
                           seq_len=seq, log_every=inner),
        ls, adamw.OptConfig(learning_rate=3e-3, warmup_steps=5,
                            decay_steps=steps),
        topology=topo, sync_algorithm="hierarchical", params=params,
        device=device)

    # what the same fleet would pay syncing raw fp32 grads every step
    naive = sync_cost(topo, topo.devices, cfg.param_count(),
                      algorithm="ring", compress=None, dtype_bytes=4)

    print(f"\nfinal round loss     : {res.final_loss:.4f} "
          f"(first {res.round_losses[0]:.4f})")
    print(f"sync wire bytes/round: {res.sync_wire_bytes_per_round/1e6:.2f} MB"
          f" (int8)")
    print(f"modelled sync time   : {res.comm_time_s_per_round:.3f} s/round "
          f"-> {res.comm_time_s_per_step:.3f} s/step amortized")
    print(f"naive every-step sync: {naive.time_s:.3f} s/step "
          f"({naive.time_s / max(res.comm_time_s_per_step, 1e-12):.0f}x "
          f"more wide-area wire time)")
    return res, naive


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--inner", type=int, default=8, help="K inner steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)

    cfg = get_config(args.arch).reduced(num_layers=4, d_model=256,
                                        vocab_size=2048)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M  "
          f"replicas={args.replicas}  K={args.inner}")
    run(cfg, replicas=args.replicas, rounds=args.rounds, inner=args.inner,
        batch=args.batch, seq=args.seq, device=dev)


if __name__ == "__main__":
    main()
