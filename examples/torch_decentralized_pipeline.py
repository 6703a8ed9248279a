"""End to end: DT-FM hybrid data+pipeline training on an edge mesh,
on the PyTorch port — the paper's §5 "distributed training methods for
the edge", executed for real with one process a device.

    EX_DATA=2 EX_STAGES=4 PYTHONPATH=src \\
        python examples/torch_decentralized_pipeline.py [--steps 300] \\
        [--params-m 100] [--torch-device cpu]

The torch twin of ``examples/decentralized_pipeline.py``, with its flags,
``EX_DATA`` / ``EX_STAGES`` (the mesh, 2 x 4 by default), defaults,
printout and loss check.  Starts a (data x stage) mesh of processes
(:func:`repro_torch.distributed.runtime.spawn`; each process is one edge
participant, all on the card, or on the CPU with ``--torch-device cpu``,
joined by gloo, which stages the card's activations through host memory),
splits an OPT-style decoder into pipeline stages and trains with GPipe
microbatching through :func:`repro_torch.distributed.pipeline.
pipeline_train_step`.  Loss must decrease; the script also prints the
DT-FM analytic plan (step time, bubble, per-device energy) for the same
fleet, and the non-uniform split the placement search hands a fleet with
a smartphone, executed by the same pipeline.

Default geometry is a ~14M-param model for a quick run; --params-m 100
trains a ~100M-param model.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
from typing import List, NamedTuple, Optional

import numpy as np

from repro_torch.configs.opt import opt_config
from repro_torch.core.energy.devices import LAPTOP_M2PRO, SMARTPHONE_SD888
from repro_torch.core.placement import ordered_placement
from repro_torch.core.planner import dtfm
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.distributed import pipeline, runtime
from repro_torch.optim import adamw

DATA = int(os.environ.get("EX_DATA", "2"))
STAGES = int(os.environ.get("EX_STAGES", "4"))


def model_config(params_m: int):
    """The example's geometry: ~14M params, or ~100M (OPT-125m's with a
    smaller vocab) for ``params_m >= 100``."""
    base = opt_config("opt-125m")
    if params_m >= 100:
        return dataclasses.replace(base, name="opt-100m-pipe",
                                   vocab_size=8192)
    return dataclasses.replace(base, name="opt-14m-pipe", num_layers=8,
                               d_model=384, num_heads=8, num_kv_heads=8,
                               head_dim=48, d_ff=1536, vocab_size=4096)


class PipelineExample(NamedTuple):
    """What :func:`run` measured and planned: the step losses, the rank
    0 training wall seconds, the DT-FM plan, the heterogeneous placement,
    the non-uniform split's loss (None when the placement found another
    stage count) and the runs' FA-2 launches summed over the ranks."""
    losses: List[float]
    wall_s: float
    plan: dtfm.DTFMPlan
    spec: object           # the PlacementSpec
    nonuniform_loss: Optional[float]
    launches: List[dict]


def plan_report(cfg, *, data: int, stages: int, batch: int, seq: int,
                microbatches: int):
    """The analytic DT-FM plan for ``stages`` laptops x ``data`` pipelines
    and its printed lines (host arithmetic, the same on any device)."""
    plan = dtfm.plan(cfg, [LAPTOP_M2PRO] * stages, batch=batch,
                     seq_len=seq, microbatches=microbatches,
                     data_parallel=data)
    lines = [f"\nDT-FM analytic plan ({stages} laptops x {data} pipelines):",
             f"  step time {plan.step_time_s:.2f}s  "
             f"bubble {plan.bubble_fraction:.2f}  "
             f"comm {plan.comm_s_per_step:.2f}s/step  "
             f"energy {plan.total_energy_wh_per_step*1000:.2f} mWh/step"]
    return plan, lines


def run(cfg, *, data: int, stages: int, steps: int, batch: int, seq: int,
        microbatches: int, device=None, params=None) -> PipelineExample:
    """Train ``cfg`` for ``steps`` pipelined steps on a ``data x stages``
    mesh of gloo ranks on ``device`` (the card unless "cpu" is asked
    for), from ``params`` (the full tree; random from seed 0 by default),
    on ``make_batch_fn(cfg, batch, seq, seed=0)``'s batches; then run the
    heterogeneous fleet's non-uniform split on fresh weights (seed 1) and
    the next batch.  Prints the example's report."""
    dev = resolve_device(device)
    print(f"model: {cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.num_layers} layers")
    print(f"mesh: {data} data x {stages} stages "
          f"({data*stages} simulated edge devices)")
    opt_cfg = adamw.OptConfig(learning_rate=3e-4, warmup_steps=20,
                              decay_steps=steps)
    calls = [functools.partial(
        pipeline.train, cfg=cfg, opt_cfg=opt_cfg, steps=steps, batch=batch,
        seq_len=seq, num_microbatches=microbatches, params=params, seed=0)]
    # the same contract, heterogeneous: a smartphone joins, the placement
    # search hands it fewer layers, and the SAME executor runs that
    # non-uniform split (boundaries flow spec -> pipeline)
    hetero = [LAPTOP_M2PRO] * (stages - 1) + [SMARTPHONE_SD888]
    spec = ordered_placement(cfg, hetero)
    if len(spec.boundaries) - 1 == stages:
        stream = make_batch_fn(cfg, batch, seq, seed=0)
        for _ in range(steps):
            next(stream)
        calls.append(functools.partial(
            pipeline.evaluate, cfg=cfg, batch=next(stream),
            num_microbatches=microbatches, boundaries=spec.boundaries,
            seed=1))
    res = runtime.spawn(calls, data=data, stages=stages, transport="gloo",
                        device=dev)
    trained = res.values[0][0]
    losses, wall = trained.losses, sum(trained.wall_ms) / 1e3
    for step in range(0, steps, 20):
        print(f"step {step:4d}  loss {losses[step]:.4f}")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({steps} steps, {wall:.0f}s, {steps/wall:.2f} steps/s)")

    plan, lines = plan_report(cfg, data=data, stages=stages, batch=batch,
                              seq=seq, microbatches=microbatches)
    print("\n".join(lines))
    print(f"\nheterogeneous placement (1 phone joins):\n{spec.describe()}")
    nonuniform = None
    if len(calls) > 1:
        nonuniform = res.values[1][0]["loss"]
        print(f"  non-uniform split {spec.layer_counts} executes: "
              f"loss {nonuniform:.4f}")
    return PipelineExample(losses, wall, plan, spec, nonuniform,
                           res.launches)


def check_learned(losses: List[float]) -> None:
    """The example's criterion: the mean of the last 10 losses at least
    0.3 below the mean of the first 10."""
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    if not last < first - 0.3:
        raise AssertionError("pipeline training failed to learn")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--params-m", type=int, default=14,
                    help="~model size in millions (14 quick | 100 full)")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the ranks run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)
    res = run(model_config(args.params_m), data=DATA, stages=STAGES,
              steps=args.steps, batch=args.batch, seq=args.seq,
              microbatches=args.microbatches, device=dev)
    check_learned(res.losses)


if __name__ == "__main__":
    main()
