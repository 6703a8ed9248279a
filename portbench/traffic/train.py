"""Traffic kind ``train``: the port's trainer (``repro_torch.train.trainer.
train``) on the seed's weights and the program's own batch stream.

Cell parameters (``workloads/<cell>.json`` under ``traffic_params``):
``batch``, ``seq_len``, ``microbatches``, ``check_steps`` (steps the
reference follows, before the window) and ``opt`` (every field of the
AdamW ``OptConfig``).  Set-up makes the weights, warms every shape with
two steps at learning rate 0 (the weights come out unchanged) and sizes
the window from the second of them; the timed call then runs the check
steps and the window's steps as one trainer call.
"""

from __future__ import annotations

import math
from typing import Any, Dict

from portbench.lib import flops as FL
from portbench.lib import weights as W
from portbench.lib.harness import Ctx, Run, fa2_work
from portbench.lib.profile import Stretch
from portbench.lib.tap import Tap, Window

STRETCH = (2, 5)            # window steps [2, 5) are traced
STACKS = (7, 10)            # and [7, 10) again with Python stacks
MIN_TRACED = STACKS[1] + 1  # window steps a traced run needs


def _configs(ctx: Ctx):
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import TrainerConfig
    tp = ctx.cell["traffic_params"]
    mc = ModelConfig(**ctx.model)

    def tc(steps: int) -> TrainerConfig:
        return TrainerConfig(steps=steps, batch=tp["batch"],
                             seq_len=tp["seq_len"], log_every=0,
                             microbatches=tp["microbatches"],
                             attn_impl="kernel", seed=ctx.data_seed)
    return mc, tc, OptConfig(**tp["opt"]), tp


def run(ctx: Ctx) -> Run:
    import dataclasses

    import torch

    from repro_torch.train.trainer import train
    mc, tc, opt, tp = _configs(ctx)
    dtype = getattr(torch, ctx.model["param_dtype"])
    params = W.make(ctx.model, ctx.seed, ctx.device, dtype)
    warm = train(mc, tc(2), dataclasses.replace(opt, learning_rate=0.0),
                 params=params, device=ctx.device)
    steps = max(ctx.min_window, round(ctx.seconds * warm.steady_steps_per_s))
    check = tp["check_steps"]
    window = Window(ctx.device)
    stretches = [Stretch(*STRETCH, device=ctx.device),
                 Stretch(*STACKS, with_stack=True, device=ctx.device)
                 ] if ctx.trace else []
    tap = Tap(ctx.model, ctx.seed, ctx.device, check, opt.b1, window,
              stretches)
    res = train(mc, tc(check + steps), opt, params=params,
                device=ctx.device, step_hook=tap.wrap)
    window.close()
    del params
    tokens = tp["batch"] * tp["seq_len"]
    step_flops = FL.train_step_flops(ctx.model, tp["batch"], tp["seq_len"])
    losses = res.losses[check:]
    run = Run(window=window, attempted=steps,
              failed=sum(1 for x in losses if not math.isfinite(x)),
              tokens=steps * tokens, flops=steps * step_flops,
              prog=tap.prog, step_flops=step_flops)
    mb = tp["microbatches"]
    run.work["fa2"] = fa2_work(ctx.model, tp["batch"] // mb, tp["seq_len"],
                               ctx.model["num_layers"] * mb)
    if stretches:
        run.trace, run.stack_trace = (s.read() for s in stretches)
        run.trace.steps = STRETCH[1] - STRETCH[0]
        run.stack_trace.steps = STACKS[1] - STACKS[0]
    return run


def reference(ctx: Ctx, quant: bool = False, rows=None) -> Dict[str, Any]:
    """The plain reference's first ``check_steps`` steps from the seed."""
    from portbench.lib import data
    from portbench.reference import train as RT
    tp = ctx.cell["traffic_params"]
    stream = data.batches(tp["batch"], tp["seq_len"],
                          ctx.model["vocab_size"], ctx.data_seed)
    return RT.trainer(ctx.model, tp["opt"], stream, tp["check_steps"],
                      ctx.seed, ctx.device, microbatches=tp["microbatches"],
                      rows=rows, quant=quant)


