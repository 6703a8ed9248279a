"""Traffic kind ``local_sgd``: the port's synchronous DiLoCo loop
(``repro_torch.train.local_sgd.train_local_sgd``) on the seed's weights
and the program's per-replica batch streams.

Cell parameters (``traffic_params``): ``replicas``, ``inner_steps``,
``batch``, ``seq_len``, ``outer_lr``, ``outer_momentum``, ``nesterov``,
``compress`` (``int8`` or ``none``), ``block``, ``error_feedback``,
``check_rounds`` (rounds the reference follows, before the window) and
``opt`` (the inner AdamW ``OptConfig``).  Set-up makes the weights and
warms every shape with two rounds, the second of which sizes the window:
the loop fetches each round's losses, so a round's first step starts on
an idle card.  The timed call then runs the check rounds and the
window's rounds as one call.

The loop takes no step hook, so the tap is put around the train step it
builds: ``make_train_step`` as ``repro_torch.train.local_sgd`` imports
it, for the timed call only.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Dict, Iterator

from portbench.lib import flops as FL
from portbench.lib import weights as W
from portbench.lib.harness import Ctx, Run, fa2_work
from portbench.lib.profile import Stretch
from portbench.lib.tap import Tap, Window


MIN_TRACED = 6              # window rounds a traced run needs: round 2
                            # is traced, round 4 again with Python
                            # stacks, round 5's first step ends it


def _configs(ctx: Ctx):
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train.local_sgd import LocalSGDConfig
    from repro_torch.train.trainer import TrainerConfig
    tp = ctx.cell["traffic_params"]
    mc = ModelConfig(**ctx.model)
    comp = None if tp["compress"] == "none" else CompressConfig(
        method=tp["compress"], block=tp["block"],
        error_feedback=tp["error_feedback"])
    ls = LocalSGDConfig(replicas=tp["replicas"],
                        inner_steps=tp["inner_steps"],
                        outer_lr=tp["outer_lr"],
                        outer_momentum=tp["outer_momentum"],
                        nesterov=tp["nesterov"], compress=comp)

    def tc(rounds: int) -> TrainerConfig:
        return TrainerConfig(steps=rounds * tp["inner_steps"],
                             batch=tp["batch"], seq_len=tp["seq_len"],
                             log_every=0, attn_impl="kernel",
                             seed=ctx.data_seed)
    return mc, tc, ls, OptConfig(**tp["opt"]), tp


class _RoundClock:
    """Host time at each round's first inner step."""

    def __init__(self, steps_per_round: int):
        self.k, self.n, self.starts = steps_per_round, 0, []

    def wrap(self, step_fn):
        def step(*args):
            if self.n % self.k == 0:
                self.starts.append(time.perf_counter())
            self.n += 1
            return step_fn(*args)
        return step


@contextlib.contextmanager
def _tapped(tap) -> Iterator[None]:
    from repro_torch.train import local_sgd as LS
    orig = LS.make_train_step

    def make(*a, **kw):
        return tap.wrap(orig(*a, **kw))
    LS.make_train_step = make
    try:
        yield
    finally:
        LS.make_train_step = orig


def run(ctx: Ctx) -> Run:
    import torch

    from repro_torch.train.local_sgd import train_local_sgd
    mc, tc, ls, opt, tp = _configs(ctx)
    R, K = tp["replicas"], tp["inner_steps"]
    dtype = getattr(torch, ctx.model["param_dtype"])
    clock = _RoundClock(R * K)
    with _tapped(clock):
        train_local_sgd(mc, tc(2), ls, opt,
                        params=W.make(ctx.model, ctx.seed, ctx.device, dtype),
                        device=ctx.device)
    round_s = time.perf_counter() - clock.starts[1]
    rounds = max(ctx.min_window, round(ctx.seconds / round_s))
    check = tp["check_rounds"]
    window = Window(ctx.device)
    stretches = [Stretch(2 * R * K, 3 * R * K, device=ctx.device),
                 Stretch(4 * R * K, 5 * R * K, with_stack=True,
                         device=ctx.device)] if ctx.trace else []
    tap = Tap(ctx.model, ctx.seed, ctx.device, check * R * K, opt.b1,
              window, stretches)
    with _tapped(tap):
        # the seed's weights made again and handed over: the loop's first
        # outer step replaces them, and no reference here keeps them on
        # the card through the window
        res = train_local_sgd(mc, tc(check + rounds), ls, opt,
                              params=W.make(ctx.model, ctx.seed, ctx.device,
                                            dtype),
                              device=ctx.device)
    window.close()
    losses = res.losses[check * K:]
    tokens = R * K * tp["batch"] * tp["seq_len"]
    step_flops = FL.train_step_flops(ctx.model, tp["batch"], tp["seq_len"])
    run = Run(window=window, attempted=rounds,
              failed=sum(1 for x in losses if not math.isfinite(x)),
              tokens=rounds * tokens, flops=rounds * R * K * step_flops,
              prog=tap.prog, step_flops=step_flops)
    run.phase_s = dict(res.phase_s)
    run.rounds = res.rounds
    run.work["fa2"] = fa2_work(ctx.model, tp["batch"], tp["seq_len"],
                               ctx.model["num_layers"])
    if tp["compress"] == "int8":
        sp = W.specs(ctx.model)
        run.work["quant8"] = {"block": tp["block"],
                              "elements_per_round": R * [
                                  math.prod(W.get(sp, p)[0])
                                  for p in W.paths(sp)]}
    del res
    if stretches:
        run.trace, run.stack_trace = (s.read() for s in stretches)
        for t in (run.trace, run.stack_trace):
            t.steps, t.rounds = R * K, 1
    return run


def reference(ctx: Ctx, quant: bool = False, rows=None) -> Dict[str, Any]:
    """The plain reference's first ``check_rounds`` rounds from the seed."""
    from portbench.lib import data
    from portbench.reference import train as RT
    tp = ctx.cell["traffic_params"]
    streams = [data.batches(tp["batch"], tp["seq_len"],
                            ctx.model["vocab_size"], ctx.data_seed + 1000 * r)
               for r in range(tp["replicas"])]
    ls = {k: tp[k] for k in ("replicas", "inner_steps", "outer_lr",
                             "outer_momentum", "nesterov", "compress",
                             "block", "error_feedback")}
    return RT.local_sgd(ctx.model, tp["opt"], ls, streams, tp["check_rounds"],
                        ctx.seed, ctx.device, rows=rows, quant=quant)
