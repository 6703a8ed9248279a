"""Trainer loop: the train step + data pipeline + the energy monitor wired
per step (port of ``repro.train.trainer``, single host).

The hot loop never waits for the card unless asked to:

* **in-place update** — the step writes parameters and AdamW moments in
  place (the JAX trainer donated their buffers to the jit);
* **device-resident metrics** — each step's loss, grad norm and lr stay
  on the device; the loop copies them to the host once per ``log_every``
  window (and once at the end), one ``.tolist()`` for the whole window;
* **prefetch** — the next batch is copied host -> device through pinned
  memory with a ``non_blocking`` copy right after the step is queued, so
  data generation and transfer overlap the card's compute.

Passing an ``EnergyMonitor`` opts back into one sync per step: energy
accounting needs each step's true wall-clock time.

With the global tracer on, each ``step`` is a device phase (its
``train/step_s`` histogram holds device seconds, as do the train step's
own ``fwd_bwd`` / ``accumulate`` / ``compress`` / ``adamw`` phases), and
``data`` is a host span: the loop's wait for its next batch (generation,
pinning and the copy's enqueue).  The phases are read where the loop
already syncs: the metrics drain and the end.  ``checkpoint_dir`` /
``checkpoint_every`` save ``{"params", "opt"}`` in the JAX package's
format (``repro_torch.checkpoint``): the leaf-modulo layout, or with
``checkpoint_placement`` the elastic layer-sliced one, sharded by the
placement's stage boundaries with ``checkpoint_replication`` neighbour
copies.  ``resume`` restores the newest complete checkpoint, written by
either package under any layout and boundaries, first.

Under an ambient ``(data, model)`` mesh (``act_sharding.use_mesh``, on
every rank of it: ``distributed.spmd.train``) the same loop trains on
DTensors: the weights are placed by ``sharding.shard_params`` (each rank
keeps its block of the full tensors it was given, so the caller's
tensors are not updated), the AdamW moments with them, and every batch by
``shard_batch``; the metrics come back whole (``plain``), the same on
every rank.  Checkpoints are saved one leaf-modulo shard a rank and
restored into each rank's blocks (``repro_torch.checkpoint``); only rank
0 prints.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import flops as F
from repro_torch.core.energy.monitor import EnergyMonitor
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.act_sharding import current_mesh, mesh_rank
from repro_torch.models import params as PM
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import (DeviceAccumulator, MetricsRegistry,
                                     fetch_scalars)
from repro_torch.obs.trace import get_tracer
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

PyTree = Any


@dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 256
    log_every: int = 10
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_placement: Any = None   # PlacementSpec/CheckpointSpec: save
                                       # layer-sliced by stage (elastic)
    checkpoint_replication: int = 0    # §5 neighbour shard copies
    resume: bool = False        # restore the newest complete checkpoint
    remat: str = "none"         # "none" | "full" | "dots" | "dots_no_batch"
    attn_impl: str = "kernel"   # "naive" | "chunked" | "kernel"
    microbatches: int = 1
    donate: bool = True         # kept for the JAX field set: the update is
                                # always in place
    async_metrics: bool = True  # no per-step host sync; bulk-fetch metrics
    prefetch: bool = True       # stage the next batch while the card works
    seed: int = 0


@dataclass
class TrainerResult:
    losses: List[float] = field(default_factory=list)
    steps_per_s: float = 0.0            # includes the first step
    steady_steps_per_s: float = 0.0     # excludes the first step
    compile_time_s: float = 0.0         # first-step time (kernel builds)
    energy_wh: float = 0.0
    final_loss: float = float("nan")
    resumed_from_step: int = 0          # 0 when starting fresh


def _to_device(batch: Dict[str, np.ndarray], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """numpy batch -> device tensors; through pinned memory and an
    asynchronous copy when the device is a card.  Under an ambient mesh,
    DTensors placed by ``sharding.shard_batch`` (every rank holds the
    same whole batch and keeps its rows)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.distributed.sharding import shard_batch
        out = shard_batch(out, mesh)
    return out


def _placed(cfg: ModelConfig, params: PyTree) -> PyTree:
    """``params`` placed by ``sharding.shard_params`` under an ambient
    mesh; as they are without one."""
    mesh = current_mesh()
    if mesh is None:
        return params
    from repro_torch.distributed.sharding import shard_params
    return shard_params(params, cfg, mesh)


def _say(msg: str) -> None:
    if mesh_rank()[0] == 0:
        print(msg)


def train(cfg: ModelConfig, tc: TrainerConfig,
          opt_cfg: Optional[adamw.OptConfig] = None,
          monitor: Optional[EnergyMonitor] = None,
          metrics: Optional[MetricsRegistry] = None, health=None, *,
          params: Optional[PyTree] = None,
          device: DeviceLike = None,
          step_hook: Optional[Callable[[Callable], Callable]] = None
          ) -> TrainerResult:
    """Train ``cfg`` for ``tc.steps`` steps on ``device`` (the card unless
    ``"cpu"`` is asked for).  ``params`` are the initial weights (for
    example bridged from the JAX package), updated in place (placed
    copies under a mesh); by default they are drawn with
    ``init_params(seed=tc.seed)``.  ``metrics`` opts
    into loss / grad-norm histograms, batched in a
    :class:`DeviceAccumulator` and drained at the log-window syncs.
    ``health`` (a :class:`repro_torch.obs.HealthMonitor`) receives every
    loss the loop fetches, at the same sync points, never adding one.
    ``step_hook`` wraps the train step: ``spmd.train`` times each step
    and counts its collectives there, which the tracer's spans cannot do,
    since they neither synchronise the card at the step's bounds nor mark
    its start for resetting the count."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or adamw.OptConfig(
        learning_rate=3e-4, warmup_steps=max(10, tc.steps // 20),
        decay_steps=tc.steps)
    if params is None:
        params = PM.init_params(cfg, device=dev, seed=tc.seed)
    elif any(p.device != dev for p in PM.tree_leaves(params)):
        raise ValueError(f"params must live on {dev}")
    params = _placed(cfg, params)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    start_step = 0
    if tc.resume and tc.checkpoint_dir:
        found = ckpt.latest_complete_step(tc.checkpoint_dir)
        if found is not None:
            live = {"params": params, "opt": opt_state}
            saved = ckpt.restore(tc.checkpoint_dir, live, step=found)
            with torch.no_grad():       # into the caller's tensors
                for dst, src in zip(PM.tree_leaves(live),
                                    PM.tree_leaves(saved)):
                    dst.copy_(src)
            del saved
            start_step = found
            _say(f"[trainer] resumed from step {found} "
                 f"({tc.checkpoint_dir})")
    step_fn = make_train_step(cfg, opt_cfg, remat=tc.remat,
                              attn_impl=tc.attn_impl,
                              microbatches=tc.microbatches)
    if step_hook is not None:
        step_fn = step_hook(step_fn)
    data: Iterator = make_batch_fn(cfg, tc.batch, tc.seq_len, tc.seed)

    step_flops = F.train_flops(cfg, tc.batch, tc.seq_len,
                               remat=tc.remat != "none")
    # the monitor needs true per-step wall clock -> forces the sync path
    sync_every_step = (not tc.async_metrics) or monitor is not None
    result = TrainerResult()
    pending: List[Dict[str, torch.Tensor]] = []   # device-resident metrics
    tr = get_tracer()
    acc = DeviceAccumulator(metrics) if metrics is not None else None

    def fetch(mxs: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
        keys = ("loss", "grad_norm", "lr")
        flat = fetch_scalars([m[k] for m in mxs for k in keys])
        return [dict(zip(keys, flat[i:i + 3]))
                for i in range(0, len(flat), 3)]

    batch = None
    if tc.prefetch:
        with tr.span("data", "train", metric="train/data_s"):
            batch = _to_device(next(data), dev)
    t0 = time.perf_counter()
    t_prev = t0
    for step in range(tc.steps):
        with tr.device_phase("step", "train", device=dev,
                             metric="train/step_s", step=start_step + step):
            if not tc.prefetch:
                with tr.span("data", "train", metric="train/data_s"):
                    batch = _to_device(next(data), dev)
            params, opt_state, mx = step_fn(params, opt_state, batch)
            if tc.prefetch and step + 1 < tc.steps:
                with tr.span("data", "train", metric="train/data_s"):
                    batch = _to_device(next(data), dev)

            host: Optional[Dict[str, float]] = None
            if sync_every_step:
                host = fetch([mx])[0]                # one sync per step
                tr.resolve()
                result.losses.append(host["loss"])
                if health is not None:
                    health.observe_loss(host["loss"])
                if metrics is not None:
                    metrics.histogram("train/loss", lo=1e-4, hi=1e4) \
                        .observe(host["loss"])
                    metrics.histogram("train/grad_norm", lo=1e-4, hi=1e4) \
                        .observe(host["grad_norm"])
            else:
                pending.append(mx)                   # no sync
                if acc is not None:
                    acc.observe("train/loss", mx["loss"])
                    acc.observe("train/grad_norm", mx["grad_norm"])
            if step == 0:
                if host is None and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                result.compile_time_s = time.perf_counter() - t0
            if monitor is not None:
                t_now = time.perf_counter()
                monitor.record_step(flops=step_flops,
                                    duration_s=t_now - t_prev)
                t_prev = t_now
            if tc.log_every and step % tc.log_every == 0:
                if host is None:
                    # drain the whole window in one copy
                    with tr.span("metrics_drain", "train"):
                        fetched = fetch(pending)
                        if acc is not None:
                            acc.drain()
                    tr.resolve()
                    result.losses.extend(m["loss"] for m in fetched)
                    if health is not None:
                        for m in fetched:
                            health.observe_loss(m["loss"])
                    host = fetched[-1]
                    pending.clear()
                _say(f"step {step:5d}  loss {host['loss']:.4f}  "
                     f"gnorm {host['grad_norm']:.3f}  "
                     f"lr {host['lr']:.2e}")
            if tc.checkpoint_every and tc.checkpoint_dir \
                    and (step + 1) % tc.checkpoint_every == 0:
                with tr.span("checkpoint", "train",
                             metric="train/checkpoint_s",
                             step=start_step + step + 1):
                    state = {"params": params, "opt": opt_state}
                    if tc.checkpoint_placement is not None:
                        ckpt.save_for_placement(
                            tc.checkpoint_dir, start_step + step + 1, state,
                            tc.checkpoint_placement,
                            replication=tc.checkpoint_replication)
                    else:
                        ckpt.save(tc.checkpoint_dir, start_step + step + 1,
                                  state)
                    ckpt.prune(tc.checkpoint_dir)
    if pending:
        with tr.span("metrics_drain", "train"):
            fetched = fetch(pending)        # one bulk sync at the end
        result.losses.extend(m["loss"] for m in fetched)
        if health is not None:
            for m in fetched:
                health.observe_loss(m["loss"])
    if acc is not None:
        acc.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tr.resolve()
    if metrics is not None:
        metrics.counter("train/steps").inc(tc.steps)
        metrics.counter("train/tokens").inc(tc.steps * tc.batch * tc.seq_len)
    wall = time.perf_counter() - t0
    result.steps_per_s = tc.steps / wall
    if tc.steps > 1 and wall > result.compile_time_s:
        result.steady_steps_per_s = (tc.steps - 1) / (
            wall - result.compile_time_s)
    else:
        result.steady_steps_per_s = result.steps_per_s
    result.final_loss = result.losses[-1]
    result.resumed_from_step = start_step
    if monitor is not None:
        result.energy_wh = monitor.total_wh
    return result
