"""Local-update (DiLoCo-style) low-communication training (port of
``repro.train.local_sgd``, single host).

Each replica runs K inner optimizer steps on its own data stream, then the
fleet synchronizes once on the **pseudo-gradient**

    delta_r = global_params - local_params_r          (after K steps)

with an outer Nesterov-momentum SGD applied to the averaged delta:

    m   <- mu * m + mean_r(delta_r)
    upd <- mean_r(delta_r) + mu * m      (Nesterov;  upd <- m  otherwise)
    global <- global - outer_lr * upd

The pseudo-gradients pass through the gradient compressors
(``optim/compress.py``: int8 through the quant8 CUDA kernels on the card,
or top-k, with per-replica error feedback), and the sync is priced on a
wide-area :class:`repro_torch.core.net.Topology`.

Two outer-loop modes, as in the JAX package:

* **Synchronous** (default): every round waits for all replicas.  With
  ``inner_steps=1``, ``outer_momentum=0``, ``outer_lr=1`` and one replica
  the outer loop is the identity and the trajectory is the plain
  trainer's.
* **Bounded-staleness async** (``async_mode=True``): the outer update
  applies once ``quorum`` replicas have reported; late deltas fold into
  the next update with weight ``1/(1+staleness)`` up to
  ``staleness_bound`` and are dropped (the replica re-synced) past it.
  With ``quorum = replicas`` and ``staleness_bound = 0`` it is
  bit-identical to the synchronous loop.

Both modes drive a modelled virtual fleet clock (per-replica step times
from a placement's device specs, or ``nominal_step_s``) and consume a
seeded :class:`FaultPlan` (stragglers, crash/rejoin, link flaps) exactly as
the JAX package does.  A :class:`~repro_torch.core.placement.PlacementSpec`
maps the replicas onto its region groups: the sync is priced per stage
slot over that slot's replica nodes, each region runs its own K (slow
regions proportionally fewer inner steps), and checkpoints are written
layer-sliced by its stage boundaries with neighbour copies.  A
:class:`~repro_torch.obs.HealthMonitor` sees only observed durations and
losses; in async mode the quorum barrier shrinks past the replicas it has
flagged as stragglers.

The replicas run one after the other on one device.  The JAX loop kept
every array immutable; here the train step updates its parameters in
place, so each replica trains a working copy that is refilled from the
global parameters before its inner steps (one copy, reused replica after
replica), and every outer update writes the new global parameters into
new tensors, so a snapshot an async replica still holds never changes
under it.  Pseudo-gradients are formed, compressed and accumulated leaf by
leaf: the loop never holds a second fp32 copy of the whole model beyond
the accumulator.  Per round the host syncs with the device once (the loss
fetch), unless an ``EnergyMonitor`` asks for one per step.
``LocalSGDResult.phase_s`` adds up the device time of the inner steps,
the pseudo-gradients with their compression, the outer updates and the
checkpoints, taken with CUDA events on the card (host clock on the CPU)
by an always-on ``obs.trace.PhaseClock``, folded at each loss fetch.
With the global tracer on, ``inner_step`` (``local_sgd/inner_step_s``),
each leaf's ``compress`` and ``outer_sync`` are device phases of the
tracer, and ``data`` a host span around each inner step's batch.

Under an ambient ``(data, model)`` mesh (``act_sharding.use_mesh``, on
every rank of it: ``distributed.spmd.local_sgd``) the same loops run
with every piece of state a DTensor placed as its parameter
(``sharding.param_shardings``): the global parameters, the working copy,
the outer momentum, the accumulator, each replica's AdamW moments and
error feedback.  The replicas still take turns, now on the one mesh (the
JAX loop keeps them host-side as independent copies on whatever mesh is
ambient); the inner steps are ``make_train_step`` on DTensors, the
pseudo-gradients are compressed on each rank's blocks
(``optim.compress``), and the outer update is elementwise on the local
blocks, with no collective.  The wire bytes, the modelled sync and the
virtual clock come from the global shapes and the losses, which every
rank holds whole and alike, so every rank takes every branch (quorum,
staleness, fault plan, health) the same way.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import flops as F
from repro_torch.core.energy.monitor import EnergyMonitor
from repro_torch.core.faultinject import FaultInjector, FaultPlan
from repro_torch.core.net import sync_cost
from repro_torch.core.placement import PlacementSpec
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.act_sharding import zeros_beside
from repro_torch.models import params as PM
from repro_torch.models.config import ModelConfig
from repro_torch.obs.health import HealthMonitor
from repro_torch.obs.metrics import MetricsRegistry, fetch_scalars
from repro_torch.obs.trace import PhaseClock, get_tracer
from repro_torch.optim import adamw
from repro_torch.optim.compress import (CompressConfig, compress_leaf,
                                        wire_bytes)
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import (TrainerConfig, _placed, _say,
                                       _to_device)

PyTree = Any
Leaves = List[torch.Tensor]


@dataclass(frozen=True)
class LocalSGDConfig:
    replicas: int = 4
    inner_steps: int = 16            # K: inner steps per sync round
    outer_lr: float = 0.7            # DiLoCo outer Nesterov defaults
    outer_momentum: float = 0.9
    nesterov: bool = True
    compress: Optional[CompressConfig] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every_rounds: int = 0
    checkpoint_replication: int = 1  # §5 neighbour shard copies
    resume: bool = False             # restore newest complete ckpt first
    # ---- bounded-staleness async outer loop -------------------------
    async_mode: bool = False         # quorum-gated outer updates
    quorum: Optional[int] = None     # Q (None -> all replicas)
    staleness_bound: int = 0         # S: max global-version lag
    nominal_step_s: float = 0.1      # modelled inner-step seconds


@dataclass
class LocalSGDResult:
    losses: List[float] = field(default_factory=list)     # replica-0, per step
    round_losses: List[float] = field(default_factory=list)  # fleet mean
    final_loss: float = float("nan")
    rounds: int = 0
    resumed_from_round: int = 0              # 0 when starting fresh
    steps_per_s: float = 0.0
    sync_wire_bytes_per_round: int = 0
    comm_time_s_per_round: float = 0.0       # modelled, if topology given
    comm_time_s_per_step: float = 0.0        # amortized over K inner steps
    energy_wh: float = 0.0
    replica_regions: List[str] = field(default_factory=list)  # per replica,
                                             # when a placement maps them
    sync_wan_bytes_per_round: float = 0.0    # modelled WAN share
    # ---- async / fault-injection accounting -------------------------
    mode: str = "sync"
    outer_updates: int = 0                   # == rounds in sync mode
    per_replica_k: List[int] = field(default_factory=list)
    inner_steps_total: int = 0               # steps actually run
    contributed_steps: int = 0               # steps whose deltas merged
    dropped_stale: int = 0                   # deltas past the S bound
    late_merged: int = 0                     # deltas folded with s >= 1
    resyncs: int = 0
    crashes: int = 0
    virtual_time_s: float = 0.0              # modelled fleet wall-clock
    virtual_tokens_per_s: float = 0.0        # contributed tokens / vclock
    fault_counts: Dict[str, int] = field(default_factory=dict)
    # ---- health-driven response accounting ---------------------------
    health_excluded_updates: int = 0         # outer updates that went
                                             # ahead without a detected
                                             # straggler (quorum shrunk)
    health_summary: Optional[Dict[str, Any]] = None
    # ---- the port's own ------------------------------------------------
    # device seconds over the run: "inner", "pseudograd", "outer" and,
    # when it saved, "checkpoint"
    phase_s: Dict[str, float] = field(default_factory=dict)
    # the final {"params", "outer_m"}: what a checkpoint of it holds
    outer_state: Optional[Dict[str, PyTree]] = None


@torch.no_grad()
def _outer_update(global_params: Leaves, mean_delta: Leaves,
                  momentum: Leaves, ls: LocalSGDConfig) -> Leaves:
    """Nesterov (or heavy-ball) outer step in fp32.  Writes the momentum
    in place and returns the new parameters as new tensors."""
    mu = ls.outer_momentum
    out = []
    for p, d, m in zip(global_params, mean_delta, momentum):
        d = d.float()
        m.mul_(mu).add_(d)                        # m <- mu * m + d
        upd = d + mu * m if ls.nesterov else m
        out.append((p.float() - ls.outer_lr * upd).to(p.dtype))
    return out


def _replica_speeds(placement: Optional[PlacementSpec]
                    ) -> Optional[List[float]]:
    """Effective FLOP/s per replica, gated by its slowest stage device
    (the pipeline bound); None without a placement."""
    if placement is None:
        return None
    return [min(sp.device.effective_flops for sp in pipe)
            for pipe in placement.pipelines]


def per_replica_inner_steps(ls: LocalSGDConfig,
                            placement: Optional[PlacementSpec] = None
                            ) -> List[int]:
    """Per-replica K derived from the placement's region groups: every
    replica in a region shares that region's K, scaled by the region's
    slowest replica relative to the fastest region — slow regions run
    proportionally fewer inner steps so rounds finish together instead
    of the fleet idling on the slowest radio link.  Without a placement
    every replica runs the global K."""
    R = ls.replicas
    speeds = _replica_speeds(placement)
    if speeds is None:
        return [ls.inner_steps] * R
    groups = placement.region_groups()
    region_speed = {reg: min(speeds[r] for r in reps)
                    for reg, reps in groups.items()}
    fastest = max(region_speed.values())
    ks = [0] * R
    for reg, reps in groups.items():
        k = max(1, round(ls.inner_steps * region_speed[reg] / fastest))
        for r in reps:
            ks[r] = k
    return ks


def _replica_step_times(ls: LocalSGDConfig,
                        placement: Optional[PlacementSpec],
                        step_flops: float) -> List[float]:
    """Modelled seconds per inner step, per replica (virtual clock)."""
    speeds = _replica_speeds(placement)
    if speeds is None:
        return [ls.nominal_step_s] * ls.replicas
    return [step_flops / s for s in speeds]


def _price_sync_comm(ls: LocalSGDConfig, placement: Optional[PlacementSpec],
                     topology, sync_algorithm: str, global_params: Leaves
                     ) -> Tuple[float, float, List[str]]:
    """(modelled outer-sync seconds per round, WAN bytes per round,
    replica -> region map) over the placement or the topology's first
    ``replicas`` devices; zeros without either."""
    if topology is None and placement is None:
        return 0.0, 0.0, []
    n_elems = sum(x.numel() for x in global_params)
    if placement is not None:
        # each stage slot syncs its layer shard over that slot's replica
        # group (disjoint links: concurrent across slots, the slowest
        # slot gates); a region-grouped placement pays intra-region rates
        # for most of the volume
        topo = placement.topology
        L = placement.num_layers
        t_round = 0.0
        wan = 0.0
        for i, group in enumerate(placement.dp_groups()):
            shard = int(n_elems * placement.layer_counts[i] / L)
            c = sync_cost(topo, group, shard, algorithm=sync_algorithm,
                          compress=ls.compress, dtype_bytes=4)
            t_round = max(t_round, c.time_s)
            wan += c.wan_bytes
        regions = [""] * ls.replicas
        for reg, reps in placement.region_groups().items():
            for r in reps:
                regions[r] = reg
        return t_round, wan, regions
    group = topology.devices[:ls.replicas]
    c = sync_cost(topology, group, n_elems, algorithm=sync_algorithm,
                  compress=ls.compress, dtype_bytes=4)
    return c.time_s, c.wan_bytes, []


def _restore_outer_state(ls: LocalSGDConfig, global_params: PyTree,
                         momentum: PyTree) -> Tuple[PyTree, PyTree, int]:
    """Resume: the DiLoCo state (global params + outer momentum) from the
    newest complete checkpoint, written by either package; the inner
    optimizer moments start afresh (DiLoCo re-warms them)."""
    if not (ls.resume and ls.checkpoint_dir):
        return global_params, momentum, 0
    found = ckpt.latest_complete_step(ls.checkpoint_dir)
    if found is None:
        return global_params, momentum, 0
    state = ckpt.restore(ls.checkpoint_dir,
                         {"params": global_params, "outer_m": momentum},
                         step=found)
    _say(f"[local_sgd] resumed from round {found} ({ls.checkpoint_dir})")
    return state["params"], state["outer_m"], found


def _write_checkpoint(ls: LocalSGDConfig,
                      placement: Optional[PlacementSpec],
                      state: Dict[str, PyTree], round_no: int, tr,
                      clock: PhaseClock) -> None:
    with clock.phase("checkpoint"), \
            tr.span("checkpoint", "local_sgd",
                    metric="local_sgd/checkpoint_s", round=round_no):
        if placement is not None:
            # stage slots shard the outer state by the spec's boundaries
            # (each slot's nodes hold its layer range; replication adds
            # §5 neighbour copies)
            ckpt.save_for_placement(
                ls.checkpoint_dir, round_no, state, placement,
                replication=ls.checkpoint_replication)
        else:
            ckpt.save(ls.checkpoint_dir, round_no, state)
        ckpt.prune(ls.checkpoint_dir)


class _Fleet:
    """What both outer loops share: the global state as leaf lists, one
    working copy the replicas train in turn, the step function, the data
    streams and the per-replica optimizer and error-feedback state."""

    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 ls: LocalSGDConfig, opt_cfg: adamw.OptConfig,
                 params: Optional[PyTree], dev: torch.device):
        if params is None:
            params = PM.init_params(cfg, device=dev, seed=tc.seed)
        elif any(p.device != dev for p in PM.tree_leaves(params)):
            raise ValueError(f"params must live on {dev}")
        params = _placed(cfg, params)
        self.like = PM.tree_map(lambda _: None, params)   # structure only
        momentum = PM.tree_map(
            lambda p: zeros_beside(p, torch.float32), params)
        params, momentum, self.start_round = _restore_outer_state(
            ls, params, momentum)
        self.glob: Leaves = [p.detach() for p in PM.tree_leaves(params)]
        self.mom: Leaves = PM.tree_leaves(momentum)
        self.work = PM.tree_map(torch.empty_like, params)
        self.ls, self.dev = ls, dev
        self.step_fn = make_train_step(cfg, opt_cfg, remat=tc.remat,
                                       attn_impl=tc.attn_impl,
                                       microbatches=tc.microbatches)
        R = ls.replicas
        self.opt_states = [adamw.init_opt_state(params, opt_cfg)
                           for _ in range(R)]
        self.errors: List[Optional[List[Optional[torch.Tensor]]]] = \
            [None] * R
        self.streams = [make_batch_fn(cfg, tc.batch, tc.seq_len,
                                      tc.seed + 1000 * r) for r in range(R)]
        self.wire_b = wire_bytes(self.glob,
                                 ls.compress or CompressConfig("none"))
        self.clock = PhaseClock(dev)

    def tree(self, leaves: Leaves) -> PyTree:
        return PM.tree_unflatten(self.like, leaves)

    def run_inner(self, r: int, start: Leaves, k: int, *,
                  acc: Optional[Leaves] = None, monitor=None,
                  step_flops: float = 0.0
                  ) -> Tuple[Leaves, torch.Tensor, List[torch.Tensor]]:
        """Replica r's k inner steps from the global params ``start``;
        returns (its pseudo-gradient as transmitted, or ``acc`` with it
        added in place leaf by leaf; the last step's loss; every step's
        loss), all on the device."""
        tr = get_tracer()
        work_leaves = PM.tree_leaves(self.work)
        losses: List[torch.Tensor] = []
        with self.clock.phase("inner"):
            with torch.no_grad():
                for w, g in zip(work_leaves, start):
                    w.copy_(g)
            s = self.opt_states[r]
            t_prev = time.perf_counter()
            for _ in range(k):
                with tr.device_phase("inner_step", "local_sgd",
                                     device=self.dev,
                                     metric="local_sgd/inner_step_s"):
                    with tr.span("data", "local_sgd",
                                 metric="local_sgd/data_s"):
                        batch = _to_device(next(self.streams[r]), self.dev)
                    _, s, mx = self.step_fn(self.work, s, batch)
                losses.append(mx["loss"])
                if monitor is not None:
                    # energy accounting needs each step's wall clock
                    fetch_scalars([mx["loss"]])
                    t_now = time.perf_counter()
                    monitor.record_step(flops=step_flops,
                                        duration_s=t_now - t_prev)
                    t_prev = t_now
        with self.clock.phase("pseudograd"), \
                tr.span("pseudograd", "local_sgd", replica=r,
                        wire_bytes=self.wire_b):
            delta = self._pseudograd(r, start, work_leaves, acc)
        return delta, losses[-1], losses

    @torch.no_grad()
    def _pseudograd(self, r: int, start: Leaves, local: Leaves,
                    acc: Optional[Leaves]) -> Leaves:
        """delta = start - local per leaf in fp32, through the compressor
        with replica r's error feedback, one leaf at a time (and added
        into ``acc`` at once, when given)."""
        comp = self.ls.compress
        on = comp is not None and comp.method != "none"
        if on and comp.error_feedback and self.errors[r] is None:
            self.errors[r] = [None] * len(start)
        tr = get_tracer()
        out = []
        for i, (g, l) in enumerate(zip(start, local)):
            d = g.float() - l.float()
            if on:
                e = self.errors[r][i] if comp.error_feedback else None
                with tr.device_phase("compress", "local_sgd",
                                     device=self.dev,
                                     metric="local_sgd/compress_s", leaf=i):
                    d, e = compress_leaf(d, e, comp)
                if comp.error_feedback:
                    self.errors[r][i] = e
            if acc is None:
                out.append(d)
            else:
                acc[i].add_(d)
            del d
        return out if acc is None else acc

    def outer(self, mean_delta: Leaves) -> None:
        self.glob = _outer_update(self.glob, mean_delta, self.mom, self.ls)

    def read_clocks(self) -> None:
        """Read the finished phases of the loop's clock and the tracer's;
        called right after a loss fetch, where the host has already
        waited for the card."""
        self.clock.fold()
        get_tracer().resolve()

    def state(self) -> Dict[str, PyTree]:
        return {"params": self.tree(self.glob),
                "outer_m": self.tree(self.mom)}


def _check_args(ls: LocalSGDConfig, topology, placement) -> int:
    if ls.replicas < 1 or ls.inner_steps < 1:
        raise ValueError(
            f"replicas={ls.replicas} and inner_steps={ls.inner_steps} "
            "must both be >= 1")
    if placement is not None:
        if topology is not None:
            raise ValueError("pass either topology= or placement=, not "
                             "both (the placement carries its topology)")
        if placement.data_parallel != ls.replicas:
            raise ValueError(
                f"placement has {placement.data_parallel} replica "
                f"pipelines but LocalSGDConfig.replicas={ls.replicas}")
    if topology is not None and len(topology.devices) < ls.replicas:
        raise ValueError(
            f"topology has {len(topology.devices)} devices but "
            f"{ls.replicas} replicas need to sync over it")
    Q = ls.quorum if ls.quorum is not None else ls.replicas
    if not 1 <= Q <= ls.replicas:
        raise ValueError(f"quorum={Q} must be in 1..{ls.replicas}")
    if ls.staleness_bound < 0:
        raise ValueError(f"staleness_bound={ls.staleness_bound} must be "
                         ">= 0")
    return Q


def train_local_sgd(cfg: ModelConfig, tc: TrainerConfig, ls: LocalSGDConfig,
                    opt_cfg: Optional[adamw.OptConfig] = None, *,
                    topology=None, placement=None,
                    sync_algorithm: str = "hierarchical",
                    monitor: Optional[EnergyMonitor] = None,
                    metrics: Optional[MetricsRegistry] = None,
                    fault_plan: Optional[FaultPlan] = None,
                    health: Optional[HealthMonitor] = None,
                    params: Optional[PyTree] = None,
                    device: DeviceLike = None) -> LocalSGDResult:
    """Run ``max(1, tc.steps // K)`` whole sync rounds of K inner steps
    per replica on ``device`` (the card unless ``"cpu"`` is asked for).

    ``params`` are the initial global weights (for example bridged from
    the JAX package; they are not modified), by default drawn with
    ``init_params(seed=tc.seed)``.  ``topology`` (a
    :class:`repro_torch.core.net.Topology` of at least ``ls.replicas``
    devices) makes the result carry the modelled wide-area sync time per
    round under ``sync_algorithm``.  ``placement`` (a
    :class:`~repro_torch.core.placement.PlacementSpec` with
    ``ls.replicas`` pipelines) maps each replica onto its region group
    instead: the sync is priced per stage slot over that slot's replica
    nodes, the virtual clock runs each replica at its slowest stage
    device's speed, async mode runs per-region K, and checkpoints are
    written layer-sliced by its stage boundaries.  ``fault_plan`` injects
    stragglers, crash/rejoin churn and link jitter into the virtual clock
    (and, in async mode, into which deltas arrive when).  ``health`` (a
    :class:`~repro_torch.obs.HealthMonitor`) sees only observed durations
    and losses, never the plan; in async mode the quorum barrier shrinks
    past the replicas it flags as stragglers."""
    Q = _check_args(ls, topology, placement)
    dev = resolve_device(device)
    if ls.async_mode:
        if monitor is not None:
            raise ValueError(
                "EnergyMonitor needs real per-step wall-clock, which the "
                "async engine's virtual clock replaces")
        return _train_async(cfg, tc, ls, opt_cfg, topology=topology,
                            placement=placement,
                            sync_algorithm=sync_algorithm, metrics=metrics,
                            fault_plan=fault_plan, quorum=Q, params=params,
                            dev=dev, health=health)
    opt_cfg = opt_cfg or adamw.OptConfig(
        learning_rate=3e-4, warmup_steps=max(10, tc.steps // 20),
        decay_steps=tc.steps)
    fleet = _Fleet(cfg, tc, ls, opt_cfg, params, dev)
    del params
    start_round = fleet.start_round
    R = ls.replicas
    step_flops = F.train_flops(cfg, tc.batch, tc.seq_len,
                               remat=tc.remat != "none")
    res = LocalSGDResult()
    rounds = max(1, tc.steps // ls.inner_steps)
    tr = get_tracer()
    inj = FaultInjector(fault_plan, registry=metrics) \
        if fault_plan is not None else None
    wire_b = fleet.wire_b
    comm_round_s, wan_round, replica_regions = _price_sync_comm(
        ls, placement, topology, sync_algorithm, fleet.glob)
    step_times = _replica_step_times(ls, placement, step_flops)
    vclock = 0.0
    t0 = time.perf_counter()
    for rnd in range(rounds):
        round_span = tr.span("round", "local_sgd",
                             metric="local_sgd/round_s",
                             round=start_round + rnd)
        round_span.__enter__()
        round_loss_dev = torch.zeros((), dtype=torch.float32, device=dev)
        r0_losses: List[torch.Tensor] = []
        deltas: Optional[Leaves] = None
        round_dur = 0.0                      # virtual: slowest replica
        for r in range(R):
            with tr.span("replica", "local_sgd", replica=r):
                # deltas summed replica 0 -> R-1, as the JAX loop does
                deltas, last, losses = fleet.run_inner(
                    r, fleet.glob, ls.inner_steps, acc=deltas,
                    monitor=monitor, step_flops=step_flops)
                if r == 0:
                    r0_losses = losses
                round_loss_dev = round_loss_dev + last
            # virtual clock: compute gated by the replica's straggler
            # factor; a crash stalls the whole round until the device
            # rejoins and redoes its work (the trajectory is unchanged)
            dur_r = ls.inner_steps * step_times[r]
            jit = 0.0
            if inj is not None:
                slow = inj.plan.slowdown(r)
                dur_r *= slow
                if slow > 1.0 and rnd == 0:
                    inj.emit("straggle", r, ts_s=vclock,
                             slowdown=round(slow, 3))
                jit = inj.plan.jitter_s(r, rnd)
                if jit > 0.0:
                    inj.emit("link_flap", r, ts_s=vclock,
                             jitter_s=round(jit, 3), round=rnd)
                    dur_r += jit
                if inj.plan.crashes(r, rnd):
                    wait = inj.plan.rejoin_after(r, rnd)
                    inj.emit("crash", r, ts_s=vclock, round=rnd,
                             rejoin_rounds=wait)
                    res.crashes += 1
                    dur_r *= 1 + wait
            if health is not None:
                # what the spans measure: the compute side of the round and
                # the replica's sync/link time (sync mode still waits for
                # everyone; detection lets the summary see the straggler)
                health.observe_step(r, dur_r - jit, ts_s=vclock)
                health.observe_link(r, comm_round_s + jit, ts_s=vclock)
            round_dur = max(round_dur, dur_r)

        with fleet.clock.phase("outer"), \
                tr.device_phase("outer_sync", "local_sgd", device=dev,
                                metric="local_sgd/outer_sync_s",
                                wire_bytes_per_replica=wire_b, replicas=R):
            with torch.no_grad():
                for d in deltas:
                    d.div_(float(R))
            fleet.outer(deltas)
        del deltas
        vclock += round_dur + comm_round_s
        if metrics is not None:
            metrics.counter("local_sgd/pseudograd_bytes").inc(wire_b * R)
            metrics.counter("local_sgd/rounds").inc(1)
        if ls.checkpoint_dir and ls.checkpoint_every_rounds \
                and (rnd + 1) % ls.checkpoint_every_rounds == 0:
            _write_checkpoint(ls, placement, fleet.state(),
                              start_round + rnd + 1, tr, fleet.clock)
        # one host sync per round: replica-0 per-step losses + fleet mean
        with tr.span("metrics_drain", "local_sgd"):
            fetched = fetch_scalars(r0_losses + [round_loss_dev])
        fleet.read_clocks()
        res.losses.extend(fetched[:-1])
        round_loss = fetched[-1]
        res.round_losses.append(round_loss / R)
        if health is not None:
            health.observe_loss(round_loss / R, ts_s=vclock)
        if metrics is not None:
            for x in fetched[:-1]:
                metrics.histogram("local_sgd/loss", lo=1e-4, hi=1e4) \
                    .observe(x)
            metrics.histogram("local_sgd/round_loss", lo=1e-4, hi=1e4) \
                .observe(round_loss / R)
        round_span.__exit__(None, None, None)
        if tc.log_every and rnd % max(1, tc.log_every
                                      // ls.inner_steps) == 0:
            _say(f"round {rnd:4d}  mean loss {round_loss / R:.4f}")

    wall = time.perf_counter() - t0
    res.rounds = rounds
    res.outer_updates = rounds
    res.resumed_from_round = start_round
    res.final_loss = res.round_losses[-1]
    res.steps_per_s = rounds * ls.inner_steps * R / wall
    res.sync_wire_bytes_per_round = wire_b
    res.per_replica_k = [ls.inner_steps] * R
    res.inner_steps_total = rounds * ls.inner_steps * R
    res.contributed_steps = res.inner_steps_total
    res.virtual_time_s = vclock
    if vclock > 0:
        res.virtual_tokens_per_s = (res.contributed_steps * tc.batch
                                    * tc.seq_len / vclock)
    if inj is not None:
        res.fault_counts = dict(inj.counts)
    if health is not None:
        res.health_summary = health.summary()
    if monitor is not None:
        res.energy_wh = monitor.total_wh
    if topology is not None or placement is not None:
        res.comm_time_s_per_round = comm_round_s
        res.sync_wan_bytes_per_round = wan_round
        res.replica_regions = replica_regions
        res.comm_time_s_per_step = comm_round_s / ls.inner_steps
    res.phase_s = fleet.clock.totals()
    tr.resolve()
    res.outer_state = fleet.state()
    return res


# ------------------------------------------------- bounded-staleness async

@dataclass
class _Replica:
    """Host-side async replica state (one edge pipeline)."""
    start_params: Optional[Leaves] = None  # global snapshot the round began
    start_version: int = 0           # global version of that snapshot
    round_idx: int = 0               # personal round counter (plan keys)
    idle: bool = False               # reported, waiting for next update
    start_t: float = 0.0             # virtual time the round began (what
                                     # overdue detection measures against)


def _train_async(cfg: ModelConfig, tc: TrainerConfig, ls: LocalSGDConfig,
                 opt_cfg: Optional[adamw.OptConfig], *, topology,
                 placement: Optional[PlacementSpec],
                 sync_algorithm: str, metrics: Optional[MetricsRegistry],
                 fault_plan: Optional[FaultPlan], quorum: int,
                 params: Optional[PyTree], dev: torch.device,
                 health: Optional[HealthMonitor] = None
                 ) -> LocalSGDResult:
    """Event-driven bounded-staleness async outer loop on the virtual
    clock.  The outer update applies the moment ``quorum`` replicas have
    reported since the last update; reported replicas idle until it, then
    restart from the new global params; still-running replicas report
    stale deltas, weighted ``1/(1+staleness)`` up to ``staleness_bound``
    and dropped (the replica re-synced) past it.  A crashed replica's
    work is lost; it rejoins ``rejoin_after`` rounds later and re-syncs.
    Event ties break on replica id and every fault draw is keyed, so a
    run replays bit for bit.

    With ``health``, the quorum barrier additionally shrinks past
    replicas the monitor currently flags as stragglers and has no report
    from: an update applies once every *unflagged* outstanding replica
    (up to the configured quorum) has reported.  Detection is fed from
    observed per-report durations plus overdue checks on periodic health
    ticks — the plan never leaks into the decision."""
    opt_cfg = opt_cfg or adamw.OptConfig(
        learning_rate=3e-4, warmup_steps=max(10, tc.steps // 20),
        decay_steps=tc.steps)
    fleet = _Fleet(cfg, tc, ls, opt_cfg, params, dev)
    del params
    start_round = fleet.start_round
    R = ls.replicas
    S = ls.staleness_bound
    ks = per_replica_inner_steps(ls, placement)
    step_flops = F.train_flops(cfg, tc.batch, tc.seq_len,
                               remat=tc.remat != "none")
    step_times = _replica_step_times(ls, placement, step_flops)
    comm_round_s, wan_round, replica_regions = _price_sync_comm(
        ls, placement, topology, sync_algorithm, fleet.glob)
    wire_b = fleet.wire_b
    tr = get_tracer()
    inj = FaultInjector(fault_plan, registry=metrics)
    plan = inj.plan

    reps = [_Replica(start_params=fleet.glob) for _ in range(R)]
    res = LocalSGDResult(mode="async", per_replica_k=list(ks))
    rounds = max(1, tc.steps // ls.inner_steps)
    version = 0
    # pending outer-update reports: replica -> (delta, weight, last loss)
    reports: Dict[int, Tuple[Leaves, float, torch.Tensor]] = {}
    events: List[Tuple[float, int, str]] = []   # (t, replica, kind)

    def _round_dur(r: int, idx: int) -> float:
        dur = ks[r] * step_times[r] * plan.slowdown(r)
        return dur + plan.jitter_s(r, idx)

    def _start_round(r: int, t: float) -> None:
        """Begin replica r's next personal round at virtual time t."""
        rep = reps[r]
        rep.idle = False
        rep.start_t = t
        rep.start_params = fleet.glob
        rep.start_version = version
        slow = plan.slowdown(r)
        if slow > 1.0 and rep.round_idx == 0:
            inj.emit("straggle", r, ts_s=t, slowdown=round(slow, 3))
        if plan.crashes(r, rep.round_idx):
            wait = plan.rejoin_after(r, rep.round_idx)
            inj.emit("crash", r, ts_s=t, round=rep.round_idx,
                     rejoin_rounds=wait)
            res.crashes += 1
            rep.round_idx += 1
            heapq.heappush(
                events, (t + wait * ks[r] * step_times[r] * slow, r,
                         "rejoin"))
            return
        jit = plan.jitter_s(r, rep.round_idx)
        if jit > 0.0:
            inj.emit("link_flap", r, ts_s=t, jitter_s=round(jit, 3),
                     round=rep.round_idx)
        dur = _round_dur(r, rep.round_idx)
        rep.round_idx += 1
        heapq.heappush(events, (t + dur, r, "report"))

    def _apply_update(t: float) -> float:
        """Weighted outer update from the buffered reports; returns the
        update's virtual completion time."""
        nonlocal version
        order = sorted(reports)
        weights = [reports[r][1] for r in order]
        uniform = all(w == 1.0 for w in weights)
        with fleet.clock.phase("outer"), torch.no_grad():
            acc: Optional[Leaves] = None
            for r in order:
                d, w, _ = reports[r]
                term = d if uniform else [x * w for x in d]
                if acc is None:
                    acc = term
                else:
                    for a, b in zip(acc, term):
                        a.add_(b)
            wsum = float(len(order)) if uniform else sum(weights)
            for a in acc:
                a.div_(wsum)
            with tr.device_phase("outer_sync", "local_sgd", device=dev,
                                 metric="local_sgd/outer_sync_s",
                                 wire_bytes_per_replica=wire_b,
                                 reports=len(order), version=version):
                fleet.outer(acc)
        del acc
        version += 1
        # fleet-mean loss of the contributing replicas' last inner steps
        loss_dev = torch.zeros((), dtype=torch.float32, device=dev)
        for r in order:
            loss_dev = loss_dev + reports[r][2]
        round_loss = fetch_scalars([loss_dev])[0] / len(order)
        fleet.read_clocks()
        res.round_losses.append(round_loss)
        if health is not None:
            health.observe_loss(round_loss, ts_s=t)
        res.contributed_steps += sum(ks[r] for r in order)
        if metrics is not None:
            metrics.counter("local_sgd/pseudograd_bytes").inc(
                wire_b * len(order))
            metrics.counter("local_sgd/rounds").inc(1)
            metrics.histogram("local_sgd/round_loss", lo=1e-4,
                              hi=1e4).observe(round_loss)
        tr.complete("outer_update", ts_s=t, dur_s=comm_round_s,
                    cat="local_sgd", track="local_sgd/outer",
                    version=version, reports=len(order),
                    round_loss=round(round_loss, 6))
        reports.clear()
        return t + comm_round_s

    # the health-driven barrier: never wait on a DETECTED straggler.  The
    # effective quorum shrinks by the flagged replicas still outstanding;
    # detection comes from observed report durations plus overdue checks
    # on periodic ticks — the fault plan is never consulted for this
    tick_s = 0.5 * min(ks[i] * step_times[i] for i in range(R))
    tick_pending = False

    def _overdue_scan(t: float) -> None:
        for i in range(R):
            if not reps[i].idle and i not in reports:
                health.check_overdue(i, t - reps[i].start_t, ts_s=t)

    def _quorum_eff() -> int:
        if health is None:
            return quorum
        outstanding_flagged = sum(
            1 for i in range(R)
            if health.is_straggler(i) and not reps[i].idle
            and i not in reports)
        return max(1, min(quorum, R - outstanding_flagged))

    def _maybe_update(t: float) -> Optional[float]:
        """Apply the outer update if the (health-shrunk) quorum is met;
        returns the update's completion time, else None."""
        q_eff = _quorum_eff()
        if not reports or len(reports) < q_eff:
            return None
        if q_eff < quorum:
            res.health_excluded_updates += 1
        return _apply_update(t)

    def _after_update(t_up: float) -> None:
        if ls.checkpoint_dir and ls.checkpoint_every_rounds \
                and version % ls.checkpoint_every_rounds == 0:
            _write_checkpoint(ls, placement, fleet.state(),
                              start_round + version, tr, fleet.clock)
        for i in range(R):
            if reps[i].idle:
                _start_round(i, t_up)

    vclock = 0.0
    t0 = time.perf_counter()
    for r in range(R):
        _start_round(r, 0.0)
    while version < rounds and events:
        t, r, kind = heapq.heappop(events)
        vclock = max(vclock, t)
        if kind == "health_tick":
            tick_pending = False
            if health is not None and reports:
                _overdue_scan(t)
                t_up = _maybe_update(t)
                if t_up is not None:
                    vclock = max(vclock, t_up)
                    if version >= rounds:
                        break
                    _after_update(t_up)
                elif not tick_pending:
                    tick_pending = True
                    heapq.heappush(events, (t + tick_s, -1, "health_tick"))
            continue
        rep = reps[r]
        if kind == "rejoin":
            # the crashed device is back but its local state is gone:
            # re-sync from the current global params and start fresh
            inj.emit("rejoin", r, ts_s=t)
            inj.emit("resync", r, ts_s=t, version=version)
            res.resyncs += 1
            _start_round(r, t)
            continue
        delta, last_loss, losses = fleet.run_inner(r, rep.start_params,
                                                   ks[r])
        res.inner_steps_total += ks[r]
        if r == 0:
            fetched = fetch_scalars(losses)
            fleet.read_clocks()
            res.losses.extend(fetched)
            if metrics is not None:
                for x in fetched:
                    metrics.histogram("local_sgd/loss", lo=1e-4,
                                      hi=1e4).observe(x)
        stale = version - rep.start_version
        dur = _round_dur(r, rep.round_idx - 1)
        tr.complete("async_round", ts_s=t - dur, dur_s=dur,
                    cat="local_sgd", track=f"replica:{r}",
                    staleness=stale, k=ks[r])
        if health is not None:
            # what the spans measured for this report: compute time and
            # link time, separately (the async_round / outer_sync split)
            jit = plan.jitter_s(r, rep.round_idx - 1)
            health.observe_step(r, ks[r] * step_times[r] * plan.slowdown(r),
                                ts_s=t)
            health.observe_link(r, comm_round_s + jit, ts_s=t)
            _overdue_scan(t)
        if stale > S:
            # past the hard bound: drop the delta and re-sync the replica
            # from the current global (it lost K_r steps of work)
            inj.emit("drop_stale", r, ts_s=t, staleness=stale, bound=S)
            inj.emit("resync", r, ts_s=t, version=version)
            res.dropped_stale += 1
            res.resyncs += 1
            del delta
            _start_round(r, t)
            continue
        if stale > 0:
            res.late_merged += 1
        reports[r] = (delta, 1.0 / (1.0 + stale), last_loss)
        del delta
        rep.idle = True
        t_up = _maybe_update(t)
        if t_up is not None:
            vclock = max(vclock, t_up)
            if version >= rounds:
                break
            _after_update(t_up)
        elif health is not None and not tick_pending:
            # quorum not met: schedule an overdue check so a straggler can
            # be detected (and the barrier shrunk) before it reports
            tick_pending = True
            heapq.heappush(events, (t + tick_s, -1, "health_tick"))

    wall = time.perf_counter() - t0
    res.rounds = version
    res.outer_updates = version
    res.resumed_from_round = start_round
    res.final_loss = res.round_losses[-1] if res.round_losses \
        else float("nan")
    res.steps_per_s = res.inner_steps_total / wall if wall > 0 else 0.0
    res.sync_wire_bytes_per_round = wire_b
    res.virtual_time_s = vclock
    if vclock > 0:
        res.virtual_tokens_per_s = (res.contributed_steps * tc.batch
                                    * tc.seq_len / vclock)
    res.fault_counts = dict(inj.counts)
    if health is not None:
        res.health_summary = health.summary()
    if topology is not None or placement is not None:
        res.comm_time_s_per_round = comm_round_s
        res.sync_wan_bytes_per_round = wan_round
        res.replica_regions = replica_regions
        res.comm_time_s_per_step = comm_round_s / ls.inner_steps
    res.phase_s = fleet.clock.totals()
    tr.resolve()
    res.outer_state = fleet.state()
    return res
