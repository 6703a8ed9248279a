"""Discrete-event orchestration simulator for edge training (§5; the
port's copy of ``repro.core.sched.orchestrator``).

Simulates a training run over a dynamic edge fleet:

* devices join/leave (Poisson churn — "dynamic device participation"),
* thermal throttling via the RC model (per-device state),
* carbon-aware admission (only devices under the gCO2e/GFLOP threshold and
  in clean-energy windows join the active set),
* fault tolerance by periodic checkpointing (rework on failure),
* per-step energy/carbon ledger (compute + stall + comm + rework).

Deterministic given the seed: every stochastic consumer draws from its
own **named substream** of ``SimConfig.seed`` (join churn, leave churn —
and fault draws, which are keyed streams inside the
:class:`~repro_torch.core.faultinject.FaultPlan` itself), so identical configs
replay identical trajectories and toggling fault injection on cannot
perturb the churn sequence.  The simulator IS the system's orchestration
logic, exercised by tests and examples, not a visualization toy.  Time
advances step-by-step; each step reassigns the DT-FM plan if membership
changed (the paper's "preemptible execution and fast state recovery"
loop).

An optional ``SimConfig.fault_plan`` injects deterministic faults on top
of the Poisson churn: stragglers stretch the step clock, link flaps add
wide-area jitter, crashes force departures (with the usual rework +
replan + priced recovery), and checkpoint-shard corruption knocks holder
copies out of the recovery spec — a corrupted survivor then degrades to
a neighbour or WAN/store fetch in the recovery pricing instead of
crashing the run.

An optional :class:`repro_torch.obs.HealthMonitor` closes the observability
loop: the orchestrator feeds it the per-device compute and link
durations each step *observes* (never the plan's draws directly — the
plan stays the sim's hidden ground truth), and any device the monitor
flags — straggler or repeatedly-flapping link — is **degraded** out of
the active set through the normal churn machinery, so the rework /
replan / priced-recovery pipeline prices the eviction exactly like an
organic departure.  Because the synchronous pipeline is gated by its
slowest member, evicting a detected straggler is a throughput decision
the fleet could never make by reading the plan it does not have.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.checkpoint import (CheckpointSpec, recovery_cost,
                              state_layer_bytes, write_cost)
from repro_torch.core.carbon.accounting import CarbonLedger
from repro_torch.core.carbon.intensity import IntensityTrace
from repro_torch.core.faultinject import FaultInjector, FaultPlan
from repro_torch.core.net import Topology
from repro_torch.core.placement import search_placement
from repro_torch.core.planner import dtfm
from repro_torch.obs.trace import get_tracer
from repro_torch.core.sched.carbon_aware import FleetDevice, carbon_rate
from repro_torch.core.sched.thermal import ThermalState
from repro_torch.models.config import ModelConfig


def _substream(seed: int, name: str) -> np.random.Generator:
    """Named RNG substream of the sim seed (same keyed-stream idiom as
    :mod:`repro_torch.core.faultinject`): consumers cannot perturb each other."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                  zlib.crc32(name.encode())])


@dataclass
class SimConfig:
    total_steps: int = 200
    batch: int = 16
    seq_len: int = 512
    microbatches: int = 32
    checkpoint_interval: int = 50
    ckpt_replication: int = 1        # §5 neighbour shard copies per write
    naive_restore: bool = False      # price recovery as full-state store
                                     # fetches (the placement-blind
                                     # baseline bench_elastic beats)
    churn_leave_per_hour: float = 0.2      # per active device
    churn_join_per_hour: float = 0.5       # per idle candidate
    carbon_threshold_g_per_gflop: float = float("inf")
    start_hour_utc: float = 9.0
    seed: int = 0
    fault_plan: Optional[FaultPlan] = None   # deterministic injected
                                             # faults on top of churn


@dataclass
class SimResult:
    steps_done: int
    wall_time_s: float
    energy_wh: float
    carbon_kg: float
    rework_steps: int
    membership_changes: int
    mean_active_devices: float
    throughput_steps_per_hour: float
    trace: List[Dict] = field(default_factory=list)
    comm_s_total: float = 0.0
    comm_energy_wh: float = 0.0
    topology_rebuilds: int = 0
    wan_bytes_total: float = 0.0
    last_placement: str = ""
    # elastic-state accounting (bytes priced through core.net, not the
    # old ckpt_write_s/ckpt_restore_s constants) — what lets
    # the carbon benchmarks attribute recovery carbon separately
    ckpt_writes: int = 0
    ckpt_write_s_total: float = 0.0
    ckpt_bytes_written: float = 0.0
    ckpt_bytes_by_region: Dict[str, float] = field(default_factory=dict)
    restores: int = 0
    restore_s_total: float = 0.0
    restore_bytes_moved: float = 0.0
    restore_wan_bytes: float = 0.0
    restore_bytes_by_region: Dict[str, float] = field(default_factory=dict)
    recovery_energy_wh: float = 0.0     # radio energy of writes+restores
    # fault-injection accounting (empty without a fault_plan)
    fault_counts: Dict[str, int] = field(default_factory=dict)
    crashes: int = 0
    corrupted_shard_copies: int = 0
    # health-driven response accounting (empty without a HealthMonitor)
    health_evictions: int = 0
    health_summary: Optional[Dict] = None


class Orchestrator:
    def __init__(self, cfg: ModelConfig, fleet: Sequence[FleetDevice],
                 sim: SimConfig, *, health=None):
        self.cfg = cfg
        self.fleet = list(fleet)
        self.sim = sim
        # Detection-driven degradation.  ``health`` is a
        # repro_torch.obs.HealthMonitor fed ONLY observed durations; devices
        # it flags land in ``degraded`` and stay out of admission until
        # the detector clears them.
        self.health = health
        self.degraded: Set[int] = set()
        # named substreams: join draws never perturb leave draws (and
        # neither shifts when the keyed-stream fault plan is toggled)
        self.rng_join = _substream(sim.seed, "join")
        self.rng_leave = _substream(sim.seed, "leave")
        self.thermals = {d.device_id: ThermalState(d.thermal_params())
                         for d in self.fleet}
        self.active: List[FleetDevice] = []
        self.ledger = CarbonLedger()
        self.traces: Dict[str, IntensityTrace] = {}
        self.topology: Optional[Topology] = None
        self.topology_rebuilds = 0
        self.injector = FaultInjector(sim.fault_plan) \
            if sim.fault_plan is not None and sim.fault_plan.active \
            else None
        self._offline_until: Dict[int, int] = {}   # device -> rejoin step
        # persistent straggler factors, filled through the batched keyed
        # draws (bit-identical to plan.slowdown per entity) so a step
        # over a large active set costs one vectorized call, not one
        # Generator construction per device
        self._slowdown: Dict[int, float] = {}
        self._step = 0

    def _rebuild_topology(self) -> Topology:
        """Wide-area graph over the current active set; called on every
        membership change (the paper's preemptible-execution loop)."""
        self.topology = Topology.from_fleet(self.active)
        self.topology_rebuilds += 1
        return self.topology

    # ------------------------------------------------------------ membership
    def _admit(self, hour: float) -> int:
        """Carbon-aware admission; returns number of membership changes."""
        changes = 0
        active_ids = {d.device_id for d in self.active}
        for d in self.fleet:
            rate, _ = carbon_rate(d, hour, self.traces)
            ok = d.charging and rate <= self.sim.carbon_threshold_g_per_gflop
            if ok and d.device_id in self.degraded:
                # health-degraded: out until the detector clears it (an
                # evicted device produces no new observations, so in
                # practice degradation is sticky — by design)
                if self.health is not None \
                        and not self.health.is_straggler(d.device_id) \
                        and str(d.device_id) \
                        not in self.health.degraded_links():
                    self.degraded.discard(d.device_id)
                else:
                    ok = False
            if ok and d.device_id in self._offline_until:
                # crashed device: stays out until its rejoin step
                ok = self._step >= self._offline_until[d.device_id]
                if ok:
                    del self._offline_until[d.device_id]
                    if self.injector is not None:
                        self.injector.emit("rejoin", d.device_id,
                                           ts_s=self._t, step=self._step)
            if ok and d.device_id not in active_ids:
                # idle candidate joins with prob churn_join per hour
                if self.rng_join.random() < self.sim.churn_join_per_hour \
                        / 3600.0 * self._dt or not self.active:
                    self.active.append(d)
                    changes += 1
            elif not ok and d.device_id in active_ids:
                self.active = [a for a in self.active
                               if a.device_id != d.device_id]
                changes += 1
        return changes

    def _depart(self) -> int:
        leave_p = self.sim.churn_leave_per_hour / 3600.0 * self._dt
        stay = []
        changes = 0
        crash_mask = self.injector.plan.crashes_batch(
            [d.device_id for d in self.active], self._step) \
            if self.injector is not None else None
        for k, d in enumerate(self.active):
            crashed = crash_mask is not None and bool(crash_mask[k])
            if crashed and len(self.active) > 1:
                # injected crash: device vanishes mid-step and stays
                # offline for its plan-drawn rejoin delay; the usual
                # departure machinery (rework, replan, priced recovery)
                # handles the fallout
                wait = self.injector.plan.rejoin_after(d.device_id,
                                                       self._step)
                self._offline_until[d.device_id] = self._step + wait
                self.injector.emit("crash", d.device_id, ts_s=self._t,
                                   step=self._step, rejoin_steps=wait)
                changes += 1
            elif self.rng_leave.random() < leave_p \
                    and len(self.active) > 1:
                changes += 1
            else:
                stay.append(d)
        self.active = stay
        return changes

    # ------------------------------------------------------------------ run
    def run(self) -> SimResult:
        sim, cfg = self.sim, self.cfg
        # fleet events land on the tracer with EXPLICIT simulated-clock
        # timestamps (seconds from run start) on the "fleet" track —
        # churn, replans, restores and checkpoint writes share one
        # Perfetto timeline with their byte/energy attributions
        tr = get_tracer()
        t = 0.0
        steps = 0
        rework = 0
        changes = 0
        energy_wh = 0.0
        comm_s_total = 0.0
        comm_energy_wh = 0.0
        wan_bytes_total = 0.0
        last_strategy = ""
        active_sum = 0.0
        iterations = 0
        last_ckpt_step = 0
        self._dt = 1.0
        self._t = 0.0
        self._step = 0
        trace: List[Dict] = []
        inj = self.injector
        straggle_announced: Set[int] = set()
        # holder copies knocked out by injected shard corruption; the
        # next recovery prices around them ((shard, node) pairs)
        corrupt_copies: Set[Tuple[int, str]] = set()

        # elastic state: where shard copies currently sit (live placement
        # nodes; checkpoint writes add §5 neighbour replication), and the
        # per-layer / placement-independent byte split the recovery
        # pricing slices by
        layer_b, global_b = state_layer_bytes(cfg)
        state_spec: Optional[CheckpointSpec] = None
        ckpt_writes = 0
        ckpt_write_s_total = 0.0
        ckpt_bytes_written = 0.0
        ckpt_by_region: Dict[str, float] = {}
        restores = 0
        restore_s_total = 0.0
        restore_bytes_moved = 0.0
        restore_wan = 0.0
        restore_by_region: Dict[str, float] = {}
        recovery_energy_wh = 0.0
        health_evictions = 0

        def _merge(dst: Dict[str, float], src: Dict[str, float]) -> None:
            for k, v in src.items():
                dst[k] = dst.get(k, 0.0) + v

        # initial admission
        hour = sim.start_hour_utc
        self._dt = 3600.0
        changes += self._admit(hour)
        if not self.active:
            self.active = [self.fleet[0]]
        topo = self._rebuild_topology()
        plan = None

        while steps < sim.total_steps:
            hour = (sim.start_hour_utc + t / 3600.0) % 24.0
            self._t, self._step = t, steps
            members_before = {d.device_id for d in self.active}

            if plan is None:
                # membership changed (or first step): rebuild the
                # wide-area topology and replan through the shared
                # placement API — the search keeps each pipeline's
                # regions contiguous so stage-boundary activations ride
                # intra-region links instead of the ad-hoc active-list
                # order the seed used (collective= explicit so search
                # and accounting price the same model)
                placement = search_placement(
                    cfg, [d.spec for d in self.active],
                    topology=topo,
                    nodes=[str(d.device_id) for d in self.active],
                    batch=sim.batch, seq_len=sim.seq_len,
                    microbatches=sim.microbatches, collective="ring")
                if state_spec is not None:
                    # the new placement must be fed the training state:
                    # price the bytes ACTUALLY missing (survivors keep
                    # their shards; joiners fetch their layer ranges
                    # from the nearest holder) through the wide-area
                    # model — this replaces the old ckpt_restore_s
                    # constant
                    rec_spec = state_spec
                    if corrupt_copies and rec_spec.holders:
                        # injected bit-rot knocked holder copies out:
                        # the self-healing restore re-fetches from the
                        # surviving holders — possibly the WAN/store
                        # when a shard lost every copy — instead of
                        # crashing on the corrupt survivor
                        rec_spec = CheckpointSpec(
                            rec_spec.num_layers, rec_spec.boundaries,
                            rec_spec.replication,
                            tuple(tuple(h for h in hs
                                        if (i, h) not in corrupt_copies)
                                  for i, hs in
                                  enumerate(rec_spec.holders)))
                    rc = recovery_cost(topo, placement,
                                       old_spec=rec_spec,
                                       layer_bytes=layer_b,
                                       global_bytes=global_b,
                                       naive=sim.naive_restore)
                    if corrupt_copies:
                        healed = len({s for s, _ in corrupt_copies})
                        if inj is not None:
                            inj.emit("heal", "fleet", ts_s=t,
                                     step=steps, shards=healed,
                                     bytes=rc.bytes_moved)
                        corrupt_copies.clear()
                    tr.complete("restore", ts_s=t, dur_s=rc.time_s,
                                cat="sched", track="fleet",
                                bytes_moved=rc.bytes_moved,
                                wan_bytes=rc.wan_bytes,
                                energy_wh=rc.energy_wh, step=steps)
                    t += rc.time_s
                    restores += 1
                    restore_s_total += rc.time_s
                    restore_bytes_moved += rc.bytes_moved
                    restore_wan += rc.wan_bytes
                    _merge(restore_by_region, rc.per_region_bytes)
                    energy_wh += rc.energy_wh
                    recovery_energy_wh += rc.energy_wh
                    ci_now = self.traces.setdefault(
                        self.active[0].region,
                        IntensityTrace(self.active[0].region)).at_hour(hour)
                    self.ledger.add_operational_wh(
                        f"restore{steps}", rc.energy_wh, intensity=ci_now)
                # the live state now sits on the new placement's nodes
                state_spec = CheckpointSpec.from_placement(placement, 0)
                plan = dtfm.plan_placement(
                    cfg, placement,
                    batch=sim.batch, seq_len=sim.seq_len,
                    microbatches=sim.microbatches, collective="ring")
                last_strategy = placement.strategy
                tr.instant("replan", "sched", track="fleet", ts_s=t,
                           step=steps, strategy=placement.strategy,
                           active=len(self.active))
            # scale COMPUTE time by the thermal derate of the slowest
            # member; comm time is not derated (the radio, not the SoC,
            # is the bottleneck)
            derate = min(self.thermals[d.device_id].perf_factor()
                         for d in self.active)
            compute_s = plan.step_time_s - plan.comm_s_per_step
            comm_s = plan.comm_s_per_step
            slow = 1.0
            dev_slow: Dict[int, float] = {}
            dev_jit: Dict[int, float] = {}
            if inj is not None:
                # the synchronous pipeline is gated by its slowest
                # member: the worst straggler stretches compute, and
                # each flapped link adds serial jitter to the ring sync.
                # Both masks come from the batched keyed streams — one
                # vectorized draw over the active set, lane-identical to
                # the per-entity scalar draws
                ids = [d.device_id for d in self.active]
                missing = [i for i in ids if i not in self._slowdown]
                if missing:
                    self._slowdown.update(zip(
                        missing,
                        (float(v) for v in
                         inj.plan.slowdown_batch(missing))))
                jit = inj.plan.jitter_batch(ids, steps)
                for k, d in enumerate(self.active):
                    s_d = self._slowdown[d.device_id]
                    if s_d > 1.0 and d.device_id not in straggle_announced:
                        straggle_announced.add(d.device_id)
                        inj.emit("straggle", d.device_id, ts_s=t,
                                 slowdown=round(s_d, 3))
                    slow = max(slow, s_d)
                    dev_slow[d.device_id] = s_d
                    j = float(jit[k])
                    if j > 0.0:
                        inj.emit("link_flap", d.device_id, ts_s=t,
                                 step=steps, jitter_s=round(j, 3))
                        comm_s += j
                        dev_jit[d.device_id] = j
            step_s = compute_s * slow / max(derate, 1e-6) + comm_s
            if self.health is not None:
                # feed the monitor what a per-device span would measure:
                # that device's compute time under its own slowdown /
                # derate, and its share of the sync plus its link jitter
                for d in self.active:
                    self.health.observe_step(
                        d.device_id,
                        compute_s * dev_slow.get(d.device_id, 1.0)
                        / max(derate, 1e-6), ts_s=t)
                    self.health.observe_link(
                        d.device_id,
                        plan.comm_s_per_step
                        + dev_jit.get(d.device_id, 0.0), ts_s=t)
            self._dt = step_s

            # advance thermals under load
            for d in self.active:
                self.thermals[d.device_id].step(d.spec.power_active_w, step_s)
            for d in self.fleet:
                if d.device_id not in {a.device_id for a in self.active}:
                    self.thermals[d.device_id].step(0.5, step_s)

            # energy + carbon for this step (comm energy un-derated,
            # matching the wall-time split above)
            e_comm_wh = plan.comm_energy_wh_per_step
            e_wh = (plan.total_energy_wh_per_step - e_comm_wh) \
                / max(derate, 1e-6) + e_comm_wh
            energy_wh += e_wh
            comm_s_total += plan.comm_s_per_step
            comm_energy_wh += e_comm_wh
            wan_bytes_total += plan.wan_bytes_per_step
            ci = self.traces.setdefault(
                self.active[0].region,
                IntensityTrace(self.active[0].region)).at_hour(hour)
            self.ledger.add_operational_wh(f"step{steps}", e_wh,
                                           intensity=ci)

            # checkpoint overhead: local snapshots are free; the network
            # pays for §5 neighbour replication plus the durable store
            # upload, priced over the current topology
            if steps - last_ckpt_step >= sim.checkpoint_interval:
                ck_spec = CheckpointSpec.from_placement(
                    placement, sim.ckpt_replication)
                wc = write_cost(topo, placement, ck_spec, layer_b, global_b)
                tr.complete("ckpt_write", ts_s=t, dur_s=wc.time_s,
                            cat="sched", track="fleet", step=steps,
                            bytes_moved=wc.bytes_moved,
                            energy_wh=wc.energy_wh)
                t += wc.time_s
                ckpt_writes += 1
                ckpt_write_s_total += wc.time_s
                ckpt_bytes_written += wc.bytes_moved
                _merge(ckpt_by_region, wc.per_region_bytes)
                energy_wh += wc.energy_wh
                recovery_energy_wh += wc.energy_wh
                self.ledger.add_operational_wh(f"ckpt{steps}", wc.energy_wh,
                                               intensity=ci)
                state_spec = ck_spec
                last_ckpt_step = steps
                if inj is not None and inj.plan.corrupt_prob > 0:
                    # silent bit-rot on freshly written holder copies:
                    # drawn per (step, shard, holder) so the same plan
                    # rots the same copies every replay
                    corrupt_copies.clear()
                    for s_i, hs in enumerate(ck_spec.holders):
                        for h in hs:
                            if inj.plan.corrupts(steps, s_i, h):
                                corrupt_copies.add((s_i, h))
                                inj.emit("corrupt", h, ts_s=t,
                                         step=steps, shard=s_i)

            # health-driven degradation: evict any member the monitor
            # has flagged (detected straggler or repeatedly-flapping
            # link) — the departure flows through the same rework /
            # replan / priced-recovery machinery as organic churn
            evicted: List[int] = []
            if self.health is not None:
                bad = {int(e) for e in self.health.stragglers()
                       if e.lstrip("-").isdigit()}
                bad |= {int(e) for e in self.health.degraded_links()
                        if e.lstrip("-").isdigit()}
                for d in list(self.active):
                    if d.device_id in bad and len(self.active) > 1:
                        self.active = [a for a in self.active
                                       if a.device_id != d.device_id]
                        self.degraded.add(d.device_id)
                        evicted.append(d.device_id)
                if evicted:
                    health_evictions += len(evicted)
                    tr.instant("degrade", "sched", track="fleet",
                               ts_s=t, step=steps,
                               devices=sorted(evicted), reason="health")

            # churn
            changes_now = len(evicted) + self._depart() + self._admit(hour)
            if not self.active:
                # carbon/charging eviction can empty the fleet (unlike
                # _depart, _admit has no min-1 floor): keep the seed
                # device so the next plan/derate have a member
                self.active = [self.fleet[0]]
                changes_now += 1
            changes += changes_now
            members_now = {d.device_id for d in self.active}
            if changes_now:
                tr.instant("churn", "sched", track="fleet", ts_s=t,
                           step=steps, changes=changes_now,
                           joined=sorted(members_now - members_before),
                           left=sorted(members_before - members_now),
                           active=len(self.active))
            if members_before - members_now:
                # a member LEFT (joins don't lose state): recompute the
                # lost steps — charged as extra wall time and energy,
                # not by rewinding the step counter (a rewind livelocks
                # under sustained churn: expected progress hits zero
                # before the next checkpoint).  The state-movement cost
                # of the restore itself is priced at the replan below,
                # from the bytes the new placement is actually missing.
                lost = min(steps - last_ckpt_step,
                           sim.checkpoint_interval) // 2
                rework += lost
                tr.complete("rework", ts_s=t, dur_s=lost * step_s,
                            cat="sched", track="fleet", step=steps,
                            lost_steps=lost)
                t += lost * step_s
                energy_wh += lost * e_wh
                comm_s_total += lost * plan.comm_s_per_step
                comm_energy_wh += lost * e_comm_wh
                wan_bytes_total += lost * plan.wan_bytes_per_step
                self.ledger.add_operational_wh(f"rework{steps}",
                                               lost * e_wh, intensity=ci)
            if changes_now and members_now != members_before:
                # any membership change: rebuild the wide-area topology
                # and replan against it (after the rework accounting,
                # which prices the plan that just executed)
                topo = self._rebuild_topology()
                plan = None

            if tr.enabled:
                tr.complete("step", ts_s=t, dur_s=step_s, cat="sched",
                            track="fleet/steps", step=steps,
                            active=len(self.active),
                            derate=round(derate, 4), energy_wh=e_wh)
                tr.counter("fleet.active", len(self.active), ts_s=t)
            t += step_s
            steps += 1
            active_sum += len(self.active)
            iterations += 1
            if steps % 20 == 0:
                trace.append({"step": steps, "t_s": round(t, 1),
                              "active": len(self.active),
                              "derate": round(derate, 3),
                              "ci": round(ci, 3)})

        return SimResult(
            steps_done=steps,
            wall_time_s=t,
            energy_wh=energy_wh,
            carbon_kg=self.ledger.operational_kg,
            rework_steps=rework,
            membership_changes=changes,
            mean_active_devices=active_sum / max(iterations, 1),
            throughput_steps_per_hour=steps / (t / 3600.0) if t else 0.0,
            trace=trace,
            comm_s_total=comm_s_total,
            comm_energy_wh=comm_energy_wh,
            topology_rebuilds=self.topology_rebuilds,
            wan_bytes_total=wan_bytes_total,
            last_placement=last_strategy,
            ckpt_writes=ckpt_writes,
            ckpt_write_s_total=ckpt_write_s_total,
            ckpt_bytes_written=ckpt_bytes_written,
            ckpt_bytes_by_region=ckpt_by_region,
            restores=restores,
            restore_s_total=restore_s_total,
            restore_bytes_moved=restore_bytes_moved,
            restore_wan_bytes=restore_wan,
            restore_bytes_by_region=restore_by_region,
            recovery_energy_wh=recovery_energy_wh,
            fault_counts=dict(inj.counts) if inj is not None else {},
            crashes=inj.counts.get("crash", 0) if inj is not None else 0,
            corrupted_shard_copies=inj.counts.get("corrupt", 0)
            if inj is not None else 0,
            health_evictions=health_evictions,
            health_summary=self.health.summary()
            if self.health is not None else None,
        )


def make_fleet(spec_counts: Dict[str, int], *, regions=("europe",),
               seed: int = 0) -> List[FleetDevice]:
    from repro_torch.core.energy.devices import CATALOG
    rng = np.random.default_rng(seed)
    fleet = []
    i = 0
    for name, count in spec_counts.items():
        for _ in range(count):
            fleet.append(FleetDevice(
                spec=CATALOG[name],
                region=regions[i % len(regions)],
                tz_offset=float(rng.integers(-6, 7)),
                charging=bool(rng.random() < 0.8),
                device_id=i))
            i += 1
    return fleet
