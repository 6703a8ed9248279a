"""Batched churn/fault sweep over a :class:`FleetArrays` fleet (the
port's copy of ``repro.core.sched.fleet_sim``).

The discrete-event :class:`~repro_torch.core.sched.orchestrator.Orchestrator`
replans placements and prices checkpoints — the right tool at tens of
devices.  What it cannot do is answer *fleet-scale* questions ("how does
round time behave at 10⁵ devices under 2%/round churn with 5%
stragglers, sync vs async-quorum?") because every step walks Python
objects and constructs per-entity RNGs.

:class:`FleetSim` runs that sweep as array code: per-round straggler /
crash / flap masks come from the batched keyed streams
(:meth:`FaultPlan.crashes_batch` et al.), which are **bit-compatible**
with the stateless per-entity draws, and round time aggregates through
region-level reductions (per-region maxima, then across regions).

Two engines share every reduction and differ ONLY in how fault draws
are produced:

* ``engine="scalar"``   — one ``default_rng([seed, kind, entity, t])``
  per entity per draw, the scalar fault plan's contract verbatim (the
  baseline the speedup claims measure against);
* ``engine="vectorized"`` — one batched keyed-stream call per fault
  kind per round.

Because the keyed streams are lane-exact, the two engines produce
**bit-identical trajectories** — asserted in
tests/test_torch_fleet_scale.py, for both engines against each other and
against the JAX package's simulator.

Sync mode waits for every participant (the slowest straggler gates the
round); async mode closes the round at a ``quorum`` fraction of
participants (bounded-staleness local SGD), pricing the k-th order
statistic of finish times instead of the max.
"""

from __future__ import annotations

import time as _time
import zlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core.faultinject.plan import FaultPlan
from repro_torch.core.net.fleet_arrays import FleetArrays


def _substream(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                  zlib.crc32(name.encode())])


@dataclass(frozen=True)
class FleetSimConfig:
    rounds: int = 100
    seed: int = 0
    flops_per_round: float = 1e12       # per-device local work
    sync_bytes: float = 50e6            # per-device sync payload
    leave_prob: float = 0.0             # per round, per active device
    join_prob: float = 0.0              # per round, per idle device
    mode: str = "sync"                  # "sync" | "async"
    quorum: float = 0.9                 # async: round closes at this
                                        # fraction of participants
    fault_plan: Optional[FaultPlan] = None


@dataclass
class FleetSimResult:
    engine: str
    mode: str
    rounds: int
    wall_time_s: float                  # simulated clock
    step_times_s: np.ndarray            # (rounds,)
    active_counts: np.ndarray           # (rounds,)
    mean_active: float
    crashes: int
    flaps: int
    region_busy_s: Dict[str, float]     # per-region sum of device time
    elapsed_s: float                    # real wall clock of the sweep

    def trajectory_equal(self, other: "FleetSimResult") -> bool:
        """Bit-identical trajectories (the scalar/vectorized gate)."""
        return (np.array_equal(self.step_times_s, other.step_times_s)
                and np.array_equal(self.active_counts,
                                   other.active_counts)
                and self.crashes == other.crashes
                and self.flaps == other.flaps)


class FleetSim:
    """One sweep instance; call :meth:`run` once per (engine, config)."""

    def __init__(self, fleet: FleetArrays, cfg: FleetSimConfig):
        self.fleet = fleet
        self.cfg = cfg
        # per-device constants of the round model (shared by engines)
        self._base_compute = cfg.flops_per_round / fleet.eff_flops
        self._comm = (cfg.sync_bytes / fleet.acc_bw) \
            + (fleet.acc_delay + fleet.wan_delay[fleet.region_of])

    # ------------------------------------------------------------- draws
    def _slowdowns(self, engine: str) -> np.ndarray:
        plan = self.cfg.fault_plan
        n = self.fleet.num_devices
        if plan is None or plan.straggler_frac <= 0.0:
            return np.ones(n)
        if engine == "vectorized":
            return plan.slowdown_batch(np.arange(n))
        return np.array([plan.slowdown(int(i)) for i in range(n)])

    def _crashes(self, engine: str, ids: np.ndarray, t: int) -> np.ndarray:
        plan = self.cfg.fault_plan
        if plan is None or plan.crash_prob <= 0.0:
            return np.zeros(ids.shape[0], dtype=bool)
        if engine == "vectorized":
            return plan.crashes_batch(ids, t)
        return np.array([plan.crashes(int(i), t) for i in ids], dtype=bool)

    def _rejoins(self, engine: str, ids: np.ndarray, t: int) -> np.ndarray:
        plan = self.cfg.fault_plan
        if engine == "vectorized":
            return plan.rejoin_after_batch(ids, t)
        return np.array([plan.rejoin_after(int(i), t) for i in ids],
                        dtype=np.int64)

    def _jitter(self, engine: str, ids: np.ndarray, t: int) -> np.ndarray:
        plan = self.cfg.fault_plan
        if plan is None or plan.link_flap_prob <= 0.0:
            return np.zeros(ids.shape[0])
        if engine == "vectorized":
            return plan.jitter_batch(ids, t)
        return np.array([plan.jitter_s(int(i), t) for i in ids])

    # ---------------------------------------------------------- reduction
    def _round_time(self, ids: np.ndarray, finish: np.ndarray,
                    busy_acc: np.ndarray) -> float:
        """Aggregate a round: per-region maxima (and busy sums), then
        the cross-region reduction — max for sync, k-th order statistic
        of finish times for async quorum."""
        rid = self.fleet.region_of[ids]
        order = np.argsort(rid, kind="stable")
        rid_s = rid[order]
        fin_s = finish[order]
        starts = np.flatnonzero(np.r_[True, rid_s[1:] != rid_s[:-1]])
        reg_max = np.maximum.reduceat(fin_s, starts)
        np.add.at(busy_acc, rid_s[starts], np.add.reduceat(fin_s, starts))
        if self.cfg.mode == "async":
            k = max(1, int(np.ceil(self.cfg.quorum * ids.shape[0])))
            return float(np.partition(finish, k - 1)[k - 1])
        return float(reg_max.max())

    # ---------------------------------------------------------------- run
    def run(self, engine: str = "vectorized") -> FleetSimResult:
        if engine not in ("vectorized", "scalar"):
            raise ValueError(f"unknown engine {engine!r}")
        cfg = self.cfg
        fleet = self.fleet
        n = fleet.num_devices
        t_real = _time.perf_counter()
        slow = self._slowdowns(engine)
        base = self._base_compute
        comm = self._comm
        rng_leave = _substream(cfg.seed, "leave")
        rng_join = _substream(cfg.seed, "join")
        active = np.ones(n, dtype=bool)
        offline_until = np.zeros(n, dtype=np.int64)
        step_times = np.zeros(cfg.rounds)
        active_counts = np.zeros(cfg.rounds, dtype=np.int64)
        busy_acc = np.zeros(fleet.num_regions)
        crashes = 0
        flaps = 0
        wall = 0.0
        for t in range(cfg.rounds):
            # churn (both engines share these batched substream draws;
            # the engines differ only in the keyed FAULT draws)
            if cfg.leave_prob > 0.0:
                leave = rng_leave.random(n) < cfg.leave_prob
                active &= ~leave
            if cfg.join_prob > 0.0:
                join = rng_join.random(n) < cfg.join_prob
                active |= join & ~active & (t >= offline_until)
            if not active.any():
                active[0] = True
            ids = np.flatnonzero(active)
            # injected crashes: vanish before the round, rejoin later
            cr = self._crashes(engine, ids, t)
            if cr.any():
                crashed = ids[cr]
                waits = self._rejoins(engine, crashed, t)
                offline_until[crashed] = t + waits
                active[crashed] = False
                crashes += int(cr.sum())
                ids = np.flatnonzero(active)
                if ids.shape[0] == 0:
                    active[0] = True
                    ids = np.flatnonzero(active)
            # rejoin crashed devices whose wait expired
            back = (~active) & (offline_until > 0) & (t >= offline_until)
            if back.any():
                active |= back
                offline_until[back] = 0
                ids = np.flatnonzero(active)
            jit = self._jitter(engine, ids, t)
            flaps += int((jit > 0.0).sum())
            finish = (base[ids] * slow[ids] + comm[ids]) + jit
            dt = self._round_time(ids, finish, busy_acc)
            step_times[t] = dt
            active_counts[t] = ids.shape[0]
            wall += dt
        region_busy = {str(r): float(busy_acc[i])
                       for i, r in enumerate(fleet.regions)}
        return FleetSimResult(
            engine=engine, mode=cfg.mode, rounds=cfg.rounds,
            wall_time_s=wall, step_times_s=step_times,
            active_counts=active_counts,
            mean_active=float(active_counts.mean()),
            crashes=crashes, flaps=flaps,
            region_busy_s=region_busy,
            elapsed_s=_time.perf_counter() - t_real)


def churn_sweep(fleet: FleetArrays, cfg: FleetSimConfig, *,
                engine: str = "vectorized") -> FleetSimResult:
    """One-shot convenience wrapper: build a :class:`FleetSim`, run."""
    return FleetSim(fleet, cfg).run(engine)
