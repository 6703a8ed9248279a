"""Fault-tolerance strategy trade-offs (§5: checkpointing vs replication vs
recomputation pose "trade-offs between carbon footprint and recovery
latency... identifying Pareto-optimal strategies"; the port's copy of
``repro.core.sched.faults``).

Model: device failures/departures are Poisson with rate λ per device; a
training run of W wall-seconds over N devices sees N·λ·W interruptions.

* checkpoint(interval I): overhead = ckpt_cost·W/I;  loss per failure = I/2
* replication(r):         overhead = (r-1)·100% compute; loss ≈ 0
* recomputation:          overhead = 0 steady-state; loss per failure =
                          full stage recompute (pipeline-depth dependent)

``pareto_frontier`` enumerates strategies and returns the non-dominated set
in (expected slowdown, carbon overhead) space.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class FaultModel:
    lambda_per_device_hour: float   # departure/failure rate
    num_devices: int
    step_time_s: float
    ckpt_write_s: float             # time to write a checkpoint
    ckpt_restore_s: float           # naive full-state restore
    stage_recompute_s: float        # recomputation cost per failure
    elastic_restore_s: Optional[float] = None
    # ^ placement-aware restore: only the departed node's shard moves
    # (priced from bytes via repro_torch.checkpoint.elastic); None disables
    # the elastic-checkpoint strategies


@dataclass(frozen=True)
class StrategyOutcome:
    name: str
    slowdown: float                 # expected wall-clock multiplier (>=1)
    energy_overhead: float          # extra energy fraction (>=0)

    def dominates(self, other: "StrategyOutcome") -> bool:
        return (self.slowdown <= other.slowdown
                and self.energy_overhead <= other.energy_overhead
                and (self.slowdown < other.slowdown
                     or self.energy_overhead < other.energy_overhead))


def checkpoint_outcome(fm: FaultModel, interval_steps: int, *,
                       elastic: bool = False) -> StrategyOutcome:
    lam_s = fm.lambda_per_device_hour * fm.num_devices / 3600.0
    interval_s = interval_steps * fm.step_time_s
    write_frac = fm.ckpt_write_s / interval_s
    if elastic:
        if fm.elastic_restore_s is None:
            raise ValueError("FaultModel.elastic_restore_s unset; price it "
                             "with priced_fault_model() first")
        restore_s = fm.elastic_restore_s
        name = f"elastic-ckpt@{interval_steps}"
    else:
        restore_s = fm.ckpt_restore_s
        name = f"checkpoint@{interval_steps}"
    # expected rework per failure = half an interval + restore
    rework_per_failure = interval_s / 2.0 + restore_s
    failure_frac = lam_s * rework_per_failure
    slow = 1.0 + write_frac + failure_frac
    return StrategyOutcome(name, slow, slow - 1.0)


def replication_outcome(fm: FaultModel, replicas: int = 2) -> StrategyOutcome:
    # hot standby: compute duplicated, failures nearly free
    lam_s = fm.lambda_per_device_hour * fm.num_devices / 3600.0
    residual = lam_s * fm.ckpt_restore_s * 0.1
    return StrategyOutcome(f"replicate-x{replicas}", 1.0 + residual,
                           float(replicas - 1) + residual)


def recompute_outcome(fm: FaultModel) -> StrategyOutcome:
    lam_s = fm.lambda_per_device_hour * fm.num_devices / 3600.0
    failure_frac = lam_s * fm.stage_recompute_s
    slow = 1.0 + failure_frac
    return StrategyOutcome("recompute", slow, slow - 1.0)


def pareto_frontier(fm: FaultModel,
                    ckpt_intervals: Sequence[int] = (10, 50, 100, 500),
                    ) -> List[StrategyOutcome]:
    cands = [checkpoint_outcome(fm, i) for i in ckpt_intervals]
    if fm.elastic_restore_s is not None:
        cands += [checkpoint_outcome(fm, i, elastic=True)
                  for i in ckpt_intervals]
    cands.append(replication_outcome(fm))
    cands.append(recompute_outcome(fm))
    frontier = [c for c in cands
                if not any(o.dominates(c) for o in cands if o is not c)]
    return sorted(frontier, key=lambda s: s.slowdown)


def priced_fault_model(cfg, placement, *, lambda_per_device_hour: float,
                       step_time_s: float, stage_recompute_s: float,
                       replication: int = 1) -> FaultModel:
    """Price a FaultModel's checkpoint terms from the placement and the
    wide-area topology instead of constants.

    ``ckpt_write_s`` is one elastic write (neighbour replication + store
    upload), ``ckpt_restore_s`` the naive full-state restore every node
    of the placement would pay, and ``elastic_restore_s`` the
    placement-aware recovery after losing one device (its shard refetched
    from the surviving neighbour copies; everyone else's state is local).
    """
    from repro_torch.checkpoint import (CheckpointSpec, recovery_cost,
                                  state_layer_bytes, write_cost)
    topo = placement.topology
    layer_b, global_b = state_layer_bytes(cfg)
    spec = CheckpointSpec.from_placement(placement, replication)
    wc = write_cost(topo, placement, spec, layer_b, global_b)
    naive = recovery_cost(topo, placement, old_spec=spec,
                          layer_bytes=layer_b, global_bytes=global_b,
                          naive=True)
    # one failure: the first stage-0 node loses its local copies
    failed = placement.pipelines[0][0].node
    survivors = spec.with_holders(
        [[n for n in hs if n != failed] for hs in spec.holders])
    el = recovery_cost(topo, placement, old_spec=survivors,
                       layer_bytes=layer_b, global_bytes=global_b)
    nodes = {sp.node for pipe in placement.pipelines for sp in pipe}
    return FaultModel(
        lambda_per_device_hour=lambda_per_device_hour,
        num_devices=len(nodes), step_time_s=step_time_s,
        ckpt_write_s=wc.time_s, ckpt_restore_s=naive.time_s,
        stage_recompute_s=stage_recompute_s,
        elastic_restore_s=el.time_s)
