"""DT-FM-style data+pipeline-parallel planner for heterogeneous edge fleets
(the port's copy of ``repro.core.planner.dtfm``).

The paper's Table 2 uses DT-FM [98] (Yuan et al., NeurIPS'22): the model is
cut into pipeline stages held by different devices; multiple pipelines run
data-parallel.  The planner prices a :class:`~repro_torch.core.placement.
PlacementSpec` — the shared plan→place→execute contract:

* each replica's stages own **non-uniform** contiguous layer ranges,
  balanced so per-stage time matches under heterogeneous compute,
* the GPipe schedule makespan is bubble-aware ((mb+S-1) ticks gated by
  the slowest stage of the slowest replica),
* communication is priced through the wide-area :class:`Topology`:
  stage-boundary activations travel point-to-point along each replica's
  own device→region→backbone path (cross-region hops are WAN bytes),
  and data-parallel gradient sync runs the chosen collective over each
  stage slot's replica group — intra-region first when the placement
  grouped replicas per region — amortized over the local-SGD
  ``sync_interval``,
* per-device energy (active/stall/comm, comm priced per-link) is what
  Table 2 reports.

:func:`plan` keeps the legacy contract (one device list in caller order,
``data_parallel`` analytic clone replicas); :func:`plan_placement`
prices any :class:`PlacementSpec`, including the topology-aware ones
:func:`repro_torch.core.placement.search_placement` emits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core import flops as F
from repro_torch.core.energy.devices import DeviceSpec
from repro_torch.core.net import Topology, sync_cost
from repro_torch.core.placement import (PlacementSpec, balanced_boundaries,
                                  ordered_placement)
from repro_torch.models.config import ModelConfig
from repro_torch.optim.compress import CompressConfig


@dataclass(frozen=True)
class StageAssignment:
    device: DeviceSpec
    layers: range
    flops_per_microbatch: float
    time_per_microbatch_s: float
    node: str = ""                    # topology node id


def _stage_key(s) -> str:
    """Key tying a stage to its energy-ledger entries."""
    return f"{s.device.name}@L{s.layers.start}-{s.layers.stop}"


@dataclass
class DTFMPlan:
    model: str
    stages: List[StageAssignment]     # replica 0 (reference pipeline)
    data_parallel: int
    microbatches: int
    step_time_s: float
    bubble_fraction: float
    comm_s_per_step: float
    energy_wh_per_step: Dict[str, float] = field(default_factory=dict)
    boundary_s_per_step: float = 0.0
    dp_sync_s_per_step: float = 0.0
    wire_bytes_per_step: float = 0.0
    comm_busy_s: Dict[str, float] = field(default_factory=dict)  # by node
    wan_bytes_per_step: float = 0.0   # subset of wire crossing regions
    comm_energy_wh_per_step: float = 0.0
    placement: Optional[PlacementSpec] = None

    @property
    def total_energy_wh_per_step(self) -> float:
        return sum(self.energy_wh_per_step.values())


def partition_layers(cfg: ModelConfig, devices: Sequence[DeviceSpec]
                     ) -> List[range]:
    """Contiguous layer split ∝ device effective FLOP/s (heterogeneity-aware)."""
    bounds = balanced_boundaries(cfg.num_layers,
                                 [d.effective_flops for d in devices])
    return [range(bounds[i], bounds[i + 1]) for i in range(len(devices))]


def plan_placement(cfg: ModelConfig, spec: PlacementSpec, *,
                   batch: int, seq_len: int, microbatches: int = 8,
                   train: bool = True, collective: str = "ring",
                   compress: Optional[CompressConfig] = None,
                   sync_interval: int = 1) -> DTFMPlan:
    """Price a placement: makespan + boundary comm + DP sync + energy.

    This is the cost model
    :func:`repro_torch.core.placement.search_placement` minimizes.
    """
    spec.validate()
    dp = spec.data_parallel
    if dp > batch:
        raise ValueError(
            f"data_parallel={dp} exceeds batch={batch}: "
            "each replica would get a zero-sized microbatch")
    topo = spec.topology
    total_flops = F.train_flops(cfg, batch // dp, seq_len,
                                remat=False) if train \
        else F.fwd_flops(cfg, batch // dp, seq_len)
    per_layer = total_flops / cfg.num_layers
    mb = microbatches
    S = spec.num_stages

    def t_mb(sp) -> float:
        return per_layer * len(sp.layers) / mb / sp.device.effective_flops

    stages = [StageAssignment(sp.device, sp.layers,
                              per_layer * len(sp.layers) / mb,
                              t_mb(sp), sp.node) for sp in spec.stages]

    # GPipe makespan: (mb + S - 1) ticks gated by the slowest stage of
    # the slowest replica (synchronous data parallelism)
    t_stage = max(t_mb(sp) for pipe in spec.pipelines for sp in pipe)
    makespan = (mb + S - 1) * t_stage
    bubble = (S - 1) / (mb + S - 1)

    region = topo.device_region
    comm_busy: Dict[str, float] = {sp.node: 0.0
                                   for pipe in spec.pipelines for sp in pipe}
    for group in spec.dp_sync_nodes:      # sync-group overrides (dp_regions)
        for n in group:
            comm_busy.setdefault(n, 0.0)

    # stage-boundary activations, fwd (+ bwd for training), per microbatch
    # chunk over each replica's own hierarchical path; replicas run
    # concurrently (disjoint links), so the slowest replica gates time
    # while wire/WAN bytes sum over all of them
    act_bytes = (batch // dp) * seq_len * cfg.d_model * 2
    directions = 2 if train else 1
    boundary_s = 0.0
    boundary_wire = 0.0
    boundary_wan = 0.0
    for pipe in spec.pipelines:
        t_rep = 0.0
        for a, b in zip(pipe[:-1], pipe[1:]):
            t_pair = directions * mb * topo.p2p_time_s(act_bytes / mb,
                                                       a.node, b.node)
            t_rep += t_pair
            comm_busy[a.node] += t_pair
            comm_busy[b.node] += t_pair
            boundary_wire += directions * act_bytes
            if region[a.node] != region[b.node]:
                boundary_wan += directions * act_bytes
        boundary_s = max(boundary_s, t_rep)

    # DP gradient sync: each stage slot's grad shard all-reduces across
    # that slot's replica group (concurrent across slots — disjoint
    # links — so the slowest slot gates), amortized over the
    # local-update interval
    dp_sync_s = 0.0
    dp_wire = 0.0
    dp_wan = 0.0
    if train and dp > 1:
        n_elems_total = F.param_bytes(cfg, 1)
        for i in range(S):
            group = spec.dp_group(i)
            shard = int(n_elems_total
                        * len(spec.pipelines[0][i].layers) / cfg.num_layers)
            c = sync_cost(topo, group, shard, algorithm=collective,
                          compress=compress, dtype_bytes=2,
                          sync_interval=sync_interval)
            dp_sync_s = max(dp_sync_s, c.time_s)
            for n in group:
                comm_busy[n] += c.per_device_busy_s.get(n, 0.0)
            dp_wire += c.wire_bytes
            dp_wan += c.wan_bytes
    comm_s = boundary_s + dp_sync_s

    # energy: active while computing own microbatches, idle during bubble
    # and comm, network module during this device's own transfers
    energy: Dict[str, float] = {}
    comm_energy_wh = 0.0
    pipe_nodes = set()
    for pipe in spec.pipelines:
        for sp in pipe:
            pipe_nodes.add(sp.node)
            active_s = t_mb(sp) * mb
            stall_s = max(0.0, makespan - active_s)
            e_comm = sp.device.power_comm_w * comm_busy[sp.node]
            e = (sp.device.power_active_w * active_s
                 + sp.device.power_idle_w * stall_s
                 + e_comm)
            key = _stage_key(sp)
            energy[key] = energy.get(key, 0.0) + e / 3600.0
            comm_energy_wh += e_comm / 3600.0
    for n, busy in comm_busy.items():
        # dp_sync_nodes overrides sync from regions the pipelines don't
        # compute in; their radio time is the stage device's (same spec)
        if n in pipe_nodes or busy == 0.0:
            continue
        e_comm = topo.device_spec[n].power_comm_w * busy
        energy[f"sync:{n}"] = energy.get(f"sync:{n}", 0.0) + e_comm / 3600.0
        comm_energy_wh += e_comm / 3600.0

    return DTFMPlan(cfg.name, stages, dp, mb,
                    makespan + comm_s, bubble, comm_s, energy,
                    boundary_s_per_step=boundary_s,
                    dp_sync_s_per_step=dp_sync_s,
                    wire_bytes_per_step=boundary_wire + dp_wire,
                    comm_busy_s=comm_busy,
                    wan_bytes_per_step=boundary_wan + dp_wan,
                    comm_energy_wh_per_step=comm_energy_wh,
                    placement=spec)


def plan(cfg: ModelConfig, devices: Sequence[DeviceSpec], *,
         batch: int, seq_len: int, microbatches: int = 8,
         data_parallel: int = 1, train: bool = True,
         topology: Optional[Topology] = None,
         nodes: Optional[Sequence[str]] = None,
         collective: str = "ring",
         compress: Optional[CompressConfig] = None,
         sync_interval: int = 1,
         dp_regions: Optional[Sequence[str]] = None) -> DTFMPlan:
    """Plan one pipeline of ``devices`` with ``data_parallel`` replicas.

    Legacy caller-order contract: builds an
    :func:`~repro_torch.core.placement.ordered_placement` (synthesizing a
    single-region topology when none is given; ``dp_regions`` spreads
    the clone replicas across regions) and prices it with
    :func:`plan_placement`.
    """
    if data_parallel < 1:
        raise ValueError(f"data_parallel={data_parallel} must be >= 1")
    if data_parallel > batch:
        raise ValueError(
            f"data_parallel={data_parallel} exceeds batch={batch}: "
            "each replica would get a zero-sized microbatch")
    if topology is None:
        if nodes is not None:
            raise ValueError("nodes= only makes sense with an explicit "
                             "topology=; the synthesized topology would "
                             "silently ignore it")
    elif nodes is None:
        # positional fallback would silently price links for the wrong
        # device whenever caller order differs from topology insertion
        # order — require the mapping
        raise ValueError(
            "an explicit topology needs nodes= mapping each device to "
            "its topology node id")
    elif len(nodes) < len(devices):
        raise ValueError(
            f"nodes places only {len(nodes)} devices but the pipeline "
            f"has {len(devices)}")
    spec = ordered_placement(cfg, devices, topology=topology, nodes=nodes,
                             data_parallel=data_parallel,
                             dp_regions=dp_regions)
    return plan_placement(cfg, spec, batch=batch, seq_len=seq_len,
                          microbatches=microbatches, train=train,
                          collective=collective, compress=compress,
                          sync_interval=sync_interval)


def min_bw_comm_s(cfg: ModelConfig, devices: Sequence[DeviceSpec], *,
                  batch: int, seq_len: int, data_parallel: int = 1,
                  train: bool = True) -> float:
    """The seed's flat min-bandwidth communication model, kept as the
    baseline the benchmarks compare the topology-aware pricing against."""
    splits = partition_layers(cfg, devices)
    S = sum(1 for r in splits if len(r))
    act_bytes = (batch // data_parallel) * seq_len * cfg.d_model * 2
    boundary_bytes = (2 if train else 1) * (S - 1) * act_bytes
    grad_bytes = F.param_bytes(cfg, 2) if (train and data_parallel > 1) \
        else 0.0
    bw = min(d.net_bw_Bps for d in devices)
    return boundary_bytes / bw + grad_bytes / bw


def table2_energy(cfg: ModelConfig, device: DeviceSpec, count: int, *,
                  batch: int = 16, seq_len: int = 512, steps: int = 100,
                  microbatches: int = 32) -> Dict[str, float]:
    """Homogeneous-fleet energy for the paper's Table 2 setting."""
    p = plan(cfg, [device] * count, batch=batch, seq_len=seq_len,
             microbatches=microbatches)
    return {
        "devices": count,
        "step_time_s": p.step_time_s,
        "bubble_fraction": p.bubble_fraction,
        "energy_wh": p.total_energy_wh_per_step * steps,
        "comm_s_per_step": p.comm_s_per_step,
    }
