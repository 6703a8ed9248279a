"""Pricing elastic checkpoint write / recovery over the wide-area net (the
port's copy of ``repro.checkpoint.elastic``).

The §5 trade-off (checkpointing vs replication vs recomputation) only
means something if recovery is priced from *bytes actually missing*, not
a constant: a device that survives churn keeps its shard on local disk
and pays nothing; a joining device fetches only the layer slices its new
stage owns, from the nearest surviving holder (intra-region first, WAN
only when no same-region copy exists, the durable backbone store as the
last resort).  The naive baseline — every node of the new placement
pulls the *full* state from the store across the WAN — is what a
placement-blind checkpoint forces.

Transfers into distinct nodes run concurrently (disjoint access links);
transfers into the same node serialize on its access link — the same
alpha-beta discipline as :mod:`repro_torch.core.net.collectives`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.checkpoint.spec import CheckpointSpec
from repro_torch.core.net import Topology
from repro_torch.models import params as PM

STORE = "__store__"                   # durable copy at the backbone


@dataclass
class TransferCost:
    """Aggregate of one write or recovery round of transfers."""
    time_s: float = 0.0               # concurrent nodes, serialized per node
    bytes_moved: float = 0.0
    wan_bytes: float = 0.0            # subset crossing regions / the store
    energy_wh: float = 0.0            # radio energy of every endpoint
    per_region_bytes: Dict[str, float] = field(default_factory=dict)
    transfers: int = 0

    def _add_region(self, region: str, nbytes: float) -> None:
        self.per_region_bytes[region] = \
            self.per_region_bytes.get(region, 0.0) + nbytes


def state_layer_bytes(cfg, param_dtype: int = 2, moment_dtype: int = 4
                      ) -> Tuple[float, float]:
    """(bytes per decoder layer, placement-independent bytes) of the
    checkpointed train state (weights + two Adam moments — grads are not
    checkpointed)."""
    def _size(sub) -> int:
        tot, stack = 0, [sub]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            else:
                tot += x.size()
        return tot

    spec = PM.model_spec(cfg)
    total = _size(spec)
    dec = _size(spec["decoder"])
    per_param = param_dtype + 2 * moment_dtype
    return (dec * per_param / max(cfg.num_layers, 1),
            (total - dec) * per_param)


def _store_rtt_s(topo: Topology, node: str, nbytes: float) -> float:
    """Device <-> durable backbone store: access link then WAN uplink."""
    p = topo.params
    bw = min(topo.access_bw_Bps(node), p.wan_bw_Bps)
    delay = (p.access_latency_s + p.access_jitter_s
             + p.wan_latency_s + p.wan_jitter_s)
    return delay + nbytes / bw


def _charge(cost: TransferCost, busy: Dict[str, float], topo: Topology,
            src: str, dst: str, nbytes: float) -> None:
    """One transfer src -> dst (src may be the backbone STORE)."""
    if nbytes <= 0:
        return
    region = topo.device_region
    if STORE in (src, dst):
        dev = dst if src == STORE else src
        t = _store_rtt_s(topo, dev, nbytes)
        cost.wan_bytes += nbytes
        busy[dev] = busy.get(dev, 0.0) + t
    else:
        t = topo.p2p_time_s(nbytes, src, dst)
        if region[src] != region[dst]:
            cost.wan_bytes += nbytes
        busy[src] = busy.get(src, 0.0) + t
        busy[dst] = busy.get(dst, 0.0) + t
    cost.bytes_moved += nbytes
    cost._add_region(region[dst] if dst != STORE else "store", nbytes)
    cost.transfers += 1


def _finalize(cost: TransferCost, busy: Dict[str, float], topo: Topology
              ) -> TransferCost:
    cost.time_s = max(busy.values(), default=0.0)
    for n, t in busy.items():
        if n in topo.device_spec:
            cost.energy_wh += topo.device_spec[n].power_comm_w * t / 3600.0
    return cost


def write_cost(topo: Topology, placement, spec: CheckpointSpec,
               layer_bytes: float, global_bytes: float) -> TransferCost:
    """Price one checkpoint write under ``spec``.

    Every stage node snapshots its own slice to local disk for free;
    the network pays for (a) §5 neighbour replication — each writer
    pushes its shard to its ``replication`` downstream pipeline
    neighbours — and (b) one durable copy, uploaded shard-by-shard by
    replica 0 to the backbone store (stage 0 also uploads the
    placement-independent leaves).
    """
    cost = TransferCost()
    busy: Dict[str, float] = {}
    slices = spec.slices()
    for ri, pipe in enumerate(placement.pipelines):
        S = len(pipe)
        for i, sp in enumerate(pipe):
            shard_b = (slices[i][1] - slices[i][0]) * layer_bytes
            for k in range(1, spec.replication + 1):
                dst = pipe[(i + k) % S].node
                _charge(cost, busy, topo, sp.node, dst, shard_b)
            if ri == 0:
                up = shard_b + (global_bytes if i == 0 else 0.0)
                _charge(cost, busy, topo, sp.node, STORE, up)
    return _finalize(cost, busy, topo)


def heal_cost(topo: Topology,
              fetches: List[Tuple[str, str, float]]) -> TransferCost:
    """Price a self-healing restore's shard re-fetches.

    ``fetches`` is ``(src_holder, dst_node, nbytes)`` per healed file —
    what :func:`repro_torch.checkpoint.ckpt.heal_step` reports, mapped onto
    fleet nodes.  Same alpha-beta discipline as write/recovery: fetches
    into distinct nodes run concurrently, a source may be the backbone
    ``STORE`` (the WAN-priced last resort when every neighbour copy of a
    shard rotted).
    """
    cost = TransferCost()
    busy: Dict[str, float] = {}
    for src, dst, nbytes in fetches:
        _charge(cost, busy, topo, src, dst, nbytes)
    return _finalize(cost, busy, topo)


def _best_source(topo: Topology, dst: str, holders) -> Optional[str]:
    """Nearest surviving holder of a shard: the destination itself
    (free), else same-region, else any region, else the store."""
    region = topo.device_region
    alive = [h for h in holders if h in region]
    if dst in alive:
        return None
    same = sorted(h for h in alive if region[h] == region[dst])
    if same:
        return same[0]
    other = sorted(h for h in alive)
    if other:
        return other[0]
    return STORE


def recovery_cost(topo: Topology, new_placement, *,
                  old_spec: Optional[CheckpointSpec],
                  layer_bytes: float, global_bytes: float,
                  naive: bool = False) -> TransferCost:
    """Price restoring checkpointed state onto ``new_placement``.

    Placement-aware (default): each stage node of the new placement
    fetches only the layer ranges it does not already hold, per old
    shard, from the nearest surviving holder; brand-new nodes also fetch
    the placement-independent leaves from any old node.  ``naive=True``
    (or ``old_spec=None``) prices the placement-blind baseline: every
    node pulls the full state from the backbone store.
    """
    cost = TransferCost()
    busy: Dict[str, float] = {}
    L = new_placement.num_layers
    if old_spec is not None and old_spec.num_layers != L:
        raise ValueError(f"checkpoint spec has {old_spec.num_layers} "
                         f"layers, new placement {L}")
    total_bytes = L * layer_bytes + global_bytes
    if naive or old_spec is None:
        for pipe in new_placement.pipelines:
            for sp in pipe:
                _charge(cost, busy, topo, STORE, sp.node, total_bytes)
        return _finalize(cost, busy, topo)

    old_slices = old_spec.slices()
    old_nodes = sorted({n for hs in old_spec.holders for n in hs})
    for pipe in new_placement.pipelines:
        for sp in pipe:
            a, b = sp.layers.start, sp.layers.stop
            for o, (c, d) in enumerate(old_slices):
                lo, hi = max(a, c), min(b, d)
                if lo >= hi:
                    continue
                holders = old_spec.holders[o] if old_spec.holders else ()
                src = _best_source(topo, sp.node, holders)
                if src is None:
                    continue          # survivor still holds this range
                _charge(cost, busy, topo, src, sp.node,
                        (hi - lo) * layer_bytes)
            if sp.node not in old_nodes:
                # a joining device also needs the placement-independent
                # leaves (every old node replicates them)
                src = _best_source(topo, sp.node, old_nodes)
                if src is not None:
                    _charge(cost, busy, topo, src, sp.node, global_bytes)
    return _finalize(cost, busy, topo)
