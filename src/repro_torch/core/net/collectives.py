"""Analytic cost models for collectives over a wide-area :class:`Topology`
(the port's own copy of the scalar models in ``repro.core.net.collectives``;
the batched array versions come with the fleet control plane).

Each model answers, for a participant group and a per-device payload of
``nbytes``: how long does the collective take, how many bytes cross the
wire in total, how many of those cross the WAN, and how long is each
device's radio busy (which is what its ``power_comm_w`` multiplies).

The algorithms:

* ``ring``        — bandwidth-optimal flat ring allreduce
                    (reduce-scatter + allgather, Patarasuk & Yuan).
* ``tree``        — binomial-tree reduce + broadcast: latency-optimal,
                    2x the bytes of ring at the bottleneck.
* ``hierarchical``— intra-region ring, inter-region ring over the region
                    leaders, intra-region broadcast — crosses the WAN
                    O(R) times instead of O(N) (DT-FM / Gaia style).
* ``gossip``      — randomized pairwise averaging; approximate consensus
                    in O(log N) rounds, no global barrier.
* ``allgather``   — ring allgather of per-device shards.

Every transfer is priced ``delay + bytes/bw`` on the bottleneck link of
its path, with concurrent same-step transfers overlapped (the slowest
one gates the step) — the standard alpha-beta model lifted onto the
hierarchical topology.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.net.topology import Topology
from repro_torch.optim.compress import wire_bytes_count


@dataclass(frozen=True)
class CollectiveCost:
    algorithm: str
    participants: int
    time_s: float
    wire_bytes: float                  # total bytes over all links
    wan_bytes: float                   # subset crossing inter-region links
    per_device_busy_s: Dict[str, float] = field(default_factory=dict)
    per_device_bytes: Dict[str, float] = field(default_factory=dict)


def _by_region(topo: Topology, group: Sequence[str]) -> List[str]:
    """Ring order minimizing WAN crossings: contiguous region blocks."""
    return sorted(group, key=lambda d: (topo.device_region[d], d))


def _region_blocks(topo: Topology, group: Sequence[str]) -> Dict[str, List[str]]:
    blocks: Dict[str, List[str]] = {}
    for d in group:
        blocks.setdefault(topo.device_region[d], []).append(d)
    return blocks


def ring_allreduce(topo: Topology, group: Sequence[str], nbytes: float
                   ) -> CollectiveCost:
    """Flat ring: 2(N-1) steps of nbytes/N chunks.

    time = 2(N-1)/N * nbytes / bottleneck_bw + 2(N-1) * step_delay
    """
    group = _by_region(topo, group)
    n = len(group)
    if n <= 1:
        return CollectiveCost("ring", n, 0.0, 0.0, 0.0,
                              {d: 0.0 for d in group},
                              {d: 0.0 for d in group})
    chunk = nbytes / n
    bw = topo.group_bottleneck_bw_Bps(group)
    # every step some neighbour pair spans the worst path in the ring
    delay = max(topo.path_delay_s(group[i], group[(i + 1) % n])
                for i in range(n))
    steps = 2 * (n - 1)
    time = steps * (chunk / bw + delay)
    busy = {d: steps * chunk / topo.access_bw_Bps(d) for d in group}
    per_dev = {d: steps * chunk for d in group}
    regions = len(_region_blocks(topo, group))
    wan = steps * regions * chunk if regions > 1 else 0.0
    return CollectiveCost("ring", n, time, steps * chunk * n, wan,
                          busy, per_dev)


def tree_allreduce(topo: Topology, group: Sequence[str], nbytes: float
                   ) -> CollectiveCost:
    """Binomial reduce-to-root + broadcast: 2*ceil(log2 N) full-payload
    rounds — fewer latency terms than ring, more bottleneck bytes."""
    group = _by_region(topo, group)
    n = len(group)
    if n <= 1:
        return CollectiveCost("tree", n, 0.0, 0.0, 0.0,
                              {d: 0.0 for d in group},
                              {d: 0.0 for d in group})
    rounds = 2 * math.ceil(math.log2(n))
    bw = topo.group_bottleneck_bw_Bps(group)
    delay = topo.group_max_delay_s(group)
    time = rounds * (nbytes / bw + delay)
    # each non-root sends the vector up once and receives it down once
    wire = 2 * (n - 1) * nbytes
    busy = {d: 2 * nbytes / topo.access_bw_Bps(d) for d in group}
    per_dev = {d: 2 * nbytes for d in group}
    regions = len(_region_blocks(topo, group))
    wan = 2 * (regions - 1) * nbytes if regions > 1 else 0.0
    return CollectiveCost("tree", n, time, wire, wan, busy, per_dev)


def hierarchical_allreduce(topo: Topology, group: Sequence[str],
                           nbytes: float) -> CollectiveCost:
    """Three-phase hierarchical allreduce (Horovod/Gaia style):

    1. intra-region ring reduce-scatter — each device ends with a
       region-reduced shard,
    2. cross-region ring allreduce of the shards — the region's
       aggregate flow is carried collectively by its members, so each
       region uplink moves 2(R-1)/R * nbytes instead of sitting inside
       every one of the flat ring's 2(N-1) steps,
    3. intra-region ring allgather of the now-global shards.

    Per-device access-link traffic stays at the ring-optimal
    ~2(n_r-1)/n_r * nbytes, while WAN traffic and WAN latency hits drop
    from O(N) to O(R).
    """
    blocks = _region_blocks(topo, group)
    regions = sorted(blocks)
    R = len(regions)
    if R <= 1:
        return ring_allreduce(topo, group, nbytes)

    busy = {d: 0.0 for d in group}
    per_dev = {d: 0.0 for d in group}
    wire = 0.0

    # phases 1 + 3: concurrent intra-region reduce-scatter + allgather,
    # together one full ring allreduce worth of intra traffic
    t_intra = 0.0
    for region in regions:
        members = blocks[region]
        c = ring_allreduce(topo, members, nbytes)
        t_intra = max(t_intra, c.time_s)
        wire += c.wire_bytes
        for d in members:
            busy[d] += c.per_device_busy_s.get(d, 0.0)
            per_dev[d] += c.per_device_bytes.get(d, 0.0)

    # phase 2: ring over regions; each step moves nbytes/R per region,
    # split across that region's members' access links and funnelled
    # through the shared region uplink
    leaders = [blocks[r][0] for r in regions]
    wan_delay = max(topo.path_delay_s(leaders[i], leaders[(i + 1) % R])
                    for i in range(R))
    chunk = nbytes / R
    steps = 2 * (R - 1)
    t_wan = 0.0
    for region in regions:
        members = blocks[region]
        acc = min(topo.access_bw_Bps(d) for d in members)
        per_member = chunk / len(members)
        t_wan = max(t_wan, max(chunk / topo.params.wan_bw_Bps,
                               per_member / acc))
        for d in members:
            busy[d] += steps * per_member / topo.access_bw_Bps(d)
            per_dev[d] += steps * per_member
    t_inter = steps * (t_wan + wan_delay)
    wan = steps * chunk * R            # every region uplink, both phases
    wire += wan

    return CollectiveCost("hierarchical", len(group),
                          t_intra + t_inter, wire, wan, busy, per_dev)


def gossip_average(topo: Topology, group: Sequence[str], nbytes: float, *,
                   rounds: Optional[int] = None) -> CollectiveCost:
    """Randomized pairwise averaging (approximate — no exact allreduce):
    each round every device exchanges its full payload with one peer."""
    n = len(group)
    if n <= 1:
        return CollectiveCost("gossip", n, 0.0, 0.0, 0.0,
                              {d: 0.0 for d in group},
                              {d: 0.0 for d in group})
    rounds = rounds if rounds is not None else math.ceil(math.log2(n))
    bw = topo.group_bottleneck_bw_Bps(group)
    delay = topo.group_max_delay_s(group)
    time = rounds * (nbytes / bw + delay)
    wire = rounds * n * nbytes
    regions = len(_region_blocks(topo, group))
    # expected fraction of random pairs that cross a region boundary
    wan = wire * (1.0 - 1.0 / regions) if regions > 1 else 0.0
    busy = {d: rounds * nbytes / topo.access_bw_Bps(d) for d in group}
    per_dev = {d: rounds * nbytes for d in group}
    return CollectiveCost("gossip", n, time, wire, wan, busy, per_dev)


def ring_allgather(topo: Topology, group: Sequence[str], shard_bytes: float
                   ) -> CollectiveCost:
    """Ring allgather: N-1 steps, each forwarding one device's shard."""
    group = _by_region(topo, group)
    n = len(group)
    if n <= 1:
        return CollectiveCost("allgather", n, 0.0, 0.0, 0.0,
                              {d: 0.0 for d in group},
                              {d: 0.0 for d in group})
    bw = topo.group_bottleneck_bw_Bps(group)
    delay = max(topo.path_delay_s(group[i], group[(i + 1) % n])
                for i in range(n))
    steps = n - 1
    time = steps * (shard_bytes / bw + delay)
    busy = {d: steps * shard_bytes / topo.access_bw_Bps(d) for d in group}
    per_dev = {d: steps * shard_bytes for d in group}
    regions = len(_region_blocks(topo, group))
    wan = steps * regions * shard_bytes if regions > 1 else 0.0
    return CollectiveCost("allgather", n, time, steps * shard_bytes * n,
                          wan, busy, per_dev)


COLLECTIVES: Dict[str, Callable[..., CollectiveCost]] = {
    "ring": ring_allreduce,
    "tree": tree_allreduce,
    "hierarchical": hierarchical_allreduce,
    "gossip": gossip_average,
    "allgather": ring_allgather,
}


def collective_cost(topo: Topology, group: Sequence[str], nbytes: float,
                    algorithm: str = "ring") -> CollectiveCost:
    try:
        fn = COLLECTIVES[algorithm]
    except KeyError:
        raise ValueError(f"unknown collective {algorithm!r}; "
                         f"have {sorted(COLLECTIVES)}") from None
    return fn(topo, group, nbytes)


def sync_cost(topo: Topology, group: Sequence[str], num_elements: int, *,
              algorithm: str = "ring", compress=None,
              dtype_bytes: int = 4, sync_interval: int = 1
              ) -> CollectiveCost:
    """Gradient-sync cost with compression and local-update amortization.

    ``compress`` is a :class:`repro_torch.optim.compress.CompressConfig`;
    the payload is the *wire* byte count that compressor actually transmits
    (``optim.compress.wire_bytes_count``), so collective choice and
    compression compose.  ``sync_interval`` is the local-SGD K: one sync
    per K steps, so per-step cost divides by K.
    """
    nbytes = wire_bytes_count(num_elements, compress,
                              dtype_bytes=dtype_bytes)
    c = collective_cost(topo, group, nbytes, algorithm)
    k = max(1, sync_interval)
    if k == 1:
        return c
    return CollectiveCost(
        c.algorithm, c.participants, c.time_s / k, c.wire_bytes / k,
        c.wan_bytes / k,
        {d: v / k for d, v in c.per_device_busy_s.items()},
        {d: v / k for d, v in c.per_device_bytes.items()})
