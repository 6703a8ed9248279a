"""Analytic cost models for collectives over a wide-area :class:`Topology`
(the port's own copy of ``repro.core.net.collectives``: the scalar models
and their batched array versions over ``FleetArrays``).

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

import numpy as np

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


# --------------------------------------------------------------------------
# Batched kernels over FleetArrays: price EVERY group of a placement (or a
# whole sweep of candidate groups) in one vectorized call, bit-identical to
# the scalar models above.  The scalar models are sequences of IEEE-754 ops
# (Python left folds, `max` chains, `min` of lists); the array versions
# replay the exact same op sequence per group lane:
#
#   * segment min/max via ufunc.reduceat  — safe, order-independent;
#   * sequential += folds (hierarchical wire) as short loops over REGION
#     slots, never np.add.reduce (pairwise summation would change bits);
#   * the O(n²) pairwise group_max_delay of tree collapses to O(n): block
#     top-2 access delays (same-region pairs, one symmetric add) plus an
#     exclusive block-prefix max of x_i = da_i + w_i (cross pairs), valid
#     because double rounding is monotone so argmax commutes with the
#     (x + w_j) + da_j post-ops.
#
# Parity with the scalar models (0 mismatches across all algorithms) is
# asserted in the port's fleet-scale tests.


@dataclass(frozen=True)
class BatchedCollectiveCost:
    """Per-group cost columns + per-member busy/bytes columns.

    Members are returned in the kernel's canonical order (``member_*``
    arrays): sorted by group, then by the scalar ``_by_region`` ring
    order — ``member_device[i]`` is a row into the priced
    :class:`~repro_torch.core.net.fleet_arrays.FleetArrays`.
    """
    algorithm: str
    group_ids: np.ndarray       # (G,) sorted unique group labels
    participants: np.ndarray    # (G,) members per group
    time_s: np.ndarray          # (G,)
    wire_bytes: np.ndarray      # (G,)
    wan_bytes: np.ndarray       # (G,)
    member_device: np.ndarray   # (M,) fleet rows, canonical order
    member_group: np.ndarray    # (M,) index into group_ids
    busy_s: np.ndarray          # (M,)
    bytes_dev: np.ndarray       # (M,)

    def group(self, g: int) -> int:
        return int(np.searchsorted(self.group_ids, g))


def _segment_index(grp_sorted: np.ndarray):
    gids, seg_start, n_g = np.unique(grp_sorted, return_index=True,
                                     return_counts=True)
    seg_of = np.repeat(np.arange(gids.shape[0]), n_g)
    return gids, seg_start, n_g, seg_of


def _ring_segments(seg_start, n_g, seg_of, accbw, accd, rid, wdm,
                   wan_bw, chunk, steps):
    """Ring allreduce/allgather over contiguous region-sorted segments.

    ``chunk``/``steps`` are per-segment (callers encode allreduce's
    nbytes/n · 2(n-1) vs allgather's shard · (n-1)).  Returns per-segment
    time/wire/wan/regions and per-member busy/bytes, each the scalar
    formula's exact op sequence.  n==1 segments price to zero naturally
    (steps == 0), matching the scalar early return.
    """
    M = accbw.shape[0]
    nxt = np.arange(1, M + 1)
    nxt[seg_start + n_g - 1] = seg_start          # ring wrap per segment
    cross = rid != rid[nxt]
    d_pair = np.where(cross,
                      ((accd + wdm) + wdm[nxt]) + accd[nxt],
                      accd + accd[nxt])
    delay = np.maximum.reduceat(d_pair, seg_start)
    bmin = np.minimum.reduceat(accbw, seg_start)
    prev_same = np.zeros(M, bool)
    prev_same[1:] = seg_of[1:] == seg_of[:-1]
    same_reg = np.zeros(M, bool)
    same_reg[1:] = rid[1:] == rid[:-1]
    newblk = ~(prev_same & same_reg)
    regions = np.add.reduceat(newblk.astype(np.int64), seg_start)
    bw = np.where(regions > 1, np.minimum(bmin, wan_bw), bmin)
    time = steps * (chunk / bw + delay)
    wire = (steps * chunk) * n_g
    wan = np.where(regions > 1, (steps * regions) * chunk, 0.0)
    chunk_m = chunk[seg_of]
    steps_m = steps[seg_of]
    busy = (steps_m * chunk_m) / accbw
    nbytes_m = steps_m * chunk_m
    return time, wire, wan, regions, newblk, busy, nbytes_m


def _block_tables(seg_start, n_g, seg_of, newblk):
    """Contiguous (group, region) block structure over sorted members."""
    block_start = np.flatnonzero(newblk)
    blk_of = np.cumsum(newblk) - 1
    blocks_per = np.add.reduceat(newblk.astype(np.int64), seg_start)
    first_blk = np.concatenate(([0], np.cumsum(blocks_per)[:-1]))
    blk_grp = seg_of[block_start]
    slot = np.arange(block_start.shape[0]) - first_blk[blk_grp]
    return block_start, blk_of, blocks_per, first_blk, blk_grp, slot


def _group_max_delay_sorted(seg_start, n_g, seg_of, accd, rid, wdm, newblk):
    """``group_max_delay_s`` per segment, members in (region, node) order.

    Same-region pairs contribute da_i + da_j (symmetric single add →
    block top-2).  Cross pairs contribute ((da_i + w_i) + w_j) + da_j for
    i before j; rounding monotonicity lets the max over i collapse to an
    exclusive prefix-max of x_i = da_i + w_i over earlier region blocks.
    """
    (block_start, blk_of, blocks_per, first_blk, blk_grp,
     slot) = _block_tables(seg_start, n_g, seg_of, newblk)
    B = block_start.shape[0]
    G = seg_start.shape[0]
    x = accd + wdm
    max_x_b = np.maximum.reduceat(x, block_start)
    top1_da = np.maximum.reduceat(accd, block_start)
    ismax = accd == top1_da[blk_of]
    cs = np.cumsum(ismax.astype(np.int64))
    before = cs[block_start] - ismax[block_start]
    first = ismax & ((cs - before[blk_of]) == 1)
    top2_da = np.maximum.reduceat(np.where(first, -np.inf, accd),
                                  block_start)
    same_b = top1_da + top2_da                    # -inf: singleton block
    rmax = int(blocks_per.max())
    dense_x = np.full((G, rmax), -np.inf)
    dense_x[blk_grp, slot] = max_x_b
    pref = np.full((G, rmax), -np.inf)
    for k in range(1, rmax):
        pref[:, k] = np.maximum(pref[:, k - 1], dense_x[:, k - 1])
    m_b = pref[blk_grp, slot]                     # -inf: first block
    cross_b = (m_b + wdm[block_start]) + top1_da
    cand = np.maximum(same_b, cross_b)
    return np.maximum(np.maximum.reduceat(cand, first_blk), 0.0)


def batched_collective_cost(fleet, member_device, member_group,
                            nbytes, algorithm: str = "ring", *,
                            rounds: Optional[int] = None
                            ) -> BatchedCollectiveCost:
    """Price every group of a placement in one vectorized call.

    ``member_device``/``member_group`` are parallel arrays: fleet row →
    group label.  ``nbytes`` is a scalar or per-group array aligned with
    the sorted unique group labels.  Output values are bit-identical to
    running the matching scalar model per group on
    ``fleet.to_topology()``.
    """
    if algorithm not in COLLECTIVES:
        raise ValueError(f"unknown collective {algorithm!r}; "
                         f"have {sorted(COLLECTIVES)}")
    device = np.asarray(member_device, dtype=np.int64).ravel()
    grp_in = np.asarray(member_group, dtype=np.int64).ravel()
    if device.shape[0] == 0:
        z = np.zeros(0)
        return BatchedCollectiveCost(algorithm, np.zeros(0, np.int64),
                                     np.zeros(0, np.int64), z, z, z,
                                     device, grp_in, z, z)
    if algorithm == "gossip":
        # the scalar model does NOT ring-sort the group: keep caller
        # member order (stable) — pairwise delay is order-sensitive
        order = np.argsort(grp_in, kind="stable")
    else:
        order = np.lexsort((fleet.name_rank[device], grp_in))
    dev = device[order]
    gids, seg_start, n_g, seg_of = _segment_index(grp_in[order])
    G = gids.shape[0]
    nb = np.broadcast_to(
        np.asarray(nbytes, dtype=np.float64).ravel(), (G,))
    accbw = fleet.acc_bw[dev]
    accd = fleet.acc_delay[dev]
    rid = fleet.region_of[dev].astype(np.int64)
    wdm = fleet.wan_delay[rid]
    wan_bw = fleet.params.wan_bw_Bps

    if algorithm in ("ring", "allgather"):
        if algorithm == "ring":
            chunk, steps = nb / n_g, 2 * (n_g - 1)
        else:
            chunk, steps = nb + np.zeros(G), n_g - 1
        time, wire, wan, _, _, busy, bytes_m = _ring_segments(
            seg_start, n_g, seg_of, accbw, accd, rid, wdm, wan_bw,
            chunk, steps)
        return BatchedCollectiveCost(algorithm, gids, n_g, time, wire,
                                     wan, dev, seg_of, busy, bytes_m)

    if algorithm == "tree":
        _, _, _, regions, newblk, _, _ = _ring_segments(
            seg_start, n_g, seg_of, accbw, accd, rid, wdm, wan_bw,
            nb / n_g, 2 * (n_g - 1))
        bmin = np.minimum.reduceat(accbw, seg_start)
        bw = np.where(regions > 1, np.minimum(bmin, wan_bw), bmin)
        delay = _group_max_delay_sorted(seg_start, n_g, seg_of, accd,
                                        rid, wdm, newblk)
        nrounds = (2 * np.ceil(np.log2(n_g))).astype(np.int64)
        multi = n_g > 1
        time = np.where(multi, nrounds * (nb / bw + delay), 0.0)
        wire = np.where(multi, (2 * (n_g - 1)) * nb, 0.0)
        wan = np.where(multi & (regions > 1), (2 * (regions - 1)) * nb,
                       0.0)
        nb_m = nb[seg_of]
        multi_m = multi[seg_of]
        busy = np.where(multi_m, (2 * nb_m) / accbw, 0.0)
        bytes_m = np.where(multi_m, 2 * nb_m, 0.0)
        return BatchedCollectiveCost("tree", gids, n_g, time, wire, wan,
                                     dev, seg_of, busy, bytes_m)

    if algorithm == "hierarchical":
        return _batched_hierarchical(fleet, gids, seg_start, n_g, seg_of,
                                     dev, accbw, accd, rid, wdm, wan_bw,
                                     nb)
    return _batched_gossip(gids, seg_start, n_g, seg_of, dev, accbw,
                           accd, rid, wdm, wan_bw, nb, rounds)


def _batched_hierarchical(fleet, gids, seg_start, n_g, seg_of, dev,
                          accbw, accd, rid, wdm, wan_bw, nb
                          ) -> BatchedCollectiveCost:
    G = gids.shape[0]
    # flat-ring pricing doubles as the R==1 fallback (scalar behaviour)
    ring_t, ring_wire, ring_wan, regions, newblk, ring_busy, ring_bytes \
        = _ring_segments(seg_start, n_g, seg_of, accbw, accd, rid, wdm,
                         wan_bw, nb / n_g, 2 * (n_g - 1))
    (block_start, blk_of, blocks_per, first_blk, blk_grp,
     slot) = _block_tables(seg_start, n_g, seg_of, newblk)
    B = block_start.shape[0]
    n_b = np.diff(np.append(block_start, accbw.shape[0]))
    # phase 1+3: one ring allreduce per region block (single region, so
    # _ring_segments with block segments prices it exactly)
    blk_newblk = np.ones(B, bool)  # each block is its own region run
    t_b, wire_b, _, _, _, busy1, bytes1 = _ring_segments(
        block_start, n_b, blk_of, accbw, accd, rid, wdm, wan_bw,
        nb[blk_grp] / n_b, 2 * (n_b - 1))
    t_intra = np.maximum(np.maximum.reduceat(t_b, first_blk), 0.0)
    rmax = int(blocks_per.max())
    garange = np.arange(G)
    dense_wire = np.zeros((G, rmax))
    dense_wire[blk_grp, slot] = wire_b
    wire_acc = np.zeros(G)
    for k in range(rmax):        # scalar left fold, sorted-region order
        wire_acc = wire_acc + dense_wire[:, k]
    # phase 2: ring over region leaders (first block member)
    dense_da = np.zeros((G, rmax))
    dense_wd = np.zeros((G, rmax))
    dense_da[blk_grp, slot] = accd[block_start]
    dense_wd[blk_grp, slot] = wdm[block_start]
    wan_delay = np.full(G, -np.inf)
    for k in range(rmax):
        nxtk = np.where(k + 1 < blocks_per, k + 1, 0)
        val = ((dense_da[:, k] + dense_wd[:, k])
               + dense_wd[garange, nxtk]) + dense_da[garange, nxtk]
        wan_delay = np.maximum(wan_delay,
                               np.where(k < blocks_per, val, -np.inf))
    chunk = nb / blocks_per
    steps = 2 * (blocks_per - 1)
    per_member_b = chunk[blk_grp] / n_b
    acc_min_b = np.minimum.reduceat(accbw, block_start)
    t_wan_b = np.maximum(chunk[blk_grp] / wan_bw,
                         per_member_b / acc_min_b)
    t_wan = np.maximum(np.maximum.reduceat(t_wan_b, first_blk), 0.0)
    t_inter = steps * (t_wan + wan_delay)
    wan = (steps * chunk) * blocks_per
    per_member_m = per_member_b[blk_of]
    steps_m = steps[seg_of]
    busy = busy1 + (steps_m * per_member_m) / accbw
    bytes_m = bytes1 + steps_m * per_member_m
    multi = regions > 1
    multi_m = multi[seg_of]
    return BatchedCollectiveCost(
        "hierarchical", gids, n_g,
        np.where(multi, t_intra + t_inter, ring_t),
        np.where(multi, wire_acc + wan, ring_wire),
        np.where(multi, wan, ring_wan),
        dev, seg_of,
        np.where(multi_m, busy, ring_busy),
        np.where(multi_m, bytes_m, ring_bytes))


def _batched_gossip(gids, seg_start, n_g, seg_of, dev, accbw, accd, rid,
                    wdm, wan_bw, nb, rounds) -> BatchedCollectiveCost:
    G = gids.shape[0]
    bmin = np.minimum.reduceat(accbw, seg_start)
    # distinct regions per group (members NOT region-sorted here)
    nreg = np.zeros(G, np.int64)
    delay = np.zeros(G)
    for s in range(G):            # O(n_g²) pairwise, like the scalar
        a = seg_start[s]
        b = a + n_g[s]
        r = rid[a:b]
        nreg[s] = np.unique(r).shape[0]
        if n_g[s] <= 1:
            continue
        da = accd[a:b]
        w = wdm[a:b]
        x = da + w
        v = np.where(r[:, None] != r[None, :],
                     (x[:, None] + w[None, :]) + da[None, :],
                     da[:, None] + da[None, :])
        iu = np.triu_indices(int(n_g[s]), 1)
        delay[s] = np.maximum(v[iu].max(), 0.0)
    bw = np.where(nreg > 1, np.minimum(bmin, wan_bw), bmin)
    nrounds = np.ceil(np.log2(n_g)).astype(np.int64) if rounds is None \
        else np.full(G, int(rounds), np.int64)
    multi = n_g > 1
    time = np.where(multi, nrounds * (nb / bw + delay), 0.0)
    wire = np.where(multi, (nrounds * n_g) * nb, 0.0)
    wan = np.where(multi & (nreg > 1), wire * (1.0 - 1.0 / nreg), 0.0)
    nb_m = nb[seg_of]
    rounds_m = nrounds[seg_of]
    multi_m = multi[seg_of]
    busy = np.where(multi_m, (rounds_m * nb_m) / accbw, 0.0)
    bytes_m = np.where(multi_m, rounds_m * nb_m, 0.0)
    return BatchedCollectiveCost("gossip", gids, n_g, time, wire, wan,
                                 dev, seg_of, busy, bytes_m)


def batched_sync_cost(fleet, member_device, member_group,
                      num_elements, *, algorithm: str = "ring",
                      compress=None, dtype_bytes: int = 4,
                      sync_interval: int = 1) -> BatchedCollectiveCost:
    """Batched :func:`sync_cost`: compression + local-update amortization
    over every group at once.  ``num_elements`` is a scalar or per-group
    array aligned with the sorted unique group labels."""
    ne = np.atleast_1d(np.asarray(num_elements))
    nbytes = np.array([wire_bytes_count(int(x), compress,
                                        dtype_bytes=dtype_bytes)
                       for x in ne], dtype=np.float64)
    if nbytes.shape[0] == 1:
        nbytes = float(nbytes[0])
    c = batched_collective_cost(fleet, member_device, member_group,
                                nbytes, algorithm)
    k = max(1, sync_interval)
    if k == 1:
        return c
    return BatchedCollectiveCost(
        c.algorithm, c.group_ids, c.participants, c.time_s / k,
        c.wire_bytes / k, c.wan_bytes / k, c.member_device,
        c.member_group, c.busy_s / k, c.bytes_dev / k)


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
