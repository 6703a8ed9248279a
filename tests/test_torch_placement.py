"""The port's placement search and DT-FM pricing against the JAX
package's: the same fleets give equal specs (boundaries, canonical keys,
strategies, regions, search statistics) and equal plans (step time, WAN
and wire bytes, energy).  The port's fleet is built from its own
``DeviceSpec`` catalog with a small local record; the JAX side uses the
scheduler's ``FleetDevice``."""

import dataclasses
from collections import namedtuple

import pytest

pytest.importorskip("torch")

from repro.configs.opt import opt_config as j_opt  # noqa: E402
from repro.core.energy import devices as JD  # noqa: E402
from repro.core.net import NetParams as JNet  # noqa: E402
from repro.core.net import Topology as JTopo  # noqa: E402
from repro.core.placement import search as JPS  # noqa: E402
from repro.core.placement.spec import PlacementSpec as JSpec  # noqa: E402
from repro.core.planner import dtfm as JP  # noqa: E402
from repro.core.sched.carbon_aware import FleetDevice  # noqa: E402
from repro.optim.compress import CompressConfig as JComp  # noqa: E402
from repro_torch.configs.opt import opt_config as t_opt  # noqa: E402
from repro_torch.core.energy import devices as TD  # noqa: E402
from repro_torch.core.net import NetParams as TNet  # noqa: E402
from repro_torch.core.net import Topology as TTopo  # noqa: E402
from repro_torch.core.placement import PlacementSpec as TSpec  # noqa: E402
from repro_torch.core.placement import search as TPS  # noqa: E402
from repro_torch.core.planner import dtfm as TP  # noqa: E402
from repro_torch.optim.compress import CompressConfig as TComp  # noqa: E402

Edge = namedtuple("Edge", "device_id region spec")

SPECS = ["laptop-m2pro", "smartphone-sd888", "cloud-a5000"]


def _cfgs(L=6):
    j = j_opt("opt-125m").reduced(num_layers=L, d_model=64, vocab_size=64)
    t = t_opt("opt-125m").reduced(num_layers=L, d_model=64, vocab_size=64)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _fleets(kinds, regions, wan=None):
    """(JAX devices, nodes, topology), (port devices, nodes, topology)."""
    jf = [FleetDevice(spec=JD.CATALOG[k], region=r, device_id=i)
          for i, (k, r) in enumerate(zip(kinds, regions))]
    tf = [Edge(i, r, TD.CATALOG[k])
          for i, (k, r) in enumerate(zip(kinds, regions))]
    jt = JTopo.from_fleet(jf, **({} if wan is None
                                 else {"params": JNet(wan_bw_Bps=wan)}))
    tt = TTopo.from_fleet(tf, **({} if wan is None
                                 else {"params": TNet(wan_bw_Bps=wan)}))
    nodes = [str(i) for i in range(len(kinds))]
    return ([d.spec for d in jf], nodes, jt), ([d.spec for d in tf], nodes,
                                               tt)


def two_region(n=8):
    """tests/test_elastic.py's fleet: laptops and phones alternating in
    pairs, regions alternating one by one, a 5 MB/s WAN."""
    kinds = [SPECS[(i // 2) % 2] for i in range(n)]
    regions = [("europe", "north_america")[i % 2] for i in range(n)]
    return _fleets(kinds, regions, wan=5e6)


def _spec_view(spec):
    stats = {k: v for k, v in spec.search_stats.items()
             if k != "search_wall_s"}
    return (spec.model, spec.num_layers, spec.boundaries, spec.layer_counts,
            spec.canonical_key(), spec.strategy, spec.idle_nodes,
            spec.dp_groups(), spec.region_groups(),
            [spec.replica_regions(r) for r in range(spec.data_parallel)],
            spec.cross_region_edges(), stats,
            [[(s.device.name, s.node, s.layers) for s in p]
             for p in spec.pipelines], spec.describe())


def _plan_view(p):
    return (p.model, p.data_parallel, p.microbatches, p.step_time_s,
            p.bubble_fraction, p.comm_s_per_step, p.energy_wh_per_step,
            p.boundary_s_per_step, p.dp_sync_s_per_step,
            p.wire_bytes_per_step, p.comm_busy_s, p.wan_bytes_per_step,
            p.comm_energy_wh_per_step,
            [(s.device.name, s.layers, s.flops_per_microbatch,
              s.time_per_microbatch_s, s.node) for s in p.stages])


@pytest.mark.parametrize("n,weights", [
    (6, [1.0, 2.0, 3.0]), (5, [1.0] * 8), (24, [3.5, 1.0, 1.0, 2.0]),
    (7, [0.1, 10.0]), (1, [1.0, 1.0])])
def test_balanced_boundaries_equal_jax(n, weights):
    assert TPS.balanced_boundaries(n, weights) == \
        JPS.balanced_boundaries(n, weights)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_search_and_round_robin_equal_jax_on_the_two_region_fleet(dp):
    jc, tc = _cfgs()
    (jd, nodes, jt), (td, _, tt) = two_region()
    kw = dict(data_parallel=dp, batch=8, seq_len=64, microbatches=2,
              collective="hierarchical")
    js = JPS.search_placement(jc, jd, topology=jt, nodes=nodes, **kw)
    ts = TPS.search_placement(tc, td, topology=tt, nodes=nodes, **kw)
    assert isinstance(ts, TSpec) and isinstance(js, JSpec)
    assert _spec_view(ts) == _spec_view(js)
    assert ts.strategy.startswith("topology_aware(")
    assert ts.search_stats["candidates_pruned"] >= 0
    jr = JPS.round_robin_placement(jc, jd, topology=jt, nodes=nodes,
                                   data_parallel=dp)
    tr = TPS.round_robin_placement(tc, td, topology=tt, nodes=nodes,
                                   data_parallel=dp)
    assert _spec_view(tr) == _spec_view(jr)
    pk = dict(batch=8, seq_len=64, microbatches=2, collective="hierarchical")
    assert _plan_view(TP.plan_placement(tc, ts, **pk)) == \
        _plan_view(JP.plan_placement(jc, js, **pk))
    assert _plan_view(TP.plan_placement(tc, tr, **pk)) == \
        _plan_view(JP.plan_placement(jc, jr, **pk))
    # the search never prices worse than the round-robin baseline
    assert TP.plan_placement(tc, ts, **pk).step_time_s <= \
        TP.plan_placement(tc, tr, **pk).step_time_s


@pytest.mark.parametrize("fleet", [
    (["laptop-m2pro", "smartphone-sd888", "cloud-a5000", "laptop-m2pro",
      "smartphone-sd888"], ["europe", "north_america", "east_asia", "india",
                            "nordics"], 2),
    (["smartphone-sd888"] * 3 + ["laptop-m2pro"] * 4,
     ["europe"] * 4 + ["north_america"] * 3, 3),
    (["cloud-a5000", "laptop-m2pro", "smartphone-sd888"],
     ["europe", "europe", "north_america"], 1)],
    ids=["five-regions", "uneven", "three"])
@pytest.mark.parametrize("compress", [None, "int8"])
def test_search_equals_jax_on_other_fleets(fleet, compress):
    kinds, regions, dp = fleet
    jc, tc = _cfgs(L=12)
    (jd, nodes, jt), (td, _, tt) = _fleets(kinds, regions)
    kw = dict(data_parallel=dp, batch=12, seq_len=128, microbatches=4,
              collective="ring", sync_interval=4,
              train=True)
    js = JPS.search_placement(jc, jd, topology=jt, nodes=nodes,
                              compress=compress and JComp("int8"), **kw)
    ts = TPS.search_placement(tc, td, topology=tt, nodes=nodes,
                              compress=compress and TComp("int8"), **kw)
    assert _spec_view(ts) == _spec_view(js)


@pytest.mark.parametrize("train", [True, False])
def test_plan_placement_agrees_with_legacy_plan(train):
    """``plan`` is a placement round trip in both packages: pricing an
    ordered placement directly gives the identical plan, equal to the JAX
    package's."""
    jcfg, tcfg = j_opt("opt-125m"), t_opt("opt-125m")
    jd = [JD.LAPTOP_M2PRO, JD.SMARTPHONE_SD888, JD.CLOUD_A5000]
    td = [TD.LAPTOP_M2PRO, TD.SMARTPHONE_SD888, TD.CLOUD_A5000]
    kw = dict(batch=16, seq_len=256, microbatches=4, train=train)
    a = TP.plan(tcfg, td, **kw)
    b = TP.plan_placement(tcfg, TPS.ordered_placement(tcfg, td), **kw)
    assert _plan_view(a)[:-1] == _plan_view(b)[:-1]
    assert [s.layers for s in a.stages] == [s.layers for s in b.stages]
    assert _plan_view(a) == _plan_view(JP.plan(jcfg, jd, **kw))
    # data-parallel clones spread over regions (the legacy dp_regions)
    kw2 = dict(kw, data_parallel=2)
    ta = TP.plan(tcfg, td, dp_regions=["europe", "north_america"], **kw2)
    ja = JP.plan(jcfg, jd, dp_regions=["europe", "north_america"], **kw2)
    assert _plan_view(ta) == _plan_view(ja)
    assert (ta.wan_bytes_per_step > 0) == train   # sync crosses regions
    assert TP.min_bw_comm_s(tcfg, td, batch=16, seq_len=256) == \
        JP.min_bw_comm_s(jcfg, jd, batch=16, seq_len=256)
    assert TP.table2_energy(tcfg, TD.SMARTPHONE_SD888, 4) == \
        JP.table2_energy(jcfg, JD.SMARTPHONE_SD888, 4)


def test_placement_errors_match_jax():
    jc, tc = _cfgs()
    (jd, nodes, jt), (td, _, tt) = two_region(4)
    for fn, args, kw in (
            ("search_placement", (), dict(nodes=nodes[:3], batch=8,
                                          seq_len=8)),
            ("search_placement", (), dict(nodes=nodes, data_parallel=5,
                                          batch=8, seq_len=8)),
            ("round_robin_placement", (), dict(nodes=nodes,
                                               data_parallel=5))):
        with pytest.raises(ValueError) as je:
            getattr(JPS, fn)(jc, jd, *args, topology=jt, **kw)
        with pytest.raises(ValueError) as te:
            getattr(TPS, fn)(tc, td, *args, topology=tt, **kw)
        assert str(je.value) == str(te.value)
    spec = TPS.search_placement(tc, td, topology=tt, nodes=nodes,
                                data_parallel=2, batch=8, seq_len=8)
    with pytest.raises(ValueError, match="exceeds batch"):
        TP.plan_placement(tc, spec, batch=1, seq_len=8)
    bad = dataclasses.replace(spec, pipelines=[spec.pipelines[0],
                                               spec.pipelines[0]])
    with pytest.raises(ValueError, match="more than one stage"):
        bad.validate()
    with pytest.raises(ValueError, match="nodes="):
        TP.plan(tc, td, batch=8, seq_len=8, topology=tt)
