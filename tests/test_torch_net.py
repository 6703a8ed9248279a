"""The wide-area network model: the port's copy of the topology and the
scalar collective cost models against the JAX package's, algorithm by
algorithm, on one- and two-region fleets, plus ``sync_cost`` with int8
compression and local-update amortization.  Both run the same float
arithmetic in the same order, so the bar is 1e-12 relative."""

from dataclasses import dataclass

import pytest

pytest.importorskip("torch")

from repro.core.energy import devices as JD  # noqa: E402
from repro.core.net import NetParams as JNet  # noqa: E402
from repro.core.net import Topology as JTopo  # noqa: E402
from repro.core.net import collectives as JCol  # noqa: E402
from repro.core.sched.carbon_aware import FleetDevice  # noqa: E402
from repro.optim.compress import CompressConfig as JCC  # noqa: E402
from repro_torch.core.energy import devices as TD  # noqa: E402
from repro_torch.core.net import NetParams as TNet  # noqa: E402
from repro_torch.core.net import Topology as TTopo  # noqa: E402
from repro_torch.core.net import collectives as TCol  # noqa: E402
from repro_torch.optim.compress import CompressConfig as TCC  # noqa: E402

REL = 1e-12

# (device names, regions, WAN bandwidth): one region; the two-region edge
# fleet of examples/diloco_edge.py; a mixed three-region fleet
FLEETS = [
    (["laptop-m2pro"] * 3, None, None),
    (["laptop-m2pro"] * 2, ["europe", "north_america"], 4e6),
    (["smartphone-sd888", "laptop-m2pro", "cloud-a5000", "cloud-h100",
      "smartphone-sd888"], ["europe", "north_america", "east_asia"], None),
]
FLEET_IDS = ["one-region", "diloco-edge", "mixed-3-regions"]


@dataclass
class _Dev:
    """A fleet device as the port's duck-typed ``from_fleet`` reads it."""
    device_id: int
    region: str
    spec: object


def topologies(names, regions, wan):
    jp = JNet() if wan is None else JNet(wan_bw_Bps=wan)
    tp = TNet() if wan is None else TNet(wan_bw_Bps=wan)
    js = [JD.get_device(n) for n in names]
    ts = [TD.get_device(n) for n in names]
    return (JTopo.from_specs(js, regions=regions, params=jp),
            TTopo.from_specs(ts, regions=regions, params=tp))


def assert_cost_equal(t, j):
    assert (t.algorithm, t.participants) == (j.algorithm, j.participants)
    for f in ("time_s", "wire_bytes", "wan_bytes"):
        assert getattr(t, f) == pytest.approx(getattr(j, f), rel=REL), f
    for f in ("per_device_busy_s", "per_device_bytes"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=REL, abs=0), (f, k)


@pytest.mark.parametrize("algorithm", sorted(JCol.COLLECTIVES))
@pytest.mark.parametrize("fleet", FLEETS, ids=FLEET_IDS)
def test_collective_costs_equal_jax(fleet, algorithm):
    jt, tt = topologies(*fleet)
    assert tt.devices == jt.devices and tt.regions == jt.regions
    for group in (tt.devices, tt.devices[:2], tt.devices[:1]):
        for nbytes in (1.0, 5.3e6, 2.6e9):
            assert_cost_equal(
                TCol.collective_cost(tt, group, nbytes, algorithm),
                JCol.collective_cost(jt, group, nbytes, algorithm))


@pytest.mark.parametrize("algorithm", ["ring", "hierarchical", "tree"])
@pytest.mark.parametrize("fleet", FLEETS, ids=FLEET_IDS)
def test_sync_cost_with_int8_and_interval_equals_jax(fleet, algorithm):
    jt, tt = topologies(*fleet)
    n = 1_315_524_608                      # opt-1.3b's parameters
    for comp, jcomp in ((None, None),
                        (TCC(method="int8"), JCC(method="int8")),
                        (TCC(method="topk", topk_fraction=0.01),
                         JCC(method="topk", topk_fraction=0.01))):
        for k in (1, 4):
            assert_cost_equal(
                TCol.sync_cost(tt, tt.devices, n, algorithm=algorithm,
                               compress=comp, sync_interval=k),
                JCol.sync_cost(jt, jt.devices, n, algorithm=algorithm,
                               compress=jcomp, sync_interval=k))


def test_topology_paths_and_from_fleet_equal_jax():
    regions = ["europe", "north_america", "europe"]
    jfleet = [FleetDevice(spec=JD.LAPTOP_M2PRO, region=r, device_id=i)
              for i, r in enumerate(regions)]
    tfleet = [_Dev(i, r, TD.LAPTOP_M2PRO) for i, r in enumerate(regions)]
    jt = JTopo.from_fleet(jfleet, params=JNet(wan_bw_Bps=4e6))
    tt = TTopo.from_fleet(tfleet, params=TNet(wan_bw_Bps=4e6))
    assert tt.devices == jt.devices == ["0", "1", "2"]
    assert tt.regions == jt.regions
    assert tt.devices_in_region("europe") == jt.devices_in_region("europe")
    for a in tt.devices:
        for b in tt.devices:
            assert tt.p2p_time_s(1e6, a, b) == jt.p2p_time_s(1e6, a, b)
            if a != b:
                assert tt.path_bw_Bps(a, b) == jt.path_bw_Bps(a, b)
    assert tt.group_bottleneck_bw_Bps(tt.devices) == \
        jt.group_bottleneck_bw_Bps(jt.devices)
    assert tt.group_max_delay_s(tt.devices) == \
        jt.group_max_delay_s(jt.devices)
    # moving a device between regions keeps the region index right
    tt.add_device("1", "europe", TD.LAPTOP_M2PRO)
    jt.add_device("1", "europe", JD.LAPTOP_M2PRO)
    assert tt.regions == jt.regions == ["europe"]


def test_unknown_collective_raises():
    _, tt = topologies(*FLEETS[0])
    with pytest.raises(ValueError, match="unknown collective"):
        TCol.collective_cost(tt, tt.devices, 1.0, "butterfly")
