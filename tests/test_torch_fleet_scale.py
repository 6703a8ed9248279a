"""The port's fleet-scale control plane against its own scalar models and
against the JAX package's (the torch twin of ``tests/test_fleet_scale.py``).

Both packages run the same numpy code, so every float is held with ``==``
and every array with ``np.array_equal``:

* the batched collectives (all five algorithms, per-group totals and
  per-member busy / bytes) equal the port's scalar models and the JAX
  package's batched lanes;
* ``FleetArrays`` round-trips a topology, and ``from_fleet`` / ``take``
  give the JAX package's columns;
* ``price_fleet_grid`` equals the port's ``dtfm.plan_placement`` and the
  JAX package's grid pricing;
* ``search_placement_fleet`` equals the JAX search (``search_wall_s``,
  the wall clock, left out) and is never worse than round-robin;
* ``FleetSim``'s scalar and vectorized engines give bit-identical
  trajectories, equal to the JAX ``FleetSim``'s, in sync and async mode.

Sizes stay those of the JAX file."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as j_config  # noqa: E402
from repro.core.faultinject.plan import FaultPlan as JPlan  # noqa: E402
from repro.core.net import NetParams as JNet  # noqa: E402
from repro.core.net import collectives as JC  # noqa: E402
from repro.core.net import fleet_arrays as JA  # noqa: E402
from repro.core.placement import fleet as JPF  # noqa: E402
from repro.core.sched import carbon_aware as JCA  # noqa: E402
from repro.core.sched import fleet_sim as JS  # noqa: E402
from repro.optim.compress import CompressConfig as JComp  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core.energy import devices as TD  # noqa: E402
from repro_torch.core.faultinject.plan import FaultPlan as TPlan  # noqa: E402
from repro_torch.core.net import NetParams as TNet  # noqa: E402
from repro_torch.core.net import Topology as TTopo  # noqa: E402
from repro_torch.core.net import collectives as TC  # noqa: E402
from repro_torch.core.net import fleet_arrays as TA  # noqa: E402
from repro_torch.core.placement import fleet as TPF  # noqa: E402
from repro_torch.core.planner import dtfm as TP  # noqa: E402
from repro_torch.core.sched import carbon_aware as TCA  # noqa: E402
from repro_torch.core.sched import fleet_sim as TS  # noqa: E402
from repro_torch.optim.compress import CompressConfig as TComp  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

JCFG, TCFG = j_config("opt-125m"), t_config("opt-125m")
ALGORITHMS = ("ring", "tree", "hierarchical", "gossip", "allgather")
REGIONS = ("europe", "north_america", "east_asia", "nordics")
COLUMNS = ("node_names", "region_of", "regions", "acc_bw", "acc_delay",
           "eff_flops", "power_active_w", "power_idle_w", "power_comm_w",
           "carbon_kg_per_kwh", "wan_bw", "wan_delay", "spec_names",
           "name_rank")


def _same_columns(a, b):
    for c in COLUMNS:
        x, y = getattr(a, c), getattr(b, c)
        assert x.dtype == y.dtype and np.array_equal(x, y), c
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)


def _fleets(n, **kw):
    """(JAX fleet, port fleet), the same synthetic fleet from each."""
    p = kw.pop("wan", None)
    jf = JA.synthetic_fleet(n, params=None if p is None
                            else JNet(wan_bw_Bps=p), **kw)
    tf = TA.synthetic_fleet(n, params=None if p is None
                            else TNet(wan_bw_Bps=p), **kw)
    _same_columns(jf, tf)
    return jf, tf


def _random_fleets(rng, n_lo=6, n_hi=36):
    n = int(rng.randint(n_lo, n_hi))
    k = int(rng.randint(1, 5))
    return _fleets(n, regions=REGIONS[:k],
                   region_mix="shuffled" if rng.randint(2)
                   else "round_robin",
                   wan=float(rng.choice([5e6, 2e7, 1e8])),
                   seed=int(rng.randint(0, 1000)))


def _same_batched(a, b):
    assert a.algorithm == b.algorithm
    for c in ("group_ids", "participants", "time_s", "wire_bytes",
              "wan_bytes", "member_device", "member_group", "busy_s",
              "bytes_dev"):
        assert np.array_equal(getattr(a, c), getattr(b, c)), c


# --------------------------------------------------------------------------- #
# batched collectives
# --------------------------------------------------------------------------- #

def _exercise_collectives(seed):
    rng = np.random.RandomState(seed)
    jf, tf = _random_fleets(rng)
    topo = tf.to_topology()
    member_dev, member_grp, groups = [], [], []
    for g in range(int(rng.randint(1, 6))):
        size = int(rng.randint(1, min(12, tf.num_devices) + 1))
        rows = rng.choice(tf.num_devices, size=size, replace=False)
        groups.append([int(r) for r in rows])
        member_dev.extend(int(r) for r in rows)
        member_grp.extend([g] * size)
    dev, grp = np.asarray(member_dev), np.asarray(member_grp)
    nbytes = float(rng.choice([1e6, 5e7, 2e9]))
    for algo in ALGORITHMS:
        b = TC.batched_collective_cost(tf, dev, grp, nbytes, algorithm=algo)
        _same_batched(b, JC.batched_collective_cost(jf, dev, grp, nbytes,
                                                    algorithm=algo))
        for g, rows in enumerate(groups):
            nodes = [str(tf.node_names[r]) for r in rows]
            s = TC.collective_cost(topo, nodes, nbytes, algorithm=algo)
            i = b.group(g)
            assert b.time_s[i] == s.time_s, (algo, g)
            assert b.wire_bytes[i] == s.wire_bytes, (algo, g)
            assert b.wan_bytes[i] == s.wan_bytes, (algo, g)
            assert int(b.participants[i]) == s.participants
            sel = b.member_group == g
            for d, busy, byts in zip(b.member_device[sel], b.busy_s[sel],
                                     b.bytes_dev[sel]):
                name = str(tf.node_names[int(d)])
                assert busy == s.per_device_busy_s[name], (algo, g, name)
                assert byts == s.per_device_bytes[name], (algo, g, name)


@pytest.mark.parametrize("seed", range(5))
def test_batched_collectives_match_scalar_and_jax(seed):
    _exercise_collectives(seed)


def test_batched_collectives_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hyp.given(seed=st.integers(0, 2 ** 16))
    @hyp.settings(max_examples=8, deadline=None)
    def prop(seed):
        _exercise_collectives(seed)

    prop()


@pytest.mark.parametrize("compress", [None, "int8", "topk"])
def test_batched_sync_cost_matches_scalar_and_jax(compress):
    rng = np.random.RandomState(0)
    jf, tf = _random_fleets(rng, n_lo=12, n_hi=13)
    topo = tf.to_topology()
    dev = np.arange(12)
    grp = np.repeat(np.arange(3), 4)
    tcomp = None if compress is None else TComp(method=compress)
    jcomp = None if compress is None else JComp(method=compress)
    for k in (1, 4):
        for ne in (10_000_000, np.array([5_000, 70_000, 1_000_003])):
            kw = dict(algorithm="hierarchical", dtype_bytes=2,
                      sync_interval=k)
            b = TC.batched_sync_cost(tf, dev, grp, ne, compress=tcomp, **kw)
            _same_batched(b, JC.batched_sync_cost(jf, dev, grp, ne,
                                                  compress=jcomp, **kw))
            for g in range(3):
                nodes = [str(tf.node_names[r]) for r in dev[grp == g]]
                n_el = int(ne) if np.ndim(ne) == 0 else int(ne[g])
                s = TC.sync_cost(topo, nodes, n_el, compress=tcomp, **kw)
                i = b.group(g)
                assert b.time_s[i] == s.time_s
                assert b.wire_bytes[i] == s.wire_bytes
                assert b.wan_bytes[i] == s.wan_bytes


# --------------------------------------------------------------------------- #
# FleetArrays
# --------------------------------------------------------------------------- #

def test_fleet_arrays_topology_round_trip():
    jf, tf = _fleets(30, region_mix="shuffled", seed=9)
    back = TA.FleetArrays.from_topology(tf.to_topology())
    for c in ("node_names", "region_of", "eff_flops", "acc_bw", "wan_bw",
              "regions", "acc_delay", "wan_delay", "carbon_kg_per_kwh"):
        assert np.array_equal(getattr(tf, c), getattr(back, c)), c
    _same_columns(JA.FleetArrays.from_topology(jf.to_topology()), back)
    rows = np.array([29, 3, 3, 17, 0, 8])
    _same_columns(jf.take(rows), tf.take(rows))
    for i in range(tf.num_devices):
        assert dataclasses.asdict(TA._spec_for_row(tf, i)) \
            == dataclasses.asdict(JA._spec_for_row(jf, i))


def test_fleet_arrays_from_fleet_devices():
    from repro.core.energy import devices as JD
    kinds = ["laptop-m2pro", "smartphone-sd888", "cloud-a5000"]
    regions = ["india", "europe", "nordics", "europe", "mars"]
    jfl = [JCA.FleetDevice(spec=JD.CATALOG[kinds[i % 3]],
                           region=regions[i % 5], device_id=i)
           for i in range(11)]
    tfl = [TCA.FleetDevice(spec=TD.CATALOG[kinds[i % 3]],
                           region=regions[i % 5], device_id=i)
           for i in range(11)]
    tf = TA.FleetArrays.from_fleet(tfl, params=TNet(wan_bw_Bps=7e6))
    _same_columns(JA.FleetArrays.from_fleet(jfl, params=JNet(
        wan_bw_Bps=7e6)), tf)
    want = TA.FleetArrays.from_topology(TTopo.from_fleet(
        tfl, params=TNet(wan_bw_Bps=7e6)))
    for c in ("node_names", "region_of", "eff_flops", "acc_bw", "wan_bw"):
        assert np.array_equal(getattr(tf, c), getattr(want, c)), c


# --------------------------------------------------------------------------- #
# grid pricing and the fleet search
# --------------------------------------------------------------------------- #

def _plan_view(fp):
    return (fp.grid.tolist(), list(fp.boundaries), fp.idle.tolist(),
            fp.strategy, fp.step_time_s, fp.wan_bytes_per_step,
            fp.wire_bytes_per_step, fp.cross_region_edges)


def _exercise_pricing(seed):
    rng = np.random.RandomState(seed)
    jf, tf = _random_fleets(rng, n_lo=12, n_hi=28)
    dp = int(rng.choice([1, 2, 4]))
    S = int(rng.randint(2, 5))
    if dp * S > tf.num_devices:
        dp, S = 2, 2
    grid = rng.choice(tf.num_devices, size=dp * S,
                      replace=False).reshape(dp, S)
    algo = str(rng.choice(["ring", "hierarchical", "tree"]))
    k = int(rng.choice([1, 2]))
    kw = dict(batch=16, seq_len=128, microbatches=4, collective=algo,
              sync_interval=k)
    fp = TPF.price_fleet_grid(tf, TCFG, grid, **kw)
    assert _plan_view(fp) == _plan_view(JPF.price_fleet_grid(jf, JCFG,
                                                             grid, **kw))
    spec = fp.to_spec(TCFG)
    p = TP.plan_placement(TCFG, spec, **kw)
    assert fp.step_time_s == p.step_time_s
    assert fp.wan_bytes_per_step == p.wan_bytes_per_step
    assert fp.wire_bytes_per_step == p.wire_bytes_per_step
    assert fp.cross_region_edges == spec.cross_region_edges()


@pytest.mark.parametrize("seed", range(4))
def test_price_fleet_grid_matches_plan_placement_and_jax(seed):
    _exercise_pricing(seed)


def test_price_fleet_grid_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hyp.given(seed=st.integers(0, 2 ** 16))
    @hyp.settings(max_examples=6, deadline=None)
    def prop(seed):
        _exercise_pricing(seed)

    prop()


def _stats(fp):
    return {k: v for k, v in fp.search_stats.items()
            if k != "search_wall_s"}


@pytest.mark.parametrize("n,dp,mix,seed", [(64, 4, "shuffled", 2),
                                           (48, 2, "round_robin", 5),
                                           (90, 3, "shuffled", 11)])
def test_fleet_search_equals_jax_and_beats_round_robin(n, dp, mix, seed):
    jf, tf = _fleets(n, region_mix=mix, wan=5e6, seed=seed)
    kw = dict(data_parallel=dp, batch=16, seq_len=128, microbatches=4)
    best = TPF.search_placement_fleet(tf, TCFG, **kw)
    jbest = JPF.search_placement_fleet(jf, JCFG, **kw)
    assert _plan_view(best) == _plan_view(jbest)
    assert _stats(best) == _stats(jbest)
    assert "search_wall_s" in best.search_stats
    stats = best.search_stats
    assert best.step_time_s <= stats["round_robin_step_time_s"]
    assert stats["candidates_priced"] <= stats["candidates_total"]
    # the winner reprices identically through the scalar model
    spec = best.to_spec(TCFG)
    p = TP.plan_placement(TCFG, spec, batch=16, seq_len=128,
                          microbatches=4, collective="hierarchical")
    assert p.step_time_s == best.step_time_s
    assert p.wan_bytes_per_step == best.wan_bytes_per_step
    assert spec.search_stats == stats


# --------------------------------------------------------------------------- #
# FleetSim: scalar engine = vectorized engine = the JAX FleetSim
# --------------------------------------------------------------------------- #

def _sim_view(r):
    return (r.engine, r.mode, r.rounds, r.wall_time_s, r.step_times_s.tolist(),
            r.active_counts.tolist(), r.mean_active, r.crashes, r.flaps,
            r.region_busy_s)


def _exercise_sim(seed, n=200, rounds=8, mode=None):
    rng = np.random.RandomState(seed)
    pk = dict(seed=int(rng.randint(0, 100)), straggler_frac=0.15,
              crash_prob=0.02, rejoin_delay=(1, 4), link_flap_prob=0.1)
    ck = dict(rounds=rounds, seed=int(rng.randint(0, 100)),
              leave_prob=float(rng.uniform(0, 0.05)),
              join_prob=float(rng.uniform(0, 0.5)),
              mode=mode or ("async" if rng.randint(2) else "sync"),
              quorum=float(rng.uniform(0.5, 1.0)))
    jf, tf = _fleets(n, region_mix="shuffled", seed=int(rng.randint(0, 100)))
    sim = TS.FleetSim(tf, TS.FleetSimConfig(**ck, fault_plan=TPlan(**pk)))
    jsim = JS.FleetSim(jf, JS.FleetSimConfig(**ck, fault_plan=JPlan(**pk)))
    rv, rs = sim.run("vectorized"), sim.run("scalar")
    assert rv.trajectory_equal(rs)
    assert rv.region_busy_s == rs.region_busy_s
    assert rv.wall_time_s == rs.wall_time_s
    assert rv.rounds == rounds and (rv.active_counts > 0).all()
    for eng, r in (("vectorized", rv), ("scalar", rs)):
        assert _sim_view(r) == _sim_view(jsim.run(eng)), eng


@pytest.mark.parametrize("seed,mode", [(0, "sync"), (1, "async"),
                                       (2, None)])
def test_fleet_sim_engines_bit_identical_to_each_other_and_jax(seed, mode):
    _exercise_sim(seed, mode=mode)


def test_fleet_sim_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hyp.given(seed=st.integers(0, 2 ** 16), n=st.integers(20, 300))
    @hyp.settings(max_examples=4, deadline=None)
    def prop(seed, n):
        _exercise_sim(seed, n=n)

    prop()


def test_fleet_sim_async_quorum_cuts_straggler_tail_and_churn_sweep():
    pk = dict(seed=3, straggler_frac=0.2, straggler_slowdown=(4.0, 8.0))
    jf, tf = _fleets(500, seed=1)
    base = dict(rounds=10, seed=4)
    sync = TS.FleetSim(tf, TS.FleetSimConfig(
        mode="sync", fault_plan=TPlan(**pk), **base)).run()
    asyn = TS.FleetSim(tf, TS.FleetSimConfig(
        mode="async", quorum=0.75, fault_plan=TPlan(**pk), **base)).run()
    assert asyn.wall_time_s < sync.wall_time_s
    assert _sim_view(asyn) == _sim_view(JS.FleetSim(jf, JS.FleetSimConfig(
        mode="async", quorum=0.75, fault_plan=JPlan(**pk), **base)).run())
    kw = dict(rounds=6, seed=2, leave_prob=0.02, join_prob=0.3)
    for eng in ("vectorized", "scalar"):
        assert _sim_view(TS.churn_sweep(tf, TS.FleetSimConfig(
            fault_plan=TPlan(**pk), **kw), engine=eng)) \
            == _sim_view(JS.churn_sweep(jf, JS.FleetSimConfig(
                fault_plan=JPlan(**pk), **kw), engine=eng))
