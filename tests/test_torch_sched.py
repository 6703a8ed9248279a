"""The port's scheduler against the JAX package's: thermal steps, carbon
rates and greedy selection, the fault-strategy frontier priced from a
placement, and the discrete-event ``Orchestrator`` run for run.

The scheduler is numpy and standard-library code in both packages, so the
bar is exact: every ``SimResult`` field equal (its per-step ``trace``, the
fault counts and the health summary included), and the events the run
emits on the tracer's ``fleet`` track equal to the JAX run's.  The fleets
and step counts are those of ``tests/test_orchestration.py``,
``tests/test_faults.py``, ``tests/test_elastic.py`` and
``tests/test_health.py``."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.opt import opt_config as j_opt  # noqa: E402
from repro.core.energy import devices as JD  # noqa: E402
from repro.core.faultinject import FaultPlan as JPlan  # noqa: E402
from repro.core.net import NetParams as JNet  # noqa: E402
from repro.core.net import Topology as JTopo  # noqa: E402
from repro.core.placement import search_placement as j_search  # noqa: E402
from repro.core.sched import carbon_aware as JC  # noqa: E402
from repro.core.sched import faults as JF  # noqa: E402
from repro.core.sched import orchestrator as JO  # noqa: E402
from repro.core.sched import thermal as JT  # noqa: E402
from repro.obs import HealthMonitor as JHM  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JReg  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.obs.trace import set_tracer as j_set_tracer  # noqa: E402
from repro_torch.configs.opt import opt_config as t_opt  # noqa: E402
from repro_torch.core.energy import devices as TD  # noqa: E402
from repro_torch.core.faultinject import FaultPlan as TPlan  # noqa: E402
from repro_torch.core.net import NetParams as TNet  # noqa: E402
from repro_torch.core.net import Topology as TTopo  # noqa: E402
from repro_torch.core.placement import search_placement as t_search  # noqa: E402,E501
from repro_torch.core.sched import carbon_aware as TC  # noqa: E402
from repro_torch.core.sched import faults as TF  # noqa: E402
from repro_torch.core.sched import orchestrator as TO  # noqa: E402
from repro_torch.core.sched import thermal as TT  # noqa: E402
from repro_torch.obs import HealthMonitor as THM  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry as TReg  # noqa: E402
from repro_torch.obs.trace import Tracer as TTracer  # noqa: E402
from repro_torch.obs.trace import set_tracer as t_set_tracer  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

TEN = {"laptop-m2pro": 4, "smartphone-sd888": 6}


def _cfgs(name="opt-125m"):
    j, t = j_opt(name), t_opt(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


# --------------------------------------------------------------------------- #
# thermal model, carbon rates, selection
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["PHONE_THERMALS", "LAPTOP_THERMALS"])
def test_thermal_steps_and_sustained_perf(kind):
    jp, tp = getattr(JT, kind), getattr(TT, kind)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    js, ts = JT.ThermalState(jp), TT.ThermalState(tp)
    rng = np.random.RandomState(0)
    for _ in range(900):
        power, dt = float(rng.uniform(0, 40)), float(rng.uniform(0.1, 30))
        assert ts.step(power, dt) == js.step(power, dt)
        assert ts.temp_c == js.temp_c
    for w in (1.0, 5.0, 15.0, 35.0):
        assert TT.sustained_perf(tp, w) == JT.sustained_perf(jp, w)


def _pair_fleets(counts, regions, seed):
    jf = JO.make_fleet(counts, regions=regions, seed=seed)
    tf = TO.make_fleet(counts, regions=regions, seed=seed)
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    return jf, tf


def test_carbon_rate_selection_and_fleet_rate():
    jf, tf = _pair_fleets({"laptop-m2pro": 8, "smartphone-sd888": 16,
                           "cloud-a5000": 2},
                          ("nordics", "europe", "india", "east_asia"), 3)
    # the device's own thermals, and a wear surcharge
    jf[0].wear_surcharge = tf[0].wear_surcharge = 0.25
    jf[1].thermal = JT.PHONE_THERMALS
    tf[1].thermal = TT.PHONE_THERMALS
    jcache, tcache = {}, {}
    for hour in (0.0, 12.0, 17.25):
        for a, b in zip(jf, tf):
            assert TC.carbon_rate(b, hour, tcache) \
                == JC.carbon_rate(a, hour, jcache)
        for target in (0.0, 2e13, 1e20):
            for charging in (True, False):
                js = JC.select_fleet(jf, target_flops=target, hour_utc=hour,
                                     require_charging=charging)
                ts = TC.select_fleet(tf, target_flops=target,
                                     hour_utc=hour,
                                     require_charging=charging)
                assert [dataclasses.asdict(s) for s in ts] \
                    == [dataclasses.asdict(s) for s in js]
                assert TC.fleet_carbon_rate(ts) == JC.fleet_carbon_rate(js)
    assert sorted(tcache) == sorted(jcache)
    assert TC.fleet_carbon_rate([]) == JC.fleet_carbon_rate([]) == 0.0


# --------------------------------------------------------------------------- #
# fault strategies
# --------------------------------------------------------------------------- #

def _views(outcomes):
    return [dataclasses.asdict(o) for o in outcomes]


@pytest.mark.parametrize("lam,n,step,elastic", [
    (0.05, 10, 30.0, None), (0.5, 64, 5.0, 12.0), (2.0, 4, 120.0, 1.0),
    (0.0, 8, 10.0, 3.0)])
def test_pareto_frontier(lam, n, step, elastic):
    kw = dict(lambda_per_device_hour=lam, num_devices=n, step_time_s=step,
              ckpt_write_s=20.0, ckpt_restore_s=90.0,
              stage_recompute_s=300.0, elastic_restore_s=elastic)
    jm, tm = JF.FaultModel(**kw), TF.FaultModel(**kw)
    for iv in ((10, 50, 100, 500), (1, 7, 1000)):
        assert _views(TF.pareto_frontier(tm, iv)) \
            == _views(JF.pareto_frontier(jm, iv))
    assert _views([TF.replication_outcome(tm, 3), TF.recompute_outcome(tm),
                   TF.checkpoint_outcome(tm, 25)]) \
        == _views([JF.replication_outcome(jm, 3), JF.recompute_outcome(jm),
                   JF.checkpoint_outcome(jm, 25)])


def _two_region(n=8):
    kinds = [("laptop-m2pro", "smartphone-sd888")[(i // 2) % 2]
             for i in range(n)]
    regions = [("europe", "north_america")[i % 2] for i in range(n)]
    jf = [JC.FleetDevice(spec=JD.CATALOG[k], region=r, device_id=i)
          for i, (k, r) in enumerate(zip(kinds, regions))]
    tf = [TC.FleetDevice(spec=TD.CATALOG[k], region=r, device_id=i)
          for i, (k, r) in enumerate(zip(kinds, regions))]
    return jf, tf


@pytest.mark.parametrize("replication", [0, 1, 2])
def test_priced_fault_model(replication):
    jc, tc = _cfgs()
    jf, tf = _two_region()
    kw = dict(nodes=[str(d.device_id) for d in jf], data_parallel=2,
              batch=8, seq_len=64, microbatches=2,
              collective="hierarchical")
    jp = j_search(jc, [d.spec for d in jf], topology=JTopo.from_fleet(
        jf, params=JNet(wan_bw_Bps=5e6)), **kw)
    tp = t_search(tc, [d.spec for d in tf], topology=TTopo.from_fleet(
        tf, params=TNet(wan_bw_Bps=5e6)), **kw)
    fk = dict(lambda_per_device_hour=0.5, step_time_s=30.0,
              stage_recompute_s=600.0, replication=replication)
    jm = JF.priced_fault_model(jc, jp, **fk)
    tm = TF.priced_fault_model(tc, tp, **fk)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert _views(TF.pareto_frontier(tm)) == _views(JF.pareto_frontier(jm))


# --------------------------------------------------------------------------- #
# the orchestrator, run for run
# --------------------------------------------------------------------------- #

def _run_both(counts, regions, fleet_seed, sim_kw, plan_kw=None,
              health=False, arch="opt-125m"):
    """Run the JAX and the port Orchestrator on the same fleet and config,
    each under a fresh tracer; return (JAX result, port result, JAX
    fleet events, port fleet events, JAX monitor, port monitor)."""
    jc, tc = _cfgs(arch)
    jf, tf = _pair_fleets(counts, regions, fleet_seed)
    jsim = JO.SimConfig(**sim_kw, fault_plan=None if plan_kw is None
                        else JPlan(**plan_kw))
    tsim = TO.SimConfig(**sim_kw, fault_plan=None if plan_kw is None
                        else TPlan(**plan_kw))
    jhm = JHM(registry=JReg()) if health else None
    thm = THM(registry=TReg()) if health else None
    jtr, ttr = JTracer(enabled=True), TTracer(enabled=True)
    jold, told = j_set_tracer(jtr), t_set_tracer(ttr)
    try:
        jr = JO.Orchestrator(jc, jf, jsim, health=jhm).run()
        tr = TO.Orchestrator(tc, tf, tsim, health=thm).run()
    finally:
        j_set_tracer(jold)
        t_set_tracer(told)
    return jr, tr, _fleet_events(jtr), _fleet_events(ttr), jhm, thm


def _fleet_events(tracer):
    """The events of a run that carry the simulated clock: the ``fleet``
    track's, the ``sched`` category's and the ``fleet.*`` counters
    (the wall-clock ``ts`` of anything else would differ run to run)."""
    out = []
    for e in tracer.events:
        if e.get("cat") == "sched" or e.get("track") == "fleet" \
                or str(e.get("name", "")).startswith("fleet."):
            out.append(e)
    return out


def _same(jr, tr):
    assert type(tr).__name__ == type(jr).__name__
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)


CASES = {
    # tests/test_orchestration.py: plain run, and carbon-aware admission
    "plain": (TEN, ("europe",), 2, dict(total_steps=40, seed=5), None,
              False),
    "carbon-aware": ({"laptop-m2pro": 8, "smartphone-sd888": 16},
                     ("nordics", "europe", "india"), 3,
                     dict(total_steps=40, seed=7,
                          carbon_threshold_g_per_gflop=1.1e-4), None, False),
    # tests/test_faults.py: crashes, stragglers, flaps and corruption
    "fault-plan": (TEN, ("europe",), 2,
                   dict(total_steps=60, seed=5, checkpoint_interval=20),
                   dict(seed=0, straggler_frac=0.3, crash_prob=0.02,
                        link_flap_prob=0.1, corrupt_prob=0.3), False),
    # tests/test_elastic.py: two regions, naive and elastic restores
    "naive-restore": ({"laptop-m2pro": 3, "smartphone-sd888": 4},
                      ("europe", "north_america"), 2,
                      dict(total_steps=60, seed=5, checkpoint_interval=15,
                           naive_restore=True, ckpt_replication=2), None,
                      False),
    # tests/test_health.py: a monitor evicts the detected straggler
    "health": ({"laptop-m2pro": 6, "smartphone-sd888": 2},
               ("europe", "north_america"), 2,
               dict(total_steps=60, seed=5, checkpoint_interval=20),
               dict(seed=7, straggler_frac=0.25, link_flap_prob=0.05), True),
    "long": (TEN, ("nordics", "india"), 4,
             dict(total_steps=120, seed=11, checkpoint_interval=30),
             dict(seed=2, straggler_frac=0.2, crash_prob=0.03,
                  corrupt_prob=0.2), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_orchestrator_run_equals_jax(case):
    counts, regions, fleet_seed, sim_kw, plan_kw, health = CASES[case]
    jr, tr, je, te, jhm, thm = _run_both(counts, regions, fleet_seed,
                                         sim_kw, plan_kw, health)
    _same(jr, tr)
    assert jr.steps_done == sim_kw["total_steps"]
    assert je and te == je
    if health:
        assert thm.stragglers() == jhm.stragglers()
        assert thm.summary() == jhm.summary()
    if case == "fault-plan":
        # the JAX test's seed exercises every path: crashes and rejoins,
        # corrupted copies healed
        assert tr.crashes >= 1 and tr.corrupted_shard_copies >= 1
        assert tr.fault_counts.get("heal", 0) >= 1
    if case == "health":
        assert tr.health_evictions >= 1 and thm.stragglers() == {"7"}
    if case == "carbon-aware":
        assert tr.carbon_kg > 0


def test_orchestrator_opt_1_3b_with_placement_churn():
    """opt-1.3b priced (the model the card trains): replans through
    ``search_placement`` and DT-FM every churn."""
    jr, tr, je, te, _, _ = _run_both(
        {"laptop-m2pro": 4, "smartphone-sd888": 8},
        ("nordics", "europe", "india"), 3, dict(total_steps=40, seed=7),
        None, False, arch="opt-1.3b")
    _same(jr, tr)
    assert tr.topology_rebuilds >= 1 and te == je


def test_orchestrator_property_over_seeds():
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hyp.given(fleet_seed=st.integers(0, 1000), sim_seed=st.integers(0, 1000),
               plan_seed=st.integers(0, 1000))
    @hyp.settings(max_examples=3, deadline=None)
    def prop(fleet_seed, sim_seed, plan_seed):
        jr, tr, je, te, _, _ = _run_both(
            TEN, ("europe", "north_america"), fleet_seed,
            dict(total_steps=20, seed=sim_seed, checkpoint_interval=10),
            dict(seed=plan_seed, straggler_frac=0.3, crash_prob=0.05,
                 link_flap_prob=0.1, corrupt_prob=0.2), False)
        _same(jr, tr)
        assert te == je

    prop()
