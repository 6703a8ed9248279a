"""The edge fleet's elastic state and control loop in the port, against
the JAX package: layer-sliced checkpoints (``save_for_placement``) that
either package restores bit for bit, the 3 -> 2 -> 3 reshard, bit-rot
detection and healing from neighbour copies, the priced write / heal /
recovery costs, local SGD driven by a placement (per-region K, priced
per-slot sync, layer-sliced checkpoints) and by a health monitor (the
async quorum shrunk past detected stragglers), and the trainer's
``checkpoint_placement`` resume."""

import dataclasses
import functools
import shutil
from collections import namedtuple

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import elastic as JE  # noqa: E402
from repro.checkpoint import ckpt as JC  # noqa: E402
from repro.checkpoint.spec import CheckpointSpec as JCS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.energy import devices as JD  # noqa: E402
from repro.core.faultinject import FaultPlan as JPlan  # noqa: E402
from repro.core.faultinject import corrupt_file as j_corrupt  # noqa: E402
from repro.core.net import NetParams as JNet  # noqa: E402
from repro.core.net import Topology as JTopo  # noqa: E402
from repro.core.placement import search_placement as j_search  # noqa: E402
from repro.core.sched.carbon_aware import FleetDevice  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.obs import HealthMonitor as JHM  # noqa: E402
from repro.obs import MetricsRegistry as JReg  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import local_sgd as JL  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import elastic as TE  # noqa: E402
from repro_torch.checkpoint import ckpt as TC  # noqa: E402
from repro_torch.checkpoint.spec import CheckpointSpec as TCS  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core.energy import devices as TD  # noqa: E402
from repro_torch.core.faultinject import FaultPlan  # noqa: E402
from repro_torch.core.faultinject import corrupt_file  # noqa: E402
from repro_torch.core.net import NetParams, Topology  # noqa: E402
from repro_torch.core.placement import search_placement  # noqa: E402
from repro_torch.obs import HealthMonitor, MetricsRegistry  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import local_sgd as TL  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_checkpoint import assert_bitexact, port_like  # noqa: E402
from test_torch_helpers import bridged  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_train import train_configs  # noqa: E402

Edge = namedtuple("Edge", "device_id region spec")
L = 6                                    # checkpoint tests: 6 layers
JCFG, TCFG = train_configs("opt-125m", dict(num_layers=4, d_model=32,
                                            vocab_size=64), {})


# ------------------------------------------------------------------ fleets
def fleet(kinds, regions, wan=5e6):
    """The same fleet in both packages: (JAX topology, port topology,
    JAX specs, port specs, nodes)."""
    jf = [FleetDevice(spec=JD.CATALOG[k], region=r, device_id=i)
          for i, (k, r) in enumerate(zip(kinds, regions))]
    tf = [Edge(i, r, TD.CATALOG[k])
          for i, (k, r) in enumerate(zip(kinds, regions))]
    return (JTopo.from_fleet(jf, params=JNet(wan_bw_Bps=wan)),
            Topology.from_fleet(tf, params=NetParams(wan_bw_Bps=wan)),
            [d.spec for d in jf], [d.spec for d in tf],
            [str(i) for i in range(len(kinds))])


def two_region(n=8):
    """tests/test_elastic.py's fleet: laptops and phones alternating in
    pairs, regions alternating one by one, a 5 MB/s WAN."""
    return fleet([("laptop-m2pro", "smartphone-sd888")[(i // 2) % 2]
                  for i in range(n)],
                 [("europe", "north_america")[i % 2] for i in range(n)])


def split_fleet():
    """Laptops in europe, phones in north america (the search aligns fast
    devices across the replicas, so both replicas run at one speed)."""
    return fleet(["laptop-m2pro"] * 4 + ["smartphone-sd888"] * 4,
                 ["europe"] * 4 + ["north_america"] * 4)


def pair_fleet():
    """One laptop in europe, one phone in north america: two one-stage
    replicas at different speeds, so each region runs its own K."""
    return fleet(["laptop-m2pro", "smartphone-sd888"],
                 ["europe", "north_america"])


def placements(jcfg, tcfg, fl, dp=2, **kw):
    jt, tt, js, ts, nodes = fl
    kw = dict(dict(batch=8, seq_len=64, microbatches=2,
                   collective="hierarchical"), **kw)
    return (j_search(jcfg, js, topology=jt, nodes=nodes, data_parallel=dp,
                     **kw),
            search_placement(tcfg, ts, topology=tt, nodes=nodes,
                             data_parallel=dp, **kw))


# ------------------------------------------------------------- ckpt state
def ckpt_configs():
    red = dict(num_layers=L, d_model=64, vocab_size=64)
    return (jax_config("opt-125m").reduced(**red),
            torch_config("opt-125m").reduced(**red))


def jax_state(seed=0):
    """bf16 params, fp32 moments with values, an int step: every dtype a
    checkpoint carries."""
    jcfg, _ = ckpt_configs()
    params = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    opt = JA.init_opt_state(params, JA.OptConfig())
    key = jax.random.PRNGKey(seed + 1)
    opt["mu"] = jax.tree.map(
        lambda m: jax.random.normal(key, m.shape, m.dtype), opt["mu"])
    opt["step"] = opt["step"] + 7
    return {"params": params, "opt": opt}


def files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ------------------------------------------------------------------- spec
@pytest.mark.parametrize("replication", [0, 1, 2])
def test_checkpoint_spec_from_placement_equals_jax(replication):
    jcfg, tcfg = ckpt_configs()
    jp, tp = placements(jcfg, tcfg, two_region())
    js = JCS.from_placement(jp, replication)
    ts = TCS.from_placement(tp, replication)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert list(ts.boundaries) == tp.boundaries
    assert ts.slices() == js.slices()
    assert ts.layer_counts() == js.layer_counts()
    assert [ts.held_shards(s) for s in range(ts.num_shards)] == \
        [js.held_shards(s) for s in range(js.num_shards)]
    assert TCS.single(L) == TCS(L, (0, L))
    for args in ((L, (0, 3, 2, L)), (L, (0, 2, L), 2), (L, (0, L), 0,
                                                       (("a",), ("b",)))):
        with pytest.raises(ValueError) as je:
            JCS(*args)
        with pytest.raises(ValueError) as te:
            TCS(*args)
        assert str(je.value) == str(te.value)


# ------------------------------------------------------------------ costs
@pytest.mark.parametrize("replication", [0, 1])
def test_write_heal_recovery_costs_equal_jax(replication):
    jcfg, tcfg = ckpt_configs()
    fl = two_region()
    jp, tp = placements(jcfg, tcfg, fl)
    assert TE.state_layer_bytes(tcfg) == JE.state_layer_bytes(jcfg)
    lb, gb = TE.state_layer_bytes(tcfg)
    js, ts = (JCS.from_placement(jp, replication),
              TCS.from_placement(tp, replication))
    asd = dataclasses.asdict
    assert asd(TE.write_cost(fl[1], tp, ts, lb, gb)) == \
        asd(JE.write_cost(fl[0], jp, js, lb, gb))
    # churn: the same fleet carved into one replica of more stages
    jn, tn = placements(jcfg, tcfg, fl, dp=1)
    for kw in (dict(old_spec=None), dict(naive=True),
               dict(old_spec="spec")):
        jk = dict(kw, old_spec=js if kw.get("old_spec") else None)
        tk = dict(kw, old_spec=ts if kw.get("old_spec") else None)
        jr = JE.recovery_cost(fl[0], jn, layer_bytes=lb, global_bytes=gb,
                              **jk)
        tr = TE.recovery_cost(fl[1], tn, layer_bytes=lb, global_bytes=gb,
                              **tk)
        assert asd(tr) == asd(jr)
    fetches = [("1", "0", 1e6), (TE.STORE, "3", 5e5), ("2", "4", 0.0)]
    assert asd(TE.heal_cost(fl[1], fetches)) == \
        asd(JE.heal_cost(fl[0], fetches))
    with pytest.raises(ValueError, match="layers"):
        TE.recovery_cost(fl[1], tn, old_spec=TCS(L + 1, (0, L + 1)),
                         layer_bytes=lb, global_bytes=gb)


# ------------------------------------------------------- cross restore
@pytest.mark.parametrize("replication", [0, 1])
def test_either_package_restores_the_others_layer_sliced_checkpoint(
        replication, tmp_path):
    jcfg, tcfg = ckpt_configs()
    jp, tp = placements(jcfg, tcfg, two_region())
    st = jax_state()
    JC.save_for_placement(tmp_path / "jax", 4, st, jp,
                          replication=replication)
    like = port_like(st)
    got = TC.restore(tmp_path / "jax", like)
    assert_bitexact(got, st)
    assert_bitexact(TC.restore_for_placement(tmp_path / "jax", tp, like),
                    st)
    # the port writes the same files, manifests included, from the state
    # it restored, and the JAX package restores them bit for bit
    TC.save_for_placement(tmp_path / "port", 4, got, tp,
                          replication=replication)
    a = files(tmp_path / "jax" / "step_00000004")
    assert files(tmp_path / "port" / "step_00000004") == a
    assert sum(".L" in n for n in a) > 0
    assert_bitexact(got, JC.restore(tmp_path / "port", jax_state(seed=3)))
    # one writer at a time (a real fleet's stage writers)
    ts = TCS.from_placement(tp, replication)
    for s in range(ts.num_shards):
        TC.save_sharded(tmp_path / "one", 4, got, ts, s)
    assert files(tmp_path / "one" / "step_00000004") == a
    with pytest.raises(ValueError, match="shard_id"):
        TC.save_sharded(tmp_path / "one", 4, got, ts, ts.num_shards)


@pytest.mark.parametrize("layout", ["layer_sliced", "leaf_modulo"])
def test_stage_restores_crop_as_jax_does(layout, tmp_path):
    st = jax_state()
    if layout == "layer_sliced":
        JC.save_for_placement(tmp_path, 1, st, JCS(L, (0, 1, 3, L), 1))
    else:
        JC.save(tmp_path, 1, st)
    new = (0, 4, L)
    like = port_like(st)
    for stage in range(2):
        want = JC.restore_for_placement(tmp_path, JCS(L, new), st,
                                        stage=stage)
        got = TC.restore_for_placement(tmp_path, TCS(L, new), like,
                                       stage=stage)
        assert_bitexact(got, want)
        tok = got["params"]["decoder"]["g0"]["s0_attn"]["wq"]
        assert tok.shape[0] == new[stage + 1] - new[stage]
    if layout == "layer_sliced":
        with pytest.raises(ValueError, match="layers"):
            TC.restore_for_placement(tmp_path, [0, L + 1], like)


def test_reshard_3_to_2_to_3_round_trips_as_jax_does(tmp_path):
    st = jax_state()
    three, two = TCS(L, (0, 2, 4, L), 1), TCS(L, (0, 3, L), 1)
    like = port_like(st)
    JC.save_for_placement(tmp_path / "orig", 2, st, JCS(L, (0, 2, 4, L), 1))
    src = tmp_path / "port"
    shutil.copytree(tmp_path / "orig", src)
    orig = files(src / "step_00000002")
    TC.reshard(src, two, like, out_directory=tmp_path / "p2")
    JC.reshard(tmp_path / "orig", JCS(L, (0, 3, L), 1), st,
               out_directory=tmp_path / "j2")
    assert files(tmp_path / "p2" / "step_00000002") == \
        files(tmp_path / "j2" / "step_00000002")
    TC.reshard(tmp_path / "p2", three, like, out_directory=tmp_path / "p3")
    assert files(tmp_path / "p3" / "step_00000002") == orig
    assert_bitexact(TC.restore(tmp_path / "p3", like), st)


def test_bit_rot_is_named_and_healed_as_jax_does(tmp_path):
    st = jax_state()
    spec = JCS(L, (0, 2, 4, L), 1)
    for tag in ("j", "t", "jn", "tn"):           # main + neighbour copies
        JC.save_for_placement(tmp_path / tag, 3, st, spec)
    d = {t: tmp_path / t / "step_00000003" for t in ("j", "t")}
    victim = sorted(n for n in files(d["t"]) if ".L00002-00004" in n)[0]
    gone = sorted(n for n in files(d["t"]) if n.startswith("(opt)"))[0]
    assert j_corrupt(d["j"] / victim, seed=5) == \
        corrupt_file(d["t"] / victim, seed=5) == 8
    assert (d["j"] / victim).read_bytes() == (d["t"] / victim).read_bytes()
    for t in d.values():
        (t / gone).unlink()
    want = JC.damaged_files(tmp_path / "j")
    assert TC.damaged_files(tmp_path / "t") == want == \
        [(n, r) for n, r in sorted([(victim, "corrupt"), (gone, "missing")],
                                   key=lambda x: [n for n, _ in want].index(
                                       x[0]))]
    like = port_like(st)
    with pytest.raises(TC.IncompleteCheckpointError, match="missing"):
        TC.restore(tmp_path / "t", like)
    jrep = JC.heal_step(tmp_path / "j", sources=[("nb", tmp_path / "jn")])
    trep = TC.heal_step(tmp_path / "t", sources=[("nb", tmp_path / "tn")])
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.ok and [h["file"] for h in trep.healed] == \
        [n for n, _ in want]
    assert TC.damaged_files(tmp_path / "t") == []
    assert files(d["t"]) == files(d["j"])
    assert_bitexact(TC.restore(tmp_path / "t", like), st)
    # a source whose copy rotted too is skipped; with none clean the
    # file stays unrecovered and restore names it
    corrupt_file(d["t"] / victim, seed=1)
    corrupt_file(tmp_path / "tn" / "step_00000003" / victim, seed=1)
    rep = TC.HealReport()
    with pytest.raises(TC.ShardReadError, match="unreadable"):
        TC.restore(tmp_path / "t", like, sources=[tmp_path / "tn"],
                   heal_report=rep)
    assert not rep.ok and victim in rep.unrecovered[0]
    # restore(sources=) heals from the first clean holder and reports it
    rep = TC.HealReport()
    got = TC.restore(tmp_path / "t", like, sources=[tmp_path / "tn",
                                                    ("far", tmp_path / "jn")],
                     heal_report=rep)
    assert [h["source"] for h in rep.healed] == ["far"]
    assert_bitexact(got, st)


# -------------------------------------------------- local SGD, placement
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=8)
KW = dict(batch=2, seq_len=16, log_every=0, seed=0, attn_impl="chunked")


def _place_pair(fl):
    return placements(JCFG, TCFG, fl, batch=2, seq_len=16)


@functools.lru_cache(maxsize=None)
def run_pair(mode, tmp):
    """(JAX result, port result, JAX placement, port placement) of one
    local-SGD configuration from the same weights."""
    jls = dict(replicas=2, inner_steps=2, outer_lr=0.7)
    extra_j, extra_t = {}, {}
    steps = 8
    if mode in ("sync-placement", "async-placement"):
        jp, tp = _place_pair(two_region() if mode == "sync-placement"
                             else pair_fleet())
        extra_j["placement"], extra_t["placement"] = jp, tp
        jls.update(checkpoint_every_rounds=1, checkpoint_replication=1)
    if mode == "async-placement":
        jls.update(async_mode=True, quorum=1, staleness_bound=1)
    if mode in ("async-health", "async-plain"):
        jls.update(replicas=4, async_mode=True, quorum=4, staleness_bound=2,
                   nominal_step_s=0.1)
        steps = 12
        extra_j["fault_plan"] = JPlan(seed=3, straggler_frac=0.3)
        extra_t["fault_plan"] = FaultPlan(seed=3, straggler_frac=0.3)
        if mode == "async-health":
            extra_j["health"] = JHM(registry=JReg())
            extra_t["health"] = HealthMonitor(registry=MetricsRegistry())
    jdir = tdir = None
    if "checkpoint_every_rounds" in jls:
        jdir, tdir = f"{tmp}/{mode}-jax", f"{tmp}/{mode}-port"
    jres = JL.train_local_sgd(
        JCFG, JT.TrainerConfig(steps=steps, **KW),
        JL.LocalSGDConfig(checkpoint_dir=jdir, **jls), JA.OptConfig(**OPT),
        **extra_j)
    _, params = bridged(JCFG, TCFG, seed=0)
    tres = TL.train_local_sgd(
        TCFG, TT.TrainerConfig(steps=steps, **KW),
        TL.LocalSGDConfig(checkpoint_dir=tdir, **jls), TA.OptConfig(**OPT),
        params=params, device="cpu", **extra_t)
    return jres, tres, extra_j, extra_t, jdir, tdir


@pytest.fixture(scope="module")
def tmp_module(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic_lsgd"))


SAME = ("rounds", "outer_updates", "mode", "per_replica_k",
        "inner_steps_total", "contributed_steps", "dropped_stale",
        "late_merged", "resyncs", "crashes", "virtual_time_s",
        "fault_counts", "replica_regions", "comm_time_s_per_round",
        "comm_time_s_per_step", "sync_wan_bytes_per_round",
        "sync_wire_bytes_per_round", "health_excluded_updates",
        "health_summary")


def _same_result(jres, tres):
    for f in SAME:
        assert getattr(tres, f) == getattr(jres, f), f
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    np.testing.assert_allclose(tres.round_losses, jres.round_losses,
                               rtol=1e-4)
    np.testing.assert_allclose(tres.virtual_tokens_per_s,
                               jres.virtual_tokens_per_s, rtol=1e-12)


@pytest.mark.parametrize("mode", ["sync-placement", "async-placement"])
def test_local_sgd_with_a_placement_matches_jax(mode, tmp_module):
    jres, tres, xj, xt, jdir, tdir = run_pair(mode, tmp_module)
    _same_result(jres, tres)
    assert sorted(tres.replica_regions) == ["europe", "north_america"]
    assert TL.per_replica_inner_steps(
        TL.LocalSGDConfig(replicas=2, inner_steps=2), xt["placement"]) == \
        JL.per_replica_inner_steps(
            JL.LocalSGDConfig(replicas=2, inner_steps=2), xj["placement"])
    if mode == "async-placement":
        assert tres.per_replica_k == [2, 1]     # the phone's region: K 1
    else:
        assert len(xt["placement"].boundaries) >= 3     # 2+ stages
    assert tres.comm_time_s_per_round > 0
    # layer-sliced outer-state checkpoints by the placement's boundaries
    step = TC.latest_complete_step(tdir)
    # (the async loop stops at its last update, before that one's save)
    assert step == JC.latest_complete_step(jdir) == \
        tres.outer_updates - (mode == "async-placement")
    m = TC._read_manifest(TC._step_dir(tdir, step))
    assert m["layout"] == "layer_sliced"
    assert m["replication"] == min(1, xt["placement"].num_stages - 1)
    assert m["boundaries"] == xt["placement"].boundaries
    saved = TC.restore(tdir, tres.outer_state)
    if mode == "sync-placement":      # the last save holds the final state
        for a, b in zip(TT.PM.tree_leaves(saved),
                        TT.PM.tree_leaves(tres.outer_state)):
            assert torch.equal(a, b)
    # the JAX package restores the port's, onto another placement's
    # boundaries, close to its own run's
    theirs = JC.restore_for_placement(tdir, [0, 1, JCFG.num_layers],
                                      _jax_like(), step)
    mine = dict(bridge.flatten(jax.tree.map(
        np.asarray, JC.restore(jdir, _jax_like(), step))))
    for key, a in bridge.flatten(jax.tree.map(np.asarray, theirs)):
        if key.endswith("['bk']"):
            # a gradient that is zero in exact arithmetic: AdamW turns
            # both packages' rounding noise into steps of up to the lr
            assert np.abs(a - mine[key]).max() <= 2 * 2 * OPT["learning_rate"]
        else:
            # AdamW moves an element whose gradient is near zero by up to
            # the lr whatever its sign's rounding, so elements meet that
            # floor and each leaf as a whole the trajectory's 1e-4
            d = a - mine[key]
            assert np.abs(d).max() <= 2 * 2 * OPT["learning_rate"], key
            assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(mine[key]), key


def _jax_like():
    """A JAX outer state of the run's layout (values irrelevant)."""
    p = JP.init_params(JCFG, jax.random.PRNGKey(0))
    return {"params": p, "outer_m": jax.tree.map(
        lambda x: x.astype(np.float32), p)}


def test_async_health_shrinks_the_quorum_as_jax_does(tmp_module):
    """tests/test_health.py's closed loop: FaultPlan(seed=3,
    straggler_frac=0.3), 4 replicas, quorum 4, staleness 2."""
    jres, tres, xj, xt, _, _ = run_pair("async-health", tmp_module)
    _same_result(jres, tres)
    plan = FaultPlan(seed=3, straggler_frac=0.3)
    truth = {str(r) for r in range(4) if plan.is_straggler(r)}
    hm, jhm = xt["health"], xj["health"]
    assert truth and hm.stragglers() == truth == jhm.stragglers()
    assert tres.health_excluded_updates >= 1
    assert tres.health_summary["stragglers"] == sorted(truth)
    assert [(a.kind, a.entity, a.value, a.threshold, a.ts_s, a.detail)
            for a in hm.alerts] == \
        [(a.kind, a.entity, a.value, a.threshold, a.ts_s, a.detail)
         for a in jhm.alerts]
    plain_j, plain_t, *_ = run_pair("async-plain", tmp_module)
    _same_result(plain_j, plain_t)
    assert tres.virtual_time_s < plain_t.virtual_time_s


def test_sync_loop_feeds_the_monitor_as_jax_does():
    jhm, thm = JHM(registry=JReg()), HealthMonitor(registry=MetricsRegistry())
    jls = dict(replicas=3, inner_steps=1)
    plan = dict(seed=16, straggler_frac=0.5, link_flap_prob=0.3)
    jres = JL.train_local_sgd(JCFG, JT.TrainerConfig(steps=4, **KW),
                              JL.LocalSGDConfig(**jls), JA.OptConfig(**OPT),
                              fault_plan=JPlan(**plan), health=jhm)
    _, params = bridged(JCFG, TCFG, seed=0)
    tres = TL.train_local_sgd(TCFG, TT.TrainerConfig(steps=4, **KW),
                              TL.LocalSGDConfig(**jls), TA.OptConfig(**OPT),
                              fault_plan=FaultPlan(**plan), health=thm,
                              params=params, device="cpu")
    _same_result(jres, tres)
    assert [(a.kind, a.entity, a.ts_s) for a in thm.alerts] == \
        [(a.kind, a.entity, a.ts_s) for a in jhm.alerts]
    assert thm.straggler.obs_count == jhm.straggler.obs_count
    assert thm.link.obs_count == jhm.link.obs_count
    assert thm.loss.count == jhm.loss.count == 4


def test_placement_argument_errors_match_jax():
    jp, tp = _place_pair(split_fleet())
    tc = dict(steps=2, **KW)
    topo_t = Topology.from_specs([TD.LAPTOP_M2PRO] * 2)
    topo_j = JTopo.from_specs([JD.LAPTOP_M2PRO] * 2)
    for ls, kw_j, kw_t in (
            (dict(replicas=2, inner_steps=1), dict(placement=jp,
                                                   topology=topo_j),
             dict(placement=tp, topology=topo_t)),
            (dict(replicas=3, inner_steps=1), dict(placement=jp),
             dict(placement=tp))):
        with pytest.raises(ValueError) as je:
            JL.train_local_sgd(JCFG, JT.TrainerConfig(**tc),
                               JL.LocalSGDConfig(**ls), **kw_j)
        with pytest.raises(ValueError) as te:
            TL.train_local_sgd(TCFG, TT.TrainerConfig(**tc),
                               TL.LocalSGDConfig(**ls), device="cpu", **kw_t)
        assert str(te.value) == str(je.value)


# ------------------------------------------------------------- trainer
def test_trainer_checkpoint_placement_resumes_as_jax_does(tmp_path):
    jp, tp = _place_pair(split_fleet())
    kw = dict(checkpoint_every=2, checkpoint_replication=1, **KW)
    base = tmp_path / "jax"
    JT.train(JCFG, JT.TrainerConfig(steps=4, checkpoint_dir=str(base),
                                    checkpoint_placement=jp, **kw))
    _, params = bridged(JCFG, TCFG, seed=0)
    TT.train(TCFG, TT.TrainerConfig(steps=4,
                                    checkpoint_dir=str(tmp_path / "port"),
                                    checkpoint_placement=tp, **kw),
             params=params, device="cpu")
    m = TC._read_manifest(TC._step_dir(tmp_path / "port", 4))
    assert m["layout"] == "layer_sliced" and m["boundaries"] == tp.boundaries
    assert sorted(files(tmp_path / "port" / "step_00000004")) == \
        sorted(files(base / "step_00000004"))
    jres = JT.train(JCFG, JT.TrainerConfig(steps=2, checkpoint_dir=str(base),
                                           checkpoint_placement=jp,
                                           resume=True, **kw))
    _, params = bridged(JCFG, TCFG, seed=9)       # overwritten on resume
    tres = TT.train(TCFG, TT.TrainerConfig(
        steps=2, checkpoint_dir=str(tmp_path / "port"),
        checkpoint_placement=TCS.from_placement(tp), resume=True, **kw),
        params=params, device="cpu")
    assert tres.resumed_from_step == jres.resumed_from_step == 4
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    # the resumed run's own save restores in the JAX package
    like = {"params": JP.init_params(JCFG, jax.random.PRNGKey(0))}
    like["opt"] = JA.init_opt_state(like["params"], JA.OptConfig())
    got = JC.restore(tmp_path / "port", like, step=6)
    assert int(got["opt"]["step"]) == 6
    want = dict(bridge.flatten(bridge.params_to_numpy(params)))
    for k, v in bridge.flatten(jax.tree.map(np.asarray, got["params"])):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
