"""DiLoCo local SGD: the port's ``train_local_sgd`` against the JAX
package's on bridged weights (reduced opt-125m, L2/d128/v512, fp32, the
chunked attention path on both sides): the K=1 anchor to the plain
trainer, the synchronous trajectory with and without int8-compressed
sync, the modelled wide-area sync, the async engine's exact reduction to
the sync loop, its fault accounting under a seeded plan, and the
argument checks.  Placement- and health-driven runs are held to the JAX
package in ``tests/test_torch_elastic.py``."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.energy.devices import LAPTOP_M2PRO as J_LAPTOP  # noqa: E402
from repro.core.faultinject import FaultPlan as JPlan  # noqa: E402
from repro.core.net import NetParams as JNet  # noqa: E402
from repro.core.net import Topology as JTopo  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim.compress import CompressConfig as JCC  # noqa: E402
from repro.train import local_sgd as JL  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.core.energy.devices import LAPTOP_M2PRO  # noqa: E402
from repro_torch.core.faultinject import FaultPlan  # noqa: E402
from repro_torch.core.net import NetParams, Topology  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim.compress import CompressConfig  # noqa: E402
from repro_torch.train import local_sgd as TL  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import bridged  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_train import TRAIN_ARCHS, train_configs  # noqa: E402

JCFG, TCFG = train_configs(*TRAIN_ARCHS[0])
KW = dict(batch=2, seq_len=32, log_every=0, seed=0)
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=8)
# the two-region edge fleet of examples/diloco_edge.py
REGIONS = ["europe", "north_america"]
# the JAX trajectory without compression: fp32 on both sides, summation
# orders differ; with int8 an element whose last bits differ may land on
# the other side of a rounding tie, so one int8 code (one quantization
# step of that element's pseudo-gradient) may differ per flip
LOSS_RTOL = {"none": 1e-4, "int8": 1e-3}
# a plan that straggles, crashes and flaps (JAX's test_faults seed 16)
PLAN = dict(seed=16, straggler_frac=0.5, crash_prob=0.4, link_flap_prob=0.3)


def ls_pair(**kw):
    comp = kw.pop("compress", "none")
    return (JL.LocalSGDConfig(compress=JCC(method=comp), **kw),
            TL.LocalSGDConfig(compress=CompressConfig(method=comp), **kw))


@functools.lru_cache(maxsize=None)
def run_pair(steps, comp="none", plan=False, topo=False, **ls_kw):
    """(JAX result, port result) from the same weights and config."""
    jls, tls = ls_pair(compress=comp, **ls_kw)
    extra_j, extra_t = {}, {}
    if plan:
        extra_j["fault_plan"] = JPlan(**PLAN)
        extra_t["fault_plan"] = FaultPlan(**PLAN)
    if topo:
        extra_j["topology"] = JTopo.from_specs(
            [J_LAPTOP] * 2, regions=REGIONS, params=JNet(wan_bw_Bps=4e6))
        extra_t["topology"] = Topology.from_specs(
            [LAPTOP_M2PRO] * 2, regions=REGIONS,
            params=NetParams(wan_bw_Bps=4e6))
    jres = JL.train_local_sgd(
        JCFG, JT.TrainerConfig(steps=steps, attn_impl="chunked", **KW), jls,
        JA.OptConfig(**OPT), **extra_j)
    _, tp = bridged(JCFG, TCFG, seed=0)
    tres = TL.train_local_sgd(
        TCFG, TT.TrainerConfig(steps=steps, attn_impl="chunked", **KW), tls,
        TA.OptConfig(**OPT), params=tp, device="cpu", **extra_t)
    return jres, tres


def test_one_replica_k1_matches_the_plain_trainer():
    tc = TT.TrainerConfig(steps=6, attn_impl="chunked", **KW)
    opt = TA.OptConfig(**OPT)
    _, tp = bridged(JCFG, TCFG, seed=0)
    plain = TT.train(TCFG, tc, opt, params=tp, device="cpu")
    _, tp = bridged(JCFG, TCFG, seed=0)
    loc = TL.train_local_sgd(
        TCFG, tc, TL.LocalSGDConfig(replicas=1, inner_steps=1, outer_lr=1.0,
                                    outer_momentum=0.0, nesterov=False),
        opt, params=tp, device="cpu")
    # identical trajectory up to fp32 rounding of g - (g - l)
    np.testing.assert_allclose(loc.losses, plain.losses, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_sync_trajectory_and_priced_sync_match_jax(comp):
    jres, tres = run_pair(6, comp, topo=True, replicas=2, inner_steps=2)
    assert tres.rounds == jres.rounds == 3
    assert len(tres.losses) == len(jres.losses) == 6
    np.testing.assert_allclose(tres.losses, jres.losses,
                               rtol=LOSS_RTOL[comp])
    np.testing.assert_allclose(tres.round_losses, jres.round_losses,
                               rtol=LOSS_RTOL[comp])
    assert tres.sync_wire_bytes_per_round == jres.sync_wire_bytes_per_round
    assert tres.comm_time_s_per_round == jres.comm_time_s_per_round > 0
    assert tres.comm_time_s_per_step == jres.comm_time_s_per_step
    assert tres.sync_wan_bytes_per_round == jres.sync_wan_bytes_per_round
    assert tres.virtual_time_s == jres.virtual_time_s
    assert tres.inner_steps_total == jres.inner_steps_total == 12
    assert set(tres.phase_s) == {"inner", "pseudograd", "outer"}
    # the final outer state: fp32 momentum beside params of the model's
    # dtype, as a checkpoint of it holds
    st = tres.outer_state
    assert st["outer_m"]["embed"]["tok"].dtype == torch.float32
    assert float(st["outer_m"]["embed"]["tok"].abs().max()) > 0


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_async_quorum_all_staleness_0_is_bit_identical_to_sync(comp):
    _, tls = ls_pair(compress=comp, replicas=2, inner_steps=2)
    tc = TT.TrainerConfig(steps=4, **KW)
    runs = []
    for mode in (False, True):
        _, tp = bridged(JCFG, TCFG, seed=0)
        runs.append(TL.train_local_sgd(
            TCFG, tc, dataclasses.replace(tls, async_mode=mode),
            TA.OptConfig(**OPT), params=tp, device="cpu"))
    sync, asyn = runs
    assert (sync.mode, asyn.mode) == ("sync", "async")
    assert asyn.losses == sync.losses
    assert asyn.round_losses == sync.round_losses
    assert asyn.outer_updates == sync.outer_updates == sync.rounds == 2
    for a, b in zip(*(TL.PM.tree_leaves(r.outer_state) for r in runs)):
        assert torch.equal(a, b)


def test_async_fault_accounting_matches_jax():
    jres, tres = run_pair(8, plan=True, replicas=3, inner_steps=2,
                          async_mode=True, quorum=2, staleness_bound=1)
    for f in ("outer_updates", "dropped_stale", "late_merged", "resyncs",
              "crashes", "fault_counts", "virtual_time_s", "per_replica_k",
              "inner_steps_total", "contributed_steps", "rounds",
              "virtual_tokens_per_s"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.crashes >= 1 and tres.fault_counts.get("rejoin", 0) >= 1
    # staleness-weighted merges of fp32 deltas: sums in other orders
    np.testing.assert_allclose(tres.round_losses, jres.round_losses,
                               rtol=1e-4)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)


def test_sync_virtual_clock_under_faults_matches_jax():
    jres, tres = run_pair(6, plan=True, replicas=3, inner_steps=2)
    assert tres.crashes == jres.crashes
    assert tres.fault_counts == jres.fault_counts
    assert tres.virtual_time_s == jres.virtual_time_s
    # the plan moves the clock, never the trajectory
    _, plain = run_pair(6, replicas=3, inner_steps=2)
    assert tres.losses == plain.losses


def test_config_and_result_fields_match_jax():
    assert [f.name for f in dataclasses.fields(TL.LocalSGDConfig)] == \
        [f.name for f in dataclasses.fields(JL.LocalSGDConfig)]
    assert dataclasses.asdict(TL.LocalSGDConfig()) == \
        dataclasses.asdict(JL.LocalSGDConfig())
    mine = [f.name for f in dataclasses.fields(TL.LocalSGDResult)]
    assert mine == [f.name for f in dataclasses.fields(JL.LocalSGDResult)] \
        + ["phase_s", "outer_state"]


def test_refusals_of_what_is_not_ported_and_bad_knobs():
    tc = TT.TrainerConfig(steps=2, **KW)
    ls = TL.LocalSGDConfig(replicas=2, inner_steps=1)
    # placement= and health= are ported: a placement must come without a
    # topology and carry one pipeline a replica
    from repro_torch.core.placement import ordered_placement
    two = ordered_placement(TCFG, [LAPTOP_M2PRO], data_parallel=2)
    with pytest.raises(ValueError, match="either topology= or placement="):
        TL.train_local_sgd(TCFG, tc, ls, placement=two, device="cpu",
                           topology=Topology.from_specs([LAPTOP_M2PRO] * 2))
    with pytest.raises(ValueError, match="2 replica pipelines"):
        TL.train_local_sgd(TCFG, tc, dataclasses.replace(ls, replicas=3),
                           placement=two, device="cpu")
    assert TL.per_replica_inner_steps(ls, placement=two) == [1, 1]
    with pytest.raises(ValueError, match="quorum"):
        TL.train_local_sgd(TCFG, tc, dataclasses.replace(
            ls, async_mode=True, quorum=5), device="cpu")
    with pytest.raises(ValueError, match="staleness_bound"):
        TL.train_local_sgd(TCFG, tc, dataclasses.replace(
            ls, staleness_bound=-1), device="cpu")
    with pytest.raises(ValueError, match="topology has 1 devices"):
        TL.train_local_sgd(TCFG, tc, ls, device="cpu",
                           topology=Topology.from_specs([LAPTOP_M2PRO]))
    from repro_torch.core.energy.monitor import ComponentModel, EnergyMonitor
    mon = EnergyMonitor(ComponentModel.for_device(LAPTOP_M2PRO))
    with pytest.raises(ValueError, match="EnergyMonitor"):
        TL.train_local_sgd(TCFG, tc, dataclasses.replace(
            ls, async_mode=True), monitor=mon, device="cpu")
    _, tp = bridged(JCFG, TCFG)
    with pytest.raises(ValueError, match="params must live on"):
        TL.train_local_sgd(TCFG, tc, ls, device="cpu",
                           params=TL.PM.tree_map(lambda a: a.to("meta"), tp))


def test_energy_monitor_and_metrics_in_the_sync_loop():
    from repro_torch.core.energy.monitor import ComponentModel, EnergyMonitor
    from repro_torch.obs.metrics import MetricsRegistry
    mon = EnergyMonitor(ComponentModel.for_device(LAPTOP_M2PRO))
    reg = MetricsRegistry()
    res = TL.train_local_sgd(
        TCFG, TT.TrainerConfig(steps=4, **KW),
        TL.LocalSGDConfig(replicas=2, inner_steps=2,
                          compress=CompressConfig(method="int8")),
        monitor=mon, metrics=reg, device="cpu")
    assert len(mon.samples) == 2 * 2 * 2 and res.energy_wh > 0
    snap = reg.snapshot()
    assert snap["local_sgd/rounds"]["value"] == 2
    assert snap["local_sgd/pseudograd_bytes"]["value"] == \
        2 * 2 * res.sync_wire_bytes_per_round
    assert snap["local_sgd/loss"]["count"] == 4


@pytest.mark.parametrize("mode", ["sync", "async-faults"])
def test_launcher_runs_local_sgd_on_the_cpu(mode, capsys):
    from repro_torch.launch import train
    argv = ["--torch-device", "cpu", "--local-sgd", "--replicas", "2",
            "--inner-steps", "2", "--steps", "8", "--batch", "2",
            "--seq", "32"]
    if mode != "sync":
        argv += ["--async", "--replicas", "3", "--quorum", "2",
                 "--staleness-bound", "1", "--fault-seed", "16",
                 "--straggler-frac", "0.5", "--crash-prob", "0.4"]
    train.main(argv)
    out = capsys.readouterr().out
    assert "[train] final loss" in out
    assert ("[train] async:" in out) == (mode != "sync")
    # --mesh runs the trainer and the same local-SGD loop (one CPU rank
    # here), printing the same final lines
    if mode == "sync":
        res = train.main(["--torch-device", "cpu", "--mesh", "1,1",
                          "--steps", "2", "--batch", "2", "--seq", "16"])
        assert len(res.values[0][0].losses) == 2
        capsys.readouterr()
    res = train.main(["--torch-device", "cpu", "--mesh", "1,1", *argv[2:]])
    mesh_out = capsys.readouterr().out

    def final(text, prefix):
        return [line.split("  ")[0] for line in text.splitlines()
                if line.startswith(prefix)]
    assert final(mesh_out, "[train] final loss") == \
        final(out, "[train] final loss")
    assert final(mesh_out, "[train] async:") == final(out, "[train] async:")
    assert res.values[0][0].result.mode == ("sync" if mode == "sync"
                                            else "async")
    # --health-out and --slo are ported: the record passes the validator
    import tempfile
    from repro_torch.obs.validate import validate
    with tempfile.TemporaryDirectory() as d:
        train.main(argv + ["--health-out", f"{d}/h.jsonl",
                           "--slo", "tokens_per_s=1e12"])
        assert validate(f"{d}/h.jsonl")["slo"] == 1
    out = capsys.readouterr().out
    assert "[train] health: alerts:" in out
    assert "train_tokens_per_s:BREACH" in out
