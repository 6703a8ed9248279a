"""The torch twins of the examples against the JAX examples, on the CPU at
reduced sizes.

Each JAX example runs as written: its ``main`` (or the function it splits
out) is called, with the library calls it makes wrapped to record their
results, and with the only two changes a parity test needs: the configs
compute in fp32, and the random prompts it draws with ``jax.random`` come
from numpy with the same integer seeds, as the twins draw them.  Bars:

* quickstart (reduced opt-125m, 4 steps of 2 x 32): losses at the
  trainer parity bar (rtol 1e-4), the modelled compute energy and FLOPs
  of every step exact;
* DiLoCo (2 rounds x 2 inner steps): round losses at rtol 1e-4, wire
  bytes and modelled sync seconds (and the naive ring's) exact;
* serving: ``mixtral-8x7b-smoke`` through the engine and
  ``mamba2-130m-smoke`` through the dense path, greedy ids equal;
* carbon sim (60 steps): ``SimResult``s and offload rows equal;
* the DT-FM pipeline: its JAX example cannot run on the installed jax
  (its shard_map pipeline raises ``ShardingTypeError``), so the twin's
  losses are held to JAX ``make_train_step`` from the same weights on the
  same batches (rtol 1e-4), its plan and placement to ``dtfm.plan`` and
  ``ordered_placement`` exactly."""

import dataclasses
import importlib.util
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def load(name):
    """An example script as a module (examples/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def bridge(jcfg, tcfg, seed=0):
    """The JAX ``init_params(PRNGKey(seed))`` weights, and the same as
    port tensors on the CPU."""
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def recorder(fn, sink):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        sink.append((a, kw, out))
        return out
    return wrapped


@pytest.fixture
def numpy_prompts(monkeypatch):
    """``jax.random.randint(PRNGKey(s), shape, lo, hi)`` drawn as the twins
    draw it: ``np.random.default_rng(s).integers(lo, hi, shape)``."""
    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1])
        return jnp.asarray(np.random.default_rng(seed).integers(
            minval, maxval, shape), dtype)
    monkeypatch.setattr(jax.random, "randint", randint)


def test_quickstart_twin_matches_the_jax_example(monkeypatch, capsys):
    jq, tq = load("quickstart"), load("torch_quickstart")
    runs = []
    monkeypatch.setattr(jq, "get_config", lambda a: fp32(j_config(a)))
    monkeypatch.setattr(jq, "train", recorder(jq.train, runs))
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--steps", "4",
                                      "--batch", "2", "--seq", "32"])
    jq.main()
    (_, jkw, jres), = runs
    jmon = jkw["monitor"]

    red = dict(num_layers=4, d_model=256, vocab_size=2048)
    jcfg = fp32(j_config("opt-125m").reduced(**red))
    tcfg = fp32(t_config("opt-125m").reduced(**red))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    _, tp = bridge(jcfg, tcfg, seed=0)       # the JAX trainer's init
    tres, ledger, tmon = tq.run(tcfg, steps=4, batch=2, seq=32,
                                device="cpu", params=tp)
    assert len(tres.losses) == len(jres.losses) == 4
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    # the modelled energy's compute share is exact; the static share
    # prices each step's wall clock
    assert [s.flops for s in tmon.samples] == [s.flops
                                               for s in jmon.samples]
    assert tmon.breakdown_j()["compute"] == jmon.breakdown_j()["compute"]
    assert tres.energy_wh == tmon.total_wh > 0
    assert ledger.operational_kg > 0
    out = capsys.readouterr().out
    assert out.count("final loss      :") == 2
    assert out.count("operational CO2 :") == 2


def test_diloco_twin_matches_the_jax_example(monkeypatch, capsys):
    jd, td = load("diloco_edge"), load("torch_diloco_edge")
    runs, naive = [], []
    monkeypatch.setattr(jd, "train_local_sgd",
                        recorder(jd.train_local_sgd, runs))
    monkeypatch.setattr(jd, "sync_cost", recorder(jd.sync_cost, naive))
    monkeypatch.setattr(sys, "argv", ["diloco_edge.py", "--rounds", "2",
                                      "--inner", "2", "--batch", "2",
                                      "--seq", "32"])
    jd.main()
    (_, _, jres), = runs
    (_, _, jnaive), = naive

    red = dict(num_layers=4, d_model=256, vocab_size=2048)
    jcfg = fp32(j_config("opt-125m").reduced(**red))
    tcfg = fp32(t_config("opt-125m").reduced(**red))
    _, tp = bridge(jcfg, tcfg, seed=0)
    tres, tnaive = td.run(tcfg, replicas=2, rounds=2, inner=2, batch=2,
                          seq=32, device="cpu", params=tp)
    assert tres.rounds == jres.rounds == 2
    np.testing.assert_allclose(tres.round_losses, jres.round_losses,
                               rtol=1e-4)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    assert tres.sync_wire_bytes_per_round == jres.sync_wire_bytes_per_round
    assert tres.comm_time_s_per_round == jres.comm_time_s_per_round
    assert tres.comm_time_s_per_step == jres.comm_time_s_per_step
    assert tres.sync_wan_bytes_per_round == jres.sync_wan_bytes_per_round
    assert tnaive.time_s == jnaive.time_s
    assert tnaive.wan_bytes == jnaive.wan_bytes
    assert capsys.readouterr().out.count("naive every-step sync:") == 2


SERVE_ARGS = dict(requests=6, prompt_len=16, max_new=24)


def test_serve_twin_engine_matches_the_jax_example(monkeypatch,
                                                   numpy_prompts):
    from repro.serve import engine as JE
    js, ts = load("serve_batched"), load("torch_serve_batched")
    runs = []
    monkeypatch.setattr(JE.ServeEngine, "run",
                        recorder(JE.ServeEngine.run, runs))
    jcfg = fp32(j_config("mixtral-8x7b-smoke"))
    tcfg = fp32(t_config("mixtral-8x7b-smoke"))
    jp, tp = bridge(jcfg, tcfg, seed=0)
    js.run_engine(Namespace(temperature=0.0, top_k=0, **SERVE_ARGS),
                  jcfg, jp)
    (ja, _, jout), = runs
    jreqs = ja[1]
    treqs, tout, engine = ts.run_engine(tcfg, tp, **SERVE_ARGS)
    assert [r.prompt for r in treqs] == [r.prompt for r in jreqs]
    assert len(tout) == len(jout) == 6
    for r in treqs:
        assert tout[r.uid].tokens == jout[r.uid].tokens, r.uid
        assert len(tout[r.uid].tokens) == 24
    assert engine.stats()["tokens_generated"] == 144


def test_serve_twin_dense_path_matches_the_jax_example(monkeypatch,
                                                       numpy_prompts):
    from repro.serve import step as JS
    js, ts = load("serve_batched"), load("torch_serve_batched")
    runs = []
    monkeypatch.setattr(JS, "greedy_generate",
                        recorder(JS.greedy_generate, runs))
    jcfg = fp32(j_config("mamba2-130m-smoke"))
    tcfg = fp32(t_config("mamba2-130m-smoke"))
    jp, tp = bridge(jcfg, tcfg, seed=0)
    js.run_dense(Namespace(temperature=0.0, top_k=0, **SERVE_ARGS),
                 jcfg, jp)
    (ja, _, jout), = runs
    prompt, tout, wall, mon = ts.run_dense(tcfg, tp, **SERVE_ARGS)
    assert np.array_equal(prompt, np.asarray(ja[2]))
    assert tout.shape == (6, 16 + 24)
    assert np.array_equal(tout.numpy(), np.asarray(jout))
    assert len(mon.samples) == 24 and wall > 0


def test_carbon_sim_twin_matches_the_jax_example(capsys):
    jc, tc = load("edge_carbon_sim"), load("torch_edge_carbon_sim")
    from repro.configs.opt import opt_config as j_opt
    from repro.core.carbon.offload import baseline_footprint
    from repro.core.carbon.offload import offload_analysis
    from repro.core.energy import devices as JD
    from repro.core.sched.carbon_aware import carbon_rate
    from repro.core.sched.orchestrator import make_fleet
    from repro_torch.configs.opt import opt_config as t_opt

    jfleet = make_fleet({"laptop-m2pro": 8, "smartphone-sd888": 16},
                        regions=("nordics", "europe", "india"), seed=3)
    tfleet = tc.example_fleet()
    assert [dataclasses.asdict(d) for d in tfleet] \
        == [dataclasses.asdict(d) for d in jfleet]
    rates = sorted(carbon_rate(d, 12.0, {})[0] for d in jfleet)
    median = rates[len(rates) // 2]
    assert tc.median_rate(tfleet) == median
    for threshold in (float("inf"), median):
        a = jc.run_policy(j_opt("opt-125m"), jfleet, 60, threshold, "jax")
        b = tc.run_policy(t_opt("opt-125m"), tfleet, 60, threshold, "port")
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.steps_done == 60
    blind, aware = tc.compare_policies(t_opt("opt-125m"), tfleet, 60)
    assert aware.carbon_kg < blind.carbon_kg
    rows = tc.offload_table()
    assert list(rows) == ["smartphone-sd888", "laptop-m2pro"]
    for name, (fp, out) in rows.items():
        dev = JD.CATALOG[name]
        assert dataclasses.asdict(fp) \
            == dataclasses.asdict(baseline_footprint(dev))
        assert out == offload_analysis(dev, JD.CLOUD_H100,
                                       use_paper_counts=True)
    text = capsys.readouterr().out
    assert "carbon-aware saves" in text and "net reduction" in text


def test_pipeline_twin_matches_jax_plan_placement_and_train_step(capsys):
    """The twin at a 1 x 2 mesh, 3 steps of 4 x 32 in 2 microbatches, on
    the example's 14M geometry (examples/decentralized_pipeline.py:55-58)
    in fp32."""
    from repro.configs.opt import opt_config as j_opt
    from repro.core.energy import devices as JD
    from repro.core.placement import ordered_placement as j_ordered
    from repro.core.planner import dtfm as JDT
    from repro.data.pipeline import make_batch_fn as j_batches
    from repro.optim import adamw as JA
    from repro.train import step as JS
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as TM
    from repro_torch.models.params import init_params
    from test_torch_placement import _plan_view, _spec_view

    tpipe = load("torch_decentralized_pipeline")
    tcfg = fp32(tpipe.model_config(14))
    jcfg = fp32(dataclasses.replace(
        j_opt("opt-125m"), name="opt-14m-pipe", num_layers=8, d_model=384,
        num_heads=8, num_kv_heads=8, head_dim=48, d_ff=1536,
        vocab_size=4096))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, tp = bridge(jcfg, tcfg, seed=0)
    steps, batch, seq, mb = 3, 4, 32, 2
    res = tpipe.run(tcfg, data=1, stages=2, steps=steps, batch=batch,
                    seq=seq, microbatches=mb, device="cpu", params=tp)

    # the example's optimizer, JAX's single-device step, the same batches
    ocfg = JA.OptConfig(learning_rate=3e-4, warmup_steps=20,
                        decay_steps=steps)
    jstep = jax.jit(JS.make_train_step(jcfg, ocfg))
    jopt, data, jlosses = JA.init_opt_state(jp, ocfg), \
        j_batches(jcfg, batch, seq, seed=0), []
    for _ in range(steps):
        jp, jopt, m = jstep(jp, jopt, {k: jnp.asarray(v)
                                       for k, v in next(data).items()})
        jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(res.losses, jlosses, rtol=1e-4)

    jplan = JDT.plan(jcfg, [JD.LAPTOP_M2PRO] * 2, batch=batch, seq_len=seq,
                     microbatches=mb, data_parallel=1)
    assert _plan_view(res.plan) == _plan_view(jplan)
    jspec = j_ordered(jcfg, [JD.LAPTOP_M2PRO, JD.SMARTPHONE_SD888])
    assert _spec_view(res.spec) == _spec_view(jspec)
    assert res.spec.layer_counts == jspec.layer_counts == [7, 1]

    # the non-uniform split's loss: the port's forward_train on the same
    # weights (seed 1) and the batch after the training steps
    stream = make_batch_fn(tcfg, batch, seq, seed=0)
    for _ in range(steps):
        next(stream)
    nb = {k: torch.from_numpy(v) for k, v in next(stream).items()}
    ref, _ = TM.forward_train(init_params(tcfg, device="cpu", seed=1),
                              tcfg, nb)
    np.testing.assert_allclose(res.nonuniform_loss, float(ref), rtol=1e-5)
    assert res.launches == [{"flash_attention_fwd": 0,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkdv": 0}] * 2
    out = capsys.readouterr().out
    assert "DT-FM analytic plan (2 laptops x 1 pipelines):" in out
    assert "non-uniform split [7, 1] executes: loss" in out
    assert "\n".join(tpipe.plan_report(tcfg, data=1, stages=2, batch=batch,
                                       seq=seq, microbatches=mb)[1]) in out
