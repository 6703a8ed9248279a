"""The training path: the port's loss and gradients against
``jax.value_and_grad`` of the JAX package's ``forward_train`` for every
attention impl, AdamW against the JAX update, gradient accumulation, the
trainer's loss trajectory against ``repro.train.trainer.train`` step for
step, and the pieces around them (data, FLOP model, metrics drain,
launcher).  All in fp32 on bridged weights."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import flops as JF  # noqa: E402
from repro.data.pipeline import make_batch_fn as j_batches  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core import flops as TF  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn as t_batches  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.obs.metrics import (DeviceAccumulator,  # noqa: E402
                                     MetricsRegistry, fetch_scalars)
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import bridged, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

# (arch, reduced widths, patch): reduced opt-125m with head_dim 32 and
# head_dim 64 (learned positions, LayerNorm, GELU, tied padded head), and
# qwen2 with GQA g=2 (RoPE, RMSNorm, SiLU, QKV bias, untied head)
TRAIN_ARCHS = [
    ("opt-125m", dict(num_layers=2, d_model=128, vocab_size=512), {}),
    ("opt-125m", dict(num_layers=4, d_model=256, vocab_size=2048), {}),
    ("qwen2-7b", dict(num_layers=2, d_model=256, vocab_size=512),
     dict(num_kv_heads=2)),
]
TRAIN_IDS = ["opt-L2-d128", "opt-L4-d256", "qwen2-g2"]
# port impl -> the JAX impl of the same algorithm
JAX_IMPL = {"naive": "naive", "chunked": "chunked", "kernel": "pallas"}
# fp32 on both sides; sums run in other orders (the loss is a mean over
# the batch, the gradients sums over it), so the bars are relative
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def train_configs(arch, red, patch):
    jcfg = tiny(jax_config(arch), **red)
    tcfg = dataclasses.replace(torch_config(arch).reduced(**red),
                               param_dtype="float32",
                               compute_dtype="float32")
    jcfg = dataclasses.replace(jcfg, **patch)
    tcfg = dataclasses.replace(tcfg, **patch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def np_batch(cfg, B=2, S=64, seed=0, masked=5):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :masked] = -1                 # masked targets
    return {"tokens": toks[:, :-1], "labels": labels}


def assert_tree_close(mine, ref, of_max=0.0, **tol):
    """``mine``: a port tree; ``ref``: the JAX tree of the same layout.
    ``of_max`` adds that share of each reference leaf's largest magnitude
    to ``atol``."""
    ref_flat = dict(bridge.flatten(jax.tree.map(np.asarray, ref)))
    mine_flat = dict(bridge.flatten(mine))
    assert set(ref_flat) == set(mine_flat)
    for key, r in ref_flat.items():
        m = mine_flat[key].detach().float().numpy()
        r = np.asarray(r, np.float32)
        kw = dict(tol, atol=tol.get("atol", 0.0) + of_max * np.abs(r).max())
        np.testing.assert_allclose(m, r, **kw, err_msg=key)


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
@pytest.mark.parametrize("arch,red,patch", TRAIN_ARCHS, ids=TRAIN_IDS)
def test_forward_train_loss_and_grads_match_jax(arch, red, patch, impl):
    jcfg, tcfg = train_configs(arch, red, patch)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b,
                                      attn_impl=JAX_IMPL[impl])[0]))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tloss, mets = TM.forward_train(tp, tcfg, {k: t(v) for k, v in
                                              nb.items()}, attn_impl=impl)
    grads = torch.autograd.grad(tloss, leaves)
    assert float(mets["tokens"]) == float((nb["labels"] >= 0).sum())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    gtree = dict(zip([k for k, _ in bridge.flatten(tp)], grads))
    flat = dict(bridge.flatten(jax.tree.map(np.asarray, jgrads)))
    for key, ref in flat.items():
        np.testing.assert_allclose(gtree[key].numpy(), ref, **GRAD_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("arch,red,patch", TRAIN_ARCHS[::2],
                         ids=TRAIN_IDS[::2])
def test_forward_logits_match_jax(arch, red, patch):
    jcfg, tcfg = train_configs(arch, red, patch)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, S=24)
    jl = JM.forward_logits(jp, jcfg, {"tokens": jnp.asarray(nb["tokens"])})
    tl = TM.forward_logits(tp, tcfg, {"tokens": t(nb["tokens"])})
    assert tl.shape == (2, 24, tcfg.padded_vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
def test_remat_policies_give_the_same_loss_and_grads(remat):
    _, tcfg = train_configs(*TRAIN_ARCHS[0])
    tp = TM_params(tcfg)
    batch = {k: t(v) for k, v in np_batch(tcfg).items()}
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    ref_loss, _ = TM.forward_train(tp, tcfg, batch)
    ref = torch.autograd.grad(ref_loss, leaves)
    loss, _ = TM.forward_train(tp, tcfg, batch, remat=remat)
    got = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="unknown remat"):
        TM.forward_train(tp, tcfg, batch, remat="everything")


def TM_params(tcfg):
    from repro_torch.models.params import init_params
    return init_params(tcfg, device="cpu", seed=0)


def test_lm_logits_masks_padded_ids_out_of_place():
    _, tcfg = train_configs("opt-125m", dict(num_layers=2, d_model=128,
                                             vocab_size=500), {})
    assert tcfg.padded_vocab_size > tcfg.vocab_size
    tp = TM_params(tcfg)
    h = torch.randn(2, 3, tcfg.d_model, requires_grad=True)
    logits = TM.lm_logits(tp, tcfg, h)
    assert (logits[..., tcfg.vocab_size:] == -1e30).all()
    assert (logits[..., :tcfg.vocab_size] > -1e29).all()
    logits.sum().backward()                     # differentiable
    raw = h.detach() @ tp["embed"]["tok"].T
    torch.testing.assert_close(logits.detach()[..., :tcfg.vocab_size],
                               raw[..., :tcfg.vocab_size])


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_after_k_steps(moment_dtype):
    jcfg, tcfg = train_configs(*TRAIN_ARCHS[0])
    jp, tp = bridged(jcfg, tcfg)
    ocfg = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=6,
                moment_dtype=moment_dtype, clip_norm=0.5)
    jo, to = JA.OptConfig(**ocfg), TA.OptConfig(**ocfg)
    jstate, tstate = JA.init_opt_state(jp, jo), TA.init_opt_state(tp, to)
    rs = np.random.RandomState(0)
    upd = jax.jit(lambda p, g, s: JA.apply_updates(p, g, s, jo))
    for _ in range(4):
        g = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32),
                         jp)
        jp, jstate, jm = upd(jp, g, jstate)
        tg = bridge.params_from_numpy(g, tcfg, "cpu")
        tp, tstate, tm = TA.apply_updates(tp, tg, tstate, to)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 4
    if moment_dtype == "float32":
        p_tol, m_tol = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-5, atol=1e-7)
    else:
        # an fp32 difference in the last place can round a bf16 moment to
        # the neighbouring value (2**-7 of it), which later steps carry
        # on at the leaf's scale; the update it feeds moves the parameter
        # by a few lr * 2**-8
        p_tol = dict(rtol=1e-5, atol=4 * ocfg["learning_rate"] * 2.0 ** -8)
        m_tol = dict(rtol=2.0 ** -7, of_max=2.0 ** -7)
    assert_tree_close(tp, jp, **p_tol)
    assert_tree_close(tstate["mu"], jstate["mu"], **m_tol)
    assert_tree_close(tstate["nu"], jstate["nu"], **m_tol)
    assert all(m.dtype == getattr(torch, moment_dtype)
               for m in tree_leaves(tstate["mu"]))


def test_schedule_matches_jax():
    cfg = TA.OptConfig(warmup_steps=10, decay_steps=100)
    jc = JA.OptConfig(warmup_steps=10, decay_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 100, 150):
        assert float(TA.schedule(cfg, s)) == pytest.approx(
            float(JA.schedule(jc, jnp.asarray(s))), rel=1e-6)


def test_train_step_matches_jax_and_microbatches_agree():
    jcfg, tcfg = train_configs(*TRAIN_ARCHS[2])
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=4, S=32, masked=0)
    # eps 1e-3 keeps Adam's first step a smooth function of the gradient:
    # with the default 1e-8 it is lr * sign(g), which turns rounding noise
    # in near-zero gradients (the key bias's is zero: softmax ignores a
    # constant added to a row's scores) into +-lr
    ocfg = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=4, eps=1e-3)
    jstep = jax.jit(JS.make_train_step(jcfg, JA.OptConfig(**ocfg),
                                       attn_impl="chunked"))
    jp, _, jm = jstep(jp, JA.init_opt_state(jp, JA.OptConfig(**ocfg)),
                      {k: jnp.asarray(v) for k, v in nb.items()})
    batch = {k: t(v) for k, v in nb.items()}
    out = {}
    for m in (1, 2):
        p = tree_map(lambda a: a.clone(), tp)
        step = TS.make_train_step(tcfg, TA.OptConfig(**ocfg),
                                  attn_impl="kernel", microbatches=m)
        p, state, mets = step(p, TA.init_opt_state(p, TA.OptConfig(**ocfg)),
                              batch)
        out[m] = (p, mets)
        assert int(state["step"]) == 1
    # the JAX step (one batch) against the port's single-batch step
    np.testing.assert_allclose(float(out[1][1]["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(out[1][1]["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert_tree_close(out[1][0], jp, rtol=1e-5, atol=1e-6)
    # two microbatches of equal token counts: the same mean loss and step
    np.testing.assert_allclose(float(out[2][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    assert_tree_close(out[2][0], bridge.params_to_numpy(out[1][0]),
                      rtol=1e-5, atol=1e-6)


def test_step_compress_hook_runs_and_eval_matches_forward():
    from repro_torch.optim.compress import CompressConfig
    _, tcfg = train_configs(*TRAIN_ARCHS[0])
    # the compress hook runs now (its parity with the JAX step is in
    # test_torch_compress.py); an unknown method is refused
    batch = {k: t(v) for k, v in np_batch(tcfg).items()}
    tp = TM_params(tcfg)
    step = TS.make_train_step(tcfg, TA.OptConfig(),
                              compress=CompressConfig(method="int8"))
    _, state, mx = step(tp, TA.init_opt_state(tp, TA.OptConfig()), batch)
    assert int(state["step"]) == 1 and np.isfinite(float(mx["loss"]))
    bad = TS.make_train_step(tcfg, TA.OptConfig(),
                             compress=CompressConfig(method="fp4"))
    with pytest.raises(ValueError, match="fp4"):
        bad(tp, TA.init_opt_state(tp, TA.OptConfig()), batch)
    tp = TM_params(tcfg)
    batch = {k: t(v) for k, v in np_batch(tcfg).items()}
    ev = TS.make_eval_step(tcfg, attn_impl="chunked")(tp, batch)
    loss, _ = TM.forward_train(tp, tcfg, batch, attn_impl="naive")
    assert float(ev["loss"]) == pytest.approx(float(loss), rel=1e-5)
    assert not ev["loss"].requires_grad


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_trainer_loss_trajectory_matches_jax_step_for_step(impl, capsys):
    jcfg, tcfg = train_configs(*TRAIN_ARCHS[0])
    kw = dict(steps=8, batch=2, seq_len=32, log_every=3, seed=0)
    jres = JT.train(jcfg, JT.TrainerConfig(attn_impl="chunked", **kw))
    _, tp = bridged(jcfg, tcfg, seed=0)          # the JAX trainer's init
    tres = TT.train(tcfg, TT.TrainerConfig(attn_impl=impl, **kw),
                    params=tp, device="cpu")
    assert len(tres.losses) == len(jres.losses) == 8
    # fp32; 8 AdamW steps carry the summation-order differences forward
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    assert tres.final_loss == tres.losses[-1]
    assert tres.steady_steps_per_s > 0 and tres.compile_time_s > 0
    assert "step     6" in capsys.readouterr().out


def test_trainer_sync_path_metrics_and_refusals():
    from repro_torch.core.energy.devices import get_device
    from repro_torch.core.energy.monitor import ComponentModel, EnergyMonitor
    _, tcfg = train_configs(*TRAIN_ARCHS[0])
    kw = dict(steps=3, batch=2, seq_len=16, log_every=2)
    reg = MetricsRegistry()
    mon = EnergyMonitor(ComponentModel.for_device(get_device("cloud-h100")))
    sync = TT.train(tcfg, TT.TrainerConfig(**kw), monitor=mon, metrics=reg,
                    device="cpu")
    asyn = TT.train(tcfg, TT.TrainerConfig(prefetch=False, **kw),
                    metrics=MetricsRegistry(), device="cpu")
    np.testing.assert_allclose(sync.losses, asyn.losses, rtol=1e-6)
    assert len(mon.samples) == 3 and sync.energy_wh > 0
    assert reg.snapshot()["train/loss"]["count"] == 3
    assert reg.snapshot()["train/tokens"]["value"] == 3 * 2 * 16
    # checkpointing runs (resume parity is in test_torch_checkpoint.py),
    # placement-sliced saves too (test_torch_elastic.py)
    import tempfile
    from repro_torch.checkpoint import ckpt
    with tempfile.TemporaryDirectory() as d:
        TT.train(tcfg, TT.TrainerConfig(checkpoint_dir=d, checkpoint_every=3,
                                        **kw), device="cpu")
        assert ckpt.latest_complete_step(d) == 3
    from repro_torch.checkpoint import CheckpointSpec
    with tempfile.TemporaryDirectory() as d:
        TT.train(tcfg, TT.TrainerConfig(
            checkpoint_dir=d, checkpoint_every=3, checkpoint_replication=1,
            checkpoint_placement=CheckpointSpec(tcfg.num_layers,
                                                (0, 1, tcfg.num_layers)),
            **kw), device="cpu")
        assert ckpt.latest_complete_step(d) == 3
        assert ckpt._read_manifest(ckpt._step_dir(d, 3))["replication"] == 1
    tp = TM_params(tcfg)
    with pytest.raises(ValueError, match="params must live on"):
        TT.train(tcfg, TT.TrainerConfig(**kw),
                 params=tree_map(lambda a: a.to("meta"), tp), device="cpu")


def test_device_accumulator_drains_in_one_fetch():
    reg = MetricsRegistry()
    acc = DeviceAccumulator(reg)
    acc.observe("h", torch.tensor(1.5))
    acc.inc("c", torch.tensor(2.0))
    acc.observe("h", 3.0)
    acc.observe("h", torch.tensor([4.0]))
    assert len(acc) == 4
    assert acc.drain() == [1.5, 2.0, 3.0, 4.0]
    assert len(acc) == 0 and acc.drain() == []
    snap = reg.snapshot()
    assert snap["h"]["count"] == 3 and snap["h"]["max"] == 4.0
    assert snap["c"]["value"] == 2.0
    assert fetch_scalars([1, torch.tensor(2.5, dtype=torch.bfloat16)]) == \
        [1.0, 2.5]


def test_data_pipeline_gives_the_jax_batches():
    jcfg, tcfg = jax_config("opt-125m"), torch_config("opt-125m")
    jb, tb = j_batches(jcfg, 3, 40, seed=5), t_batches(tcfg, 3, 40, seed=5)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["opt-1.3b", "opt-125m", "qwen2-7b"])
def test_flop_model_matches_jax(arch):
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    for remat in (False, True):
        assert TF.train_flops(tcfg, 4, 2048, remat) == \
            JF.train_flops(jcfg, 4, 2048, remat)
    assert TF.fwd_flops(tcfg, 2, 512) == JF.fwd_flops(jcfg, 2, 512)
    assert TF._attn_flops_per_seq(tcfg, 777, causal=False) == \
        JF._attn_flops_per_seq(jcfg, 777, causal=False)


def test_opt_1_3b_full_width_param_count():
    cfg = torch_config("opt-1.3b")
    assert cfg.param_count() == 1_315_524_608
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab_size) == \
        (24, 2048, 32, 64, 8192, 50304)


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    mets, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    train.main(["--torch-device", "cpu", "--steps", "3", "--batch", "2",
                "--seq", "16", "--metrics-out", str(mets),
                "--trace-out", str(trace)])
    text = capsys.readouterr().out
    assert "opt-125m-smoke" in text and "attn=kernel" in text
    assert "final loss" in text and "gCO2e" in text
    lines = [json.loads(l) for l in mets.read_text().splitlines()]
    names = {l.get("name") for l in lines}
    assert {"train/step_s", "train/loss", "train/data_s", "train/fwd_bwd_s",
            "train/adamw_s"} <= names
    assert json.loads(trace.read_text())["traceEvents"]
