"""The production mesh's execution (``repro_torch.distributed.spmd`` on a
``(data, model)`` DeviceMesh of CPU gloo ranks: parameters and batch as
DTensors placed by ``distributed.sharding``, the activation constraints
of ``distributed.act_sharding``, the FA-2 wrappers on each rank's heads)
against the JAX package.

The JAX package's own sharded runs fail on the installed jax
(``tests/test_act_sharding.py``, ``tests/test_hlo_analysis.py``), so the
oracle is what they compute on one device: ``forward_train``,
``jax.grad`` of it and ``make_train_step``.  Bars: the loss at 2e-5 (the
JAX test's sharded-attention bar), every gathered gradient leaf at the
train parity bar (rtol 1e-4, atol 1e-6, inside the kernels' 1e-3
gradient bar), the three MoE layouts against each other at 1e-6 (the
JAX MoE layout test's bar) and the launcher's 3-step trajectory at rtol
1e-4.  Each mesh is spawned once, module-scoped, and runs every case on
it; every rank runs one torch thread.

The 2 x 2 spawn also runs one step of ``make_train_step`` with 2
microbatches, ``remat="full"`` and chunked attention (against the JAX
step of the same options on one device: loss and grad norm at the loss
bar, the updated weights at the gradient bar), and the plain step of
``opt-1.3b-smoke`` and ``qwen2-7b-smoke`` whose collectives, counted by
``runtime.Collectives`` on the ranks, must equal the dry run's count
(``launch.step_analysis.StepCounter``) of the same step on a fake 2 x 2
group: both count through ``runtime.CollectiveCount``.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn as t_batches  # noqa: E402
from repro_torch.distributed import act_sharding as A  # noqa: E402
from repro_torch.distributed import runtime, spmd  # noqa: E402
from repro_torch.configs.registry import InputShape  # noqa: E402
from repro_torch.kernels.flash_attention.chunked import tp_kv_layout  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import step_analysis as SA  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

from test_torch_helpers import one_torch_thread  # noqa: E402,F401

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LAYOUT_TOL = dict(rtol=1e-6, atol=1e-6)
TRAJ_RTOL = 1e-4
LAYOUTS = ("auto", "ep_full", "unconstrained")
# (case, smoke arch, MoE layout, mesh)
# (the ssm cases scan each rank's rows and heads, act_sharding.scan_parallel;
# jamba mixes ssm, attention and MoE sublayers in one group)
CASES = [("opt", "opt-125m", None, (2, 2))] + [
    (f"mixtral-{lay}", "mixtral-8x7b", lay, (2, 2)) for lay in LAYOUTS] + [
    ("mamba2", "mamba2-130m", None, (2, 2)),
    ("jamba", "jamba-v0.1-52b", None, (2, 2)),
    ("qwen2-vl", "qwen2-vl-2b", None, (1, 4))]
B, S = 4, 16


def configs(arch, layout=None):
    """(JAX, port) smoke configs in fp32, field for field equal."""
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(jax_config(arch + "-smoke"), **fp32)
    tcfg = dataclasses.replace(torch_config(arch + "-smoke"), **fp32)
    if layout is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, layout=layout))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, layout=layout))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def np_batch(tcfg):
    """The data pipeline's batch (the VLM's with its vision prefix and
    (3, B, S) positions), the first labels of row 0 masked so the data
    ranks count different numbers of valid labels."""
    nb = dict(next(t_batches(tcfg, B, S, 1)))
    nb["labels"] = nb["labels"].copy()
    nb["labels"][0, :5] = -1
    return nb


@functools.lru_cache(maxsize=None)
def case(cid):
    """(JAX loss, JAX grads by keystr path, port weights, batch)."""
    _, arch, layout, _ = next(c for c in CASES if c[0] == cid)
    jcfg, tcfg = configs(arch, layout)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    npw = jax.tree.map(np.asarray, jp)
    nb = np_batch(tcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b, attn_impl="chunked")[0]))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    ref = dict(bridge.flatten(jax.tree.map(np.asarray, grads)))
    return float(loss), ref, bridge.params_from_numpy(npw, tcfg, "cpu"), nb


TRAJ = dict(steps=3, batch=4, seq=32)
OPT = dict(learning_rate=3e-4, warmup_steps=10, decay_steps=3)
# the microbatched, rematerialised step with chunked attention
MICRO = dict(microbatches=2, remat="full", attn_impl="chunked")
# the plain step whose collectives the dry run counts, and its batch
COUNTED = ("opt-1.3b", "qwen2-7b")
CB, CS = 4, 32


def counted_batch(cfg):
    rs = np.random.RandomState(5)
    return {k: rs.randint(0, cfg.vocab_size, (CB, CS)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def spawned():
    """One spawn a mesh: every case's loss with its gathered gradients;
    on 2 x 2 also the microbatched step (under "micro") and the counted
    steps (under "count-<arch>")."""
    out = {}
    for mesh in sorted({c[3] for c in CASES}):
        cids = [c[0] for c in CASES if c[3] == mesh]
        calls = []
        for cid in cids:
            _, arch, layout, _ = next(c for c in CASES if c[0] == cid)
            _, tcfg = configs(arch, layout)
            _, _, tp, nb = case(cid)
            calls.append(functools.partial(
                spmd.evaluate, cfg=tcfg, batch=nb, params=tp, grads=True))
        extra = []
        if mesh == (2, 2):
            _, tcfg = configs("opt-125m")
            _, _, tp, nb = case("opt")
            extra.append("micro")
            calls.append(functools.partial(
                spmd.step, cfg=tcfg, opt_cfg=TA.OptConfig(**OPT), batch=nb,
                params=tp, **MICRO))
            for arch in COUNTED:
                cfg = torch_config(arch + "-smoke")
                extra.append(f"count-{arch}")
                calls.append(functools.partial(
                    spmd.step, cfg=cfg, opt_cfg=TA.OptConfig(),
                    batch=counted_batch(cfg), attn_impl="chunked"))
        # the 2 x 2 mesh through the host transport, 1 x 4 through gloo
        res = runtime.spawn(calls, shape=mesh, names=("data", "model"),
                            transport="host" if mesh == (2, 2) else "gloo",
                            device="cpu")
        for cid, values, launches in zip(cids, res.values, res.launches):
            _, arch, layout, _ = next(c for c in CASES if c[0] == cid)
            full = spmd.join_shards(values, configs(arch, layout)[1], mesh,
                                    ("data", "model"))
            out[cid] = (values, launches, full)
        for key, values in zip(extra, res.values[len(cids):]):
            out[key] = values
    return out


def launch(*flags):
    """``launch/train.py --mesh 2,2 --host-devices 4`` on CPU ranks, the
    smoke opt-125m in fp32 (the ranks get the config from the parent)."""
    from repro_torch.launch import train
    _, tcfg = configs("opt-125m")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("repro_torch.configs.get_config", lambda name: tcfg)
        res = train.main(["--torch-device", "cpu", "--mesh", "2,2",
                          "--host-devices", "4",
                          "--steps", str(TRAJ["steps"]),
                          "--batch", str(TRAJ["batch"]),
                          "--seq", str(TRAJ["seq"]), *flags])
    return tcfg, res


@pytest.fixture(scope="module")
def launched():
    return launch()


@pytest.fixture(scope="module")
def launched_micro():
    return launch("--microbatches", "2", "--remat", "full", "--attn-impl",
                  "chunked")


# --------------------------------------------------------------------------- #
# Loss and gradients against the single-device JAX forward_train
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_mesh_loss_and_grads_match_jax(spawned, cid):
    jloss, ref, _, _ = case(cid)
    values, launches, full = spawned[cid]
    assert [v["loss"] for v in values] == [values[0]["loss"]] * 4
    np.testing.assert_allclose(values[0]["loss"], jloss, **LOSS_TOL)
    got = dict(bridge.flatten(full))
    assert set(got) == set(ref)
    for key, r in ref.items():
        np.testing.assert_allclose(got[key].numpy(), r, **GRAD_TOL,
                                   err_msg=key)
    assert launches == {"flash_attention_fwd": 0,      # plain on the CPU
                        "flash_attention_bwd_dq": 0,
                        "flash_attention_bwd_dkdv": 0}


def test_moe_layouts_agree_with_each_other(spawned):
    base, _, base_full = spawned["mixtral-auto"]
    for lay in LAYOUTS[1:]:
        other, _, full = spawned[f"mixtral-{lay}"]
        np.testing.assert_allclose(other[0]["loss"], base[0]["loss"],
                                   **LAYOUT_TOL)
        got = dict(bridge.flatten(full))
        for key, r in bridge.flatten(base_full):
            np.testing.assert_allclose(got[key].numpy(), r.numpy(),
                                       **LAYOUT_TOL, err_msg=(lay, key))


def test_launcher_trajectory_matches_jax_train_step(launched):
    """3 steps of the launcher's --mesh run from the port's
    ``init_params(seed=0)`` and batches, against ``make_train_step`` of the
    JAX package on the same weights, batches and the trainer's AdamW."""
    tcfg, res = launched
    jcfg, _ = configs("opt-125m")
    runs = res.values[0]
    assert [tuple(r.coordinate) for r in runs] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    for run in runs:                        # every rank reports the same
        assert run.losses == runs[0].losses
        assert run.grad_norms == runs[0].grad_norms
        assert len(run.collective_ms) == TRAJ["steps"]
        assert run.collective_calls[0]["all-gather"] > 0
    losses, norms = jax_trajectory(tcfg, jcfg)
    np.testing.assert_allclose(runs[0].losses, losses, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(runs[0].grad_norms, norms, rtol=TRAJ_RTOL)


def jax_trajectory(tcfg, jcfg, **step_kw):
    """Losses and grad norms of ``TRAJ["steps"]`` steps of the JAX
    ``make_train_step`` (``step_kw`` its options) from the port's
    ``init_params(seed=0)`` on the port's batches of seed 0."""
    opt = dict(learning_rate=3e-4, warmup_steps=10,
               decay_steps=TRAJ["steps"])
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(
        TP.init_params(tcfg, device="cpu", seed=0)))
    jstep = jax.jit(JS.make_train_step(jcfg, JA.OptConfig(**opt),
                                       **step_kw))
    jopt = JA.init_opt_state(jp, JA.OptConfig(**opt))
    data = t_batches(tcfg, TRAJ["batch"], TRAJ["seq"], 0)
    losses, norms = [], []
    for _ in range(TRAJ["steps"]):
        jp, jopt, m = jstep(jp, jopt, {k: jnp.asarray(v)
                                       for k, v in next(data).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def test_launcher_runs_microbatches_remat_and_chunked_on_the_mesh(
        launched_micro):
    """``--mesh 2,2 --microbatches 2 --remat full --attn-impl chunked``:
    3 steps against the JAX ``make_train_step(..., microbatches=2,
    remat="full")`` from the same weights and batches."""
    tcfg, res = launched_micro
    jcfg, _ = configs("opt-125m")
    runs = res.values[0]
    for run in runs:
        assert run.losses == runs[0].losses
    losses, norms = jax_trajectory(tcfg, jcfg, microbatches=2, remat="full")
    np.testing.assert_allclose(runs[0].losses, losses, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(runs[0].grad_norms, norms, rtol=TRAJ_RTOL)


def test_microbatched_remat_chunked_step_matches_jax_train_step(spawned):
    """One step of 2 microbatches, ``remat="full"``, chunked attention on
    2 x 2 against the JAX ``make_train_step`` with the same options on
    one device.  Row 0's masked labels make the microbatches' token
    counts differ, so a split that grouped other rows than JAX's
    ``reshape(2, B/2)`` would change the loss."""
    values = spawned["micro"]
    jcfg, tcfg = configs("opt-125m")
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    _, _, _, nb = case("opt")
    oc = JA.OptConfig(**OPT)
    jp2, _, m = jax.jit(JS.make_train_step(
        jcfg, oc, microbatches=2, remat="full"))(
        jp, JA.init_opt_state(jp, oc),
        {k: jnp.asarray(v) for k, v in nb.items()})
    assert [v["loss"] for v in values] == [values[0]["loss"]] * 4
    np.testing.assert_allclose(values[0]["loss"], float(m["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(values[0]["grad_norm"],
                               float(m["grad_norm"]), **LOSS_TOL)
    got = dict(bridge.flatten(spmd.join_shards(values, tcfg, (2, 2),
                                               ("data", "model"))))
    for key, want in bridge.flatten(jax.tree.map(np.asarray, jp2)):
        np.testing.assert_allclose(got[key].numpy(), want, **GRAD_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("arch", COUNTED)
def test_dry_run_counts_the_collectives_of_the_gloo_step(spawned, arch):
    """The dry run's collectives of the plain step on a fake 2 x 2 group
    equal those the four gloo ranks moved in the same step, calls and
    result bytes by kind, both counted by ``runtime.CollectiveCount``."""
    values = spawned[f"count-{arch}"]
    for v in values[1:]:
        assert v["collectives"] == values[0]["collectives"]
    cfg = torch_config(arch + "-smoke")
    with LM.fake_mesh((2, 2), ("data", "model")) as mesh:
        t = DR.trace_case(cfg, InputShape("gate", CS, CB, "train"), mesh,
                          remat="none", microbatches=1)
    fake = SA.collective_totals(t["counter"])
    assert fake == values[0]["collectives"]
    assert set(fake["counts"]) == {"all-gather", "all-reduce",
                                   "reduce-scatter"}


# --------------------------------------------------------------------------- #
# The pieces: constraints, the K/V layout, the launcher's refusals
# --------------------------------------------------------------------------- #

def test_constrain_and_axis_extent_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert A.current_mesh() is None
    assert A.constrain(x, A.BATCH, None, "model") is x
    assert A.constrain(x, A.REPLICATED) is x
    assert A.axis_extent("model") == A.axis_extent("data") == 1
    fake = SimpleNamespace(mesh_dim_names=("data", "model"),
                           size=lambda i: (2, 4)[i])
    with A.use_mesh(fake):
        assert A.axis_extent("model") == 4 and A.axis_extent("pod") == 1
        assert A.constrain(x, A.BATCH, None, "model") is x   # plain tensor
    assert A.current_mesh() is None


@pytest.mark.parametrize("H,K,tp,expands", [(4, 2, 4, True),
                                            (8, 2, 8, True),
                                            (32, 8, 16, True),
                                            (28, 4, 2, False),
                                            (8, 1, 2, False),
                                            (4, 2, 1, False),
                                            (6, 2, 4, False)])
def test_tp_kv_layout_repeats_kv_as_jax(H, K, tp, expands):
    """The JAX package's rule (chunked.py:184): expand K/V to H heads when
    H divides the model extent and neither K nor the group does; query
    head h still reads K/V head h // g."""
    k = torch.randn(2, 5, K, 3)
    v = torch.randn(2, 5, K, 4)
    fake = SimpleNamespace(mesh_dim_names=("data", "model"),
                           size=lambda i: (1, tp)[i])
    with A.use_mesh(fake):
        k2, v2 = tp_kv_layout(H, k, v)
    if not expands:
        assert k2 is k and v2 is v
        return
    g = H // K
    assert k2.shape == (2, 5, H, 3) and v2.shape == (2, 5, H, 4)
    for h in range(H):
        assert torch.equal(k2[:, :, h], k[:, :, h // g])
        assert torch.equal(v2[:, :, h], v[:, :, h // g])


def test_qwen2_vl_smoke_on_1x4_takes_the_expansion():
    cfg = torch_config("qwen2-vl-2b-smoke")
    H, K, tp = cfg.num_heads, cfg.num_kv_heads, 4
    g = H // K
    assert (H, K) == (4, 2)
    assert H % tp == 0 and K % tp and g % tp


def test_launcher_refuses_what_the_mesh_does_not_run():
    from repro_torch.launch import train
    base = ["--torch-device", "cpu", "--mesh", "2,2"]
    with pytest.raises(ValueError, match="differs from the 4 ranks"):
        train.main(base + ["--host-devices", "2"])
    with pytest.raises(ValueError, match="takes D or D,M"):
        train.main(["--torch-device", "cpu", "--mesh", "2,2,2"])


def test_spawn_takes_a_mesh_or_the_edge_mesh():
    call = functools.partial(spmd.evaluate, cfg=None, batch={})
    with pytest.raises(ValueError, match="either stages"):
        runtime.spawn([call], transport="gloo", device="cpu")
    with pytest.raises(ValueError, match="either stages"):
        runtime.spawn([call], stages=2, shape=(1, 2), transport="gloo",
                      device="cpu")
    with pytest.raises(ValueError, match="needs 2 axis names"):
        runtime.spawn([call], shape=(1, 2), names=("data",),
                      transport="gloo", device="cpu")
    # never a crash: DTensor's collectives on the card go through "host",
    # and the edge mesh sends its own
    with pytest.raises(ValueError, match="needs transport='host'"):
        runtime.spawn([call], shape=(2, 2), names=("data", "model"),
                      transport="gloo", device="cuda")
    with pytest.raises(ValueError, match="edge mesh sends its own"):
        runtime.spawn([call], stages=2, transport="host", device="cpu")
    assert runtime.TRANSPORTS == ("gloo", "host")


def test_serve_launcher_takes_host_devices(capsys):
    """As the JAX serve launcher: the flag is accepted and sets no mesh."""
    from repro_torch.launch import serve
    serve.main(["--torch-device", "cpu", "--host-devices", "4", "--batch",
                "2", "--max-new", "4"])
    assert "[serve]" in capsys.readouterr().out
    assert A.current_mesh() is None
