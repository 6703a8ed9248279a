"""The DT-FM pipeline executor (``repro_torch.distributed.pipeline``)
against the JAX package, on the CPU, with gloo ranks.

The JAX pipeline itself fails on the installed jax (``tests/test_pipeline.py``:
``ShardingTypeError`` slicing its stage-sharded stack), so the oracle is
what it computes: the single-device ``forward_train``, ``jax.grad`` of it
and ``make_train_step``.  Bars: the staging helpers exactly; the
pipelined loss at ``LOSS_RTOL`` 1e-5 and every gradient leaf, gathered to
rank 0 and joined in stage order, at ``GRAD_TOL`` (the train parity bars, fp32 on
both sides, sums in other orders); 6 train steps on a 2 x 2 mesh at rtol
1e-4, losses and final parameters (the trainer parity bar); the JAX
pipeline test's own learning criterion.  Each mesh is spawned once, in a
module-scoped fixture, and every rank runs one torch thread.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.opt import opt_config as j_opt  # noqa: E402
from repro.core.energy import devices as JD  # noqa: E402
from repro.core.placement import ordered_placement as j_ordered  # noqa: E402
from repro.data.pipeline import make_batch_fn as j_batches  # noqa: E402
from repro.distributed import pipeline as JPL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.opt import opt_config as t_opt  # noqa: E402
from repro_torch.core.energy import devices as TD  # noqa: E402
from repro_torch.core.placement import ordered_placement  # noqa: E402
from repro_torch.distributed import pipeline as P  # noqa: E402
from repro_torch.distributed import runtime  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

from test_torch_helpers import bridged  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_train import GRAD_TOL, LOSS_RTOL  # noqa: E402


def tiny_configs(layers=4, fp32=True):
    """The JAX pipeline test's tiny OPT (tests/test_pipeline.py:30-34) in
    both packages, fp32 unless asked otherwise."""
    kw = dict(name="opt-pipe-test", num_layers=layers, d_model=128,
              num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
              vocab_size=512)
    if fp32:
        kw.update(param_dtype="float32", compute_dtype="float32")
    j = dataclasses.replace(j_opt("opt-125m"), **kw)
    t = dataclasses.replace(t_opt("opt-125m"), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def np_batch(cfg, B=4, S=16, seed=1, masked=5):
    """Random tokens with the first labels of row 0 masked, so the data
    ranks count different numbers of valid labels."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :masked] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


# (case id, layers, (data, stage) mesh, boundaries)
GRAD_CASES = [("tiny-1x2", 4, (1, 2), None),
              ("tiny-2x2", 4, (2, 2), None),
              ("L8-1x3-036", 8, (1, 3), [0, 3, 6, 8]),
              ("L8-1x2-05", 8, (1, 2), [0, 5, 8])]
MICROBATCHES = 2
TRAJ_OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=6, eps=1e-3)
TRAJ_STEPS, TRAJ_B, TRAJ_S = 6, 4, 32
LEARN_OPT = dict(learning_rate=1e-3, warmup_steps=5, decay_steps=40)
LEARN_STEPS = 25


@functools.lru_cache(maxsize=None)
def weights(layers):
    """JAX init_params(PRNGKey(0)) of the fp32 config, and the same as
    port tensors."""
    return bridged(*tiny_configs(layers))


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(layers):
    jcfg, _ = tiny_configs(layers)
    jp, _ = weights(layers)
    nb = np_batch(jcfg)
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})


@pytest.fixture(scope="module")
def spawned():
    """One spawn per mesh: every gradient case on it (a pipelined
    loss and gradient, then the forward alone), and on the 2 x 2 mesh the
    6-step trajectory from the bridged weights and the 25-step learning
    run of the JAX pipeline test (bf16, the port's own init)."""
    out = {}
    meshes = sorted({mesh for _, _, mesh, _ in GRAD_CASES})
    for mesh in meshes:
        calls, keys = [], []
        for cid, layers, m, bounds in GRAD_CASES:
            if m != mesh:
                continue
            _, tcfg = tiny_configs(layers)
            kw = dict(cfg=tcfg, batch=np_batch(tcfg),
                      num_microbatches=MICROBATCHES, boundaries=bounds,
                      params=weights(layers)[1])
            calls += [functools.partial(P.evaluate, grads=True, **kw),
                      functools.partial(P.evaluate, **kw)]
            keys += [(cid, "grads"), (cid, "loss")]
        if mesh == (2, 2):
            _, tcfg = tiny_configs()
            calls.append(functools.partial(
                P.train, cfg=tcfg, opt_cfg=TA.OptConfig(**TRAJ_OPT),
                steps=TRAJ_STEPS, batch=TRAJ_B, seq_len=TRAJ_S,
                num_microbatches=MICROBATCHES, params=weights(4)[1],
                gather=True))
            keys.append(("trajectory", None))
            _, bcfg = tiny_configs(fp32=False)
            calls.append(functools.partial(
                P.train, cfg=bcfg, opt_cfg=TA.OptConfig(**LEARN_OPT),
                steps=LEARN_STEPS, batch=4, seq_len=32,
                num_microbatches=MICROBATCHES, seed=0))
            keys.append(("learning", None))
        res = runtime.spawn(calls, data=mesh[0], stages=mesh[1],
                            transport="gloo", device="cpu")
        for key, values, launches in zip(keys, res.values, res.launches):
            out[key] = (values, launches)
    return out


# --------------------------------------------------------------------------- #
# The staging helpers, exactly
# --------------------------------------------------------------------------- #

BOUNDS = [2, 4, 8, [0, 3, 6, 8], [0, 5, 8], [0, 1, 2, 7, 8]]


@pytest.mark.parametrize("stages", BOUNDS, ids=str)
def test_staging_helpers_equal_jax(stages):
    jcfg, tcfg = tiny_configs(8)
    jb = JPL.resolve_boundaries(jcfg, stages)
    assert P.resolve_boundaries(tcfg, stages) == jb
    assert P.stage_slices(jb) == JPL.stage_slices(jb)
    assert P.stage_counts(jb) == JPL.stage_counts(jb) \
        == P._stage_counts(jb)
    np.testing.assert_array_equal(P.stage_layer_mask(tcfg, stages).numpy(),
                                  np.asarray(JPL.stage_layer_mask(jcfg,
                                                                  stages)))
    assert P.stage_layer_mask(tcfg, stages).dtype == torch.bool
    jp, tp = weights(8)
    jst = JPL.stack_for_stages(jcfg, jp, stages)
    tst = P.stack_for_stages(tcfg, tp, stages)
    for key, ref in bridge.flatten(jax.tree.map(np.asarray, jst)):
        np.testing.assert_array_equal(dict(bridge.flatten(tst))[key].numpy(),
                                      ref, err_msg=key)
    back = dict(bridge.flatten(P.unstack_stages(tcfg, tst, stages)))
    for key, ref in bridge.flatten(jax.tree.map(
            np.asarray, JPL.unstack_stages(jcfg, jst, stages))):
        np.testing.assert_array_equal(back[key].numpy(), ref, err_msg=key)
        np.testing.assert_array_equal(
            back[key].numpy(),
            dict(bridge.flatten(tp["decoder"]["g0"]))[key].numpy())
    if isinstance(stages, int):          # the legacy uniform round trip
        legacy = dict(bridge.flatten(P.unstack_stages(tcfg, tst)))
        for key, ref in bridge.flatten(jax.tree.map(
                np.asarray, JPL.unstack_stages(jcfg, jst))):
            np.testing.assert_array_equal(legacy[key].numpy(), ref)


def test_resolve_boundaries_takes_a_placement_and_raises_as_jax():
    jcfg, tcfg = tiny_configs(8)
    jspec = j_ordered(jcfg, [JD.LAPTOP_M2PRO, JD.LAPTOP_M2PRO,
                             JD.SMARTPHONE_SD888])
    tspec = ordered_placement(tcfg, [TD.LAPTOP_M2PRO, TD.LAPTOP_M2PRO,
                                     TD.SMARTPHONE_SD888])
    assert P.resolve_boundaries(tcfg, tspec) == \
        JPL.resolve_boundaries(jcfg, jspec) == tspec.boundaries
    for bad in (3, [0, 4], [1, 8], [0, 5, 5, 8], [0, 6, 3, 8]):
        with pytest.raises(ValueError) as jerr:
            JPL.resolve_boundaries(jcfg, bad)
        with pytest.raises(ValueError) as terr:
            P.resolve_boundaries(tcfg, bad)
        assert str(terr.value) == str(jerr.value)


def test_checkpoint_spec_shares_the_boundary_math_without_the_executor():
    """The checkpoint spec and the executor slice layers with the same
    functions, and importing the spec loads neither the executor nor the
    runtime above it."""
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.checkpoint import spec
    assert spec.stage_slices is P.stage_slices
    assert spec.stage_counts is P.stage_counts
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys; import repro_torch.checkpoint.spec; "
            "print(sorted(m for m in sys.modules if m in "
            "('repro_torch.distributed.pipeline', "
            "'repro_torch.distributed.runtime')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(src), "PATH": ""}).stdout
    assert out.strip() == "[]", out


def test_stage_count_mismatch_and_other_families_raise():
    _, tcfg = tiny_configs(8)
    mesh = SimpleNamespace(shape=(1, 2), mesh_dim_names=("data", "stage"))
    with pytest.raises(ValueError, match="define 3 stages but the mesh "
                                         "'stage' axis has 2"):
        P.make_pipeline_loss(tcfg, mesh, num_microbatches=2,
                             boundaries=[0, 3, 6, 8])
    with pytest.raises(ValueError, match="do not split uniformly"):
        P.make_pipeline_loss(dataclasses.replace(tcfg, num_layers=7), mesh,
                             num_microbatches=2)
    from repro_torch.configs import get_config
    with pytest.raises(ValueError, match="uniform dense decoders"):
        P.make_pipeline_loss(get_config("mamba2-130m-smoke"), mesh,
                             num_microbatches=2)


# --------------------------------------------------------------------------- #
# Loss and gradients against the single-device JAX forward_train
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cid,layers,mesh,bounds", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_pipeline_loss_and_grads_match_jax(spawned, cid, layers, mesh,
                                           bounds):
    jloss, jgrads = jax_loss_and_grads(layers)
    values, launches = spawned[(cid, "grads")]
    assert [v["loss"] for v in values] == [values[0]["loss"]] * len(values)
    np.testing.assert_allclose(values[0]["loss"], float(jloss),
                               rtol=LOSS_RTOL)
    forward_only = [v["loss"] for v in spawned[(cid, "loss")][0]]
    np.testing.assert_allclose(forward_only, [float(jloss)] * len(values),
                               rtol=LOSS_RTOL)
    assert all("grads" not in v for v in values[1:])
    got = dict(bridge.flatten(values[0]["grads"]))
    ref = dict(bridge.flatten(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(ref)
    for key, r in ref.items():
        np.testing.assert_allclose(got[key].numpy(), r, **GRAD_TOL,
                                   err_msg=key)
    assert launches == {"flash_attention_fwd": 0,      # plain on the CPU
                        "flash_attention_bwd_dq": 0,
                        "flash_attention_bwd_dkdv": 0}


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #

def test_six_steps_on_2x2_match_jax_train_step(spawned):
    jcfg, tcfg = tiny_configs()
    jp, _ = weights(4)
    jstep = jax.jit(JS.make_train_step(jcfg, JA.OptConfig(**TRAJ_OPT)))
    jopt = JA.init_opt_state(jp, JA.OptConfig(**TRAJ_OPT))
    data = j_batches(jcfg, TRAJ_B, TRAJ_S, seed=0)
    jlosses, jnorms = [], []
    for _ in range(TRAJ_STEPS):
        jp, jopt, m = jstep(jp, jopt, {k: jnp.asarray(v)
                                       for k, v in next(data).items()})
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    runs = spawned[("trajectory", None)][0]
    for run in runs:                    # every rank reports the same
        assert run.losses == runs[0].losses
        assert run.grad_norms == runs[0].grad_norms
    np.testing.assert_allclose(runs[0].losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(runs[0].grad_norms, jnorms, rtol=1e-4)
    assert [r.layers for r in runs] == [(0, 2), (2, 4), (0, 2), (2, 4)]
    assert all(r.params is None for r in runs[1:])
    got = dict(bridge.flatten(runs[0].params))
    for key, ref in bridge.flatten(jax.tree.map(np.asarray, jp)):
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_pipeline_trains_as_the_jax_test_asks(spawned):
    runs = spawned[("learning", None)][0]
    losses = runs[0].losses
    assert len(losses) == LEARN_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert all(len(r.wall_ms) == LEARN_STEPS and not r.event_ms
               and r.copies == [0] * LEARN_STEPS for r in runs)


# --------------------------------------------------------------------------- #
# The runtime: transports, devices, failures
# --------------------------------------------------------------------------- #

def test_runtime_refuses_what_it_cannot_run(monkeypatch):
    _, tcfg = tiny_configs()
    call = functools.partial(P.evaluate, cfg=tcfg, batch=np_batch(tcfg),
                             num_microbatches=2)
    with pytest.raises(ValueError, match="not one of"):
        runtime.spawn([call], stages=2, transport="mpi", device="cpu")
    # nccl needs a card a rank: it waits for the multi-card slice
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        runtime.spawn([call], stages=2, transport="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.spawn([call], stages=2, transport="gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P._rank_params(tcfg, (0, 2), 0, None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        runtime.spawn([call], stages=2, transport="nccl")
    for make in (TMesh.make_production_mesh, TMesh.make_host_mesh,
                 lambda: TMesh.make_edge_mesh(2, 1)):
        with pytest.raises(RuntimeError, match="initialised process group"):
            make()
    # over a one-rank group: the host mesh is built, the production mesh
    # names the world size it needs
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(f"{d}/s", 1),
                                rank=0, world_size=1)
        try:
            host = TMesh.make_host_mesh(device_type="cpu")
            assert host.mesh_dim_names == ("data",) and host.size() == 1
            with pytest.raises(ValueError, match="needs 256 ranks; the "
                                                 "group has 1"):
                TMesh.make_production_mesh(device_type="cpu")
            with pytest.raises(ValueError, match="needs 512 ranks"):
                TMesh.make_production_mesh(multi_pod=True,
                                           device_type="cpu")
        finally:
            dist.destroy_process_group()


def test_a_rank_that_raises_fails_the_run():
    _, tcfg = tiny_configs()
    call = functools.partial(P.evaluate, cfg=tcfg,
                             batch=np_batch(tcfg, B=3),
                             num_microbatches=2)
    with pytest.raises(Exception, match="does not split into 1 data ranks "
                                        "x 2 microbatches"):
        runtime.spawn([call], stages=2, transport="gloo", device="cpu")
