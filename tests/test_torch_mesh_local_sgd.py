"""The port's trainer and DiLoCo local-SGD loop under a ``(data, model)``
mesh of CPU gloo ranks (``distributed.spmd.{train,local_sgd}`` and the
launcher's ``--mesh`` rank call), against the JAX package.

The JAX package's own sharded runs fail on the installed jax
(``tests/test_act_sharding.py``), so the oracle is the single-device JAX
run, on bridged ``opt-125m-smoke`` weights in fp32 with chunked attention
on both sides, at the bars of ``tests/test_torch_local_sgd.py``: losses
at rtol 1e-4 (1e-3 with int8 sync, where an element whose last bits
differ may take the other int8 code), parameters at rtol 1e-4 / atol
1e-6.  The JAX loop returns no parameters, so its final global
parameters and outer momentum are read back from its round-2
checkpoint.  One module-scoped 2 x 2 spawn (``host`` transport) runs
every case; every rank runs one torch thread.

At the smoke widths most leaves do not keep the int8 blocks whole on a
rank (``d_model`` 256 split in two gives runs of 128), so the int8 cases
run the gather-whole branch of ``optim.compress``; opt-1.3b's widths keep
every leaf's blocks whole on 2 x 2 and 1 x 4
(:func:`test_int8_blocks_stay_whole_at_opt_1_3b_widths`).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as JC  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.energy.devices import LAPTOP_M2PRO as J_LAPTOP  # noqa: E402
from repro.core.faultinject import FaultPlan as JPlan  # noqa: E402
from repro.core.net import NetParams as JNet  # noqa: E402
from repro.core.net import Topology as JTopo  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim.compress import CompressConfig as JCC  # noqa: E402
from repro.train import local_sgd as JL  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt as TC  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core.energy.devices import LAPTOP_M2PRO  # noqa: E402
from repro_torch.core.faultinject import FaultPlan  # noqa: E402
from repro_torch.core.net import NetParams, Topology  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.distributed import runtime, sharding, spmd  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.obs.validate import validate  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compress as TCP  # noqa: E402
from repro_torch.train import local_sgd as TL  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import one_torch_thread  # noqa: E402,F401

MESH, NAMES = (2, 2), ("data", "model")
LOSS_RTOL = {"none": 1e-4, "int8": 1e-3}
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# with int8 sync, an int8 code that flips where the summation order
# differs moves the mean pseudo-gradient by up to one step of its block's
# scale a round; the outer step carries it into the parameters
# (outer_lr (1 + mu + mu**2)) and the momentum (1 + mu), both under
# 1 + mu + mu**2 = 2.71; two rounds (``chip_smoke.INT8_FLIP``)
INT8_FLIP = 2 * (1 + 0.9 + 0.81)
KW = dict(batch=2, seq_len=32, log_every=0, seed=0)
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=8)
REGIONS = ["europe", "north_america"]
# the key bias's gradient is zero in exact arithmetic (it adds q . b to
# every score of a query row, which the softmax cancels): what AdamW makes
# of its rounding noise differs with the summation order, so its values
# are not compared
NOISE = "['bk']"
# a plan that straggles, crashes and flaps (the JAX faults test's seed 16)
PLAN = dict(seed=16, straggler_frac=0.5, crash_prob=0.4, link_flap_prob=0.3)
SYNC = dict(replicas=2, inner_steps=2)
ASYNC = dict(replicas=3, inner_steps=2, async_mode=True, quorum=2,
             staleness_bound=1)
# the launcher's flags for the records runs (trainer, then local SGD)
FLAGS = {"train": ["--steps", "4", "--batch", "2", "--seq", "32",
                   "--attn-impl", "chunked", "--checkpoint-every", "2"],
         "local": ["--local-sgd", "--async", "--replicas", "3",
                   "--quorum", "2", "--staleness-bound", "1",
                   "--inner-steps", "2", "--steps", "8", "--batch", "2",
                   "--seq", "32", "--attn-impl", "chunked",
                   "--fault-seed", "16", "--straggler-frac", "0.5",
                   "--crash-prob", "0.4"]}


def configs():
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(jax_config("opt-125m-smoke"), **fp32)
    tcfg = dataclasses.replace(torch_config("opt-125m-smoke"), **fp32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


JCFG, TCFG = configs()


def bridged():
    jp = JP.init_params(JCFG, jax.random.PRNGKey(0))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jp), TCFG,
                                    "cpu")


def topologies():
    return (JTopo.from_specs([J_LAPTOP] * 2, regions=REGIONS,
                             params=JNet(wan_bw_Bps=4e6)),
            Topology.from_specs([LAPTOP_M2PRO] * 2, regions=REGIONS,
                                params=NetParams(wan_bw_Bps=4e6)))


def ls_pair(comp="none", **kw):
    return (JL.LocalSGDConfig(compress=JCC(method=comp), **kw),
            TL.LocalSGDConfig(compress=TCP.CompressConfig(method=comp),
                              **kw))


def records_args(kind, d, mesh):
    """The launcher's flags for a records run writing into ``d``."""
    out = [f"--{k}-out" for k in ("trace", "metrics", "health")]
    paths = [f"{d}/{kind}{'-mesh' if mesh else ''}.{x}"
             for x in ("trace.json", "metrics.jsonl", "health.jsonl")]
    argv = ["--torch-device", "cpu", *FLAGS[kind],
            *[a for pair in zip(out, paths) for a in pair],
            "--slo", "tokens_per_s=1"]
    if kind == "train":
        argv += ["--checkpoint-dir", f"{d}/ckpt{'-mesh' if mesh else ''}"]
    return argv, paths


def grad_tree(seed, ties=False):
    """A seeded tree shaped like the parameters; with ``ties`` its values
    take few magnitudes, so top-k's threshold is tied many times."""
    rs = np.random.RandomState(seed)
    shapes = TP.tree_map(lambda p: tuple(p.shape),
                         TP.abstract_params(TCFG))

    def one(shape):
        x = rs.standard_normal(shape).astype(np.float32)
        return np.round(x * 2) / 2 if ties else x * 1e-3
    return TP.tree_map(lambda s: one(s), shapes)


def compress_on_mesh(mesh, *, grads, error, ccfg, device=None):
    """On a rank: ``compress_grads`` of ``grads`` with ``error`` (full
    numpy trees shaped like the parameters) placed on the mesh as the
    parameters: {"shards": the rank's blocks of the values as sent,
    "error": of the new error feedback, both on the CPU, "coordinate"}
    (``spmd.join_shards`` joins them)."""
    from repro_torch.distributed.act_sharding import use_mesh
    with use_mesh(mesh):
        g, e = (TT._placed(TCFG, TP.tree_map(
            lambda x: torch.from_numpy(x).to(device), t))
            for t in (grads, error))
        sent, err = TCP.compress_grads(g, e, ccfg)

    def local(tree):
        return TP.tree_map(lambda t: t.to_local().cpu(), tree)
    return {"shards": local(sent), "error": local(err),
            "coordinate": list(mesh.get_coordinate())}


def save_on_mesh(mesh, *, directory, tree, device=None):
    """On a rank: ``ckpt.save`` of ``tree`` (full numpy leaves shaped
    like the parameters) placed on the mesh as the parameters; returns
    the DTensor collectives the save issued, calls by kind."""
    from repro_torch.distributed.act_sharding import use_mesh
    with use_mesh(mesh):
        placed = TT._placed(TCFG, TP.tree_map(
            lambda x: torch.from_numpy(x).to(device), tree))
        coll = runtime.collectives()
        coll.reset()
        TC.save(directory, 1, placed)
    return dict(coll.calls)


# every case the 2 x 2 spawn runs: name -> call
def calls(tmp):
    tp = bridged()
    _, ttopo = topologies()
    tc = functools.partial(TT.TrainerConfig, attn_impl="chunked", **KW)
    opt = TA.OptConfig(**OPT)
    out = {}
    for comp in ("none", "int8"):
        _, ls = ls_pair(comp, **SYNC)
        if comp == "int8":
            ls = dataclasses.replace(ls, checkpoint_dir=f"{tmp}/int8",
                                     checkpoint_every_rounds=1)
        out[f"sync-{comp}"] = functools.partial(
            spmd.local_sgd, cfg=TCFG, tc=tc(steps=4), ls=ls, opt_cfg=opt,
            params=tp, topology=ttopo)
    _, ls = ls_pair("none", **SYNC)
    out["async-equal"] = functools.partial(
        spmd.local_sgd, cfg=TCFG, tc=tc(steps=4),
        ls=dataclasses.replace(ls, async_mode=True), opt_cfg=opt,
        params=tp, topology=ttopo)
    _, ls = ls_pair("none", **ASYNC)
    out["async-faults"] = functools.partial(
        spmd.local_sgd, cfg=TCFG, tc=tc(steps=8), ls=ls, opt_cfg=opt,
        params=tp, fault_plan=FaultPlan(**PLAN))
    for method, ties in (("int8", False), ("topk", True)):
        out[f"compress-{method}"] = functools.partial(
            compress_on_mesh, grads=grad_tree(1, ties),
            error=grad_tree(2, ties), ccfg=TCP.CompressConfig(
                method=method, topk_fraction=0.05))
    out["save-host"] = functools.partial(
        save_on_mesh, directory=f"{tmp}/save-host", tree=grad_tree(3))
    for kind in FLAGS:
        argv, _ = records_args(kind, tmp, mesh=True)
        out[f"records-{kind}"] = functools.partial(
            launcher.run_rank, args=launcher.parse_args(argv), cfg=TCFG)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{case: (each rank's value, int8 launches by rank)} of one 2 x 2
    spawn, and the directory its checkpoints and records went to."""
    tmp = tmp_path_factory.mktemp("mesh_local_sgd")
    cases = calls(tmp)
    res = runtime.spawn(list(cases.values()), shape=MESH, names=NAMES,
                        transport="host", device="cpu")
    out = {name: (values, q8) for name, values, q8 in
           zip(cases, res.values, res.quant8)}
    return out, tmp


@functools.lru_cache(maxsize=None)
def jax_run(comp, **kw):
    jls, _ = ls_pair(comp, **kw)
    extra = {}
    if kw.get("async_mode"):
        extra["fault_plan"] = JPlan(**PLAN)
        steps = 8
    else:
        extra["topology"] = topologies()[0]
        steps = 4
    return JL.train_local_sgd(
        JCFG, JT.TrainerConfig(steps=steps, attn_impl="chunked", **KW), jls,
        JA.OptConfig(**OPT), **extra)


def joined(values):
    return {k: dict(bridge.flatten(v)) for k, v in
            spmd.join_state(values, TCFG, MESH, NAMES).items()}


# --------------------------------------------------------------------------- #
# Local SGD against the single-device JAX loop
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_sync(tmp_path_factory):
    """{comp: (JAX ``train_local_sgd``'s sync result, its final
    {"params", "outer_m"} as numpy leaves by path)}: the JAX loop returns
    no parameters, so they are read back from its round-2 checkpoint."""
    out = {}
    for comp in ("none", "int8"):
        d = str(tmp_path_factory.mktemp(f"jax-{comp}"))
        res = jax_run(comp, checkpoint_dir=d, checkpoint_every_rounds=1,
                      **SYNC)
        jp = JP.init_params(JCFG, jax.random.PRNGKey(0))
        state = JC.restore(d, {"params": jp, "outer_m": jp}, step=2)
        out[comp] = (res, {k: dict(bridge.flatten(jax.tree.map(np.asarray,
                                                               v)))
                           for k, v in state.items()})
    return out


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_mesh_sync_local_sgd_matches_jax(spawned, jax_sync, comp):
    values, q8 = spawned[0][f"sync-{comp}"]
    res = values[0].result
    jres, _ = jax_sync[comp]
    assert res.rounds == jres.rounds == 2 and res.mode == "sync"
    np.testing.assert_allclose(res.losses, jres.losses,
                               rtol=LOSS_RTOL[comp])
    np.testing.assert_allclose(res.round_losses, jres.round_losses,
                               rtol=LOSS_RTOL[comp])
    # priced from the global shapes, as one process prices them
    for f in ("sync_wire_bytes_per_round", "comm_time_s_per_round",
              "sync_wan_bytes_per_round", "virtual_time_s",
              "inner_steps_total"):
        assert getattr(res, f) == getattr(jres, f), f
    assert q8 == [{"quantize_blocks": 0, "dequantize_blocks": 0}] * 4


@functools.lru_cache(maxsize=None)
def block_scales():
    """Each element's int8 step by leaf path: the scale of its 256-block
    (of the leaf's row-major flattening) of replica 0's round-1
    pseudo-gradient, recomputed from the same weights and stream."""
    from repro_torch.train.step import make_train_step
    opt = TA.OptConfig(**OPT)
    glob = bridged()
    work = TP.tree_map(lambda t: t.clone(), glob)
    step = make_train_step(TCFG, opt, attn_impl="chunked")
    state = TA.init_opt_state(work, opt)
    data = make_batch_fn(TCFG, KW["batch"], KW["seq_len"], KW["seed"])
    for _ in range(SYNC["inner_steps"]):
        work, state, _ = step(work, state, TT._to_device(
            next(data), torch.device("cpu")))
    out = {}
    for (key, g), (_, w) in zip(bridge.flatten(glob), bridge.flatten(work)):
        d = (g - w).detach().reshape(-1)
        blocks = torch.nn.functional.pad(d, (0, -d.numel() % 256))
        scale = blocks.reshape(-1, 256).abs().amax(1) * (1 / 127)
        out[key] = scale.repeat_interleave(256)[:d.numel()] \
            .reshape(g.shape).numpy()
    return out


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_mesh_outer_state_matches_jax(spawned, jax_sync, comp):
    """The final global parameters and outer momentum, joined from the
    ranks' blocks, against JAX's (read back from its checkpoint), leaf by
    leaf.  With int8 sync every element is within rtol 1e-4 / atol 1e-6
    plus ``INT8_FLIP`` steps of its block's scale.  Without compression
    each leaf's error is within 1e-4 of its outer change in norm (the
    parameters' change from the initial weights, the momentum itself):
    elementwise the bar does not hold for either port path, the mesh or
    one process, since AdamW divides each gradient by its own root mean
    square and so turns the rounding of gradients that cancel to near
    zero (the attention weights') into steps of up to 4.3e-5, 36 times
    the bar, where an error of the outer step moves a whole leaf."""
    values, _ = spawned[0][f"sync-{comp}"]
    got = joined(values)
    _, want = jax_sync[comp]
    start = {k: v.numpy() for k, v in bridge.flatten(bridged())}
    scales = block_scales() if comp == "int8" else None
    for part in ("params", "outer_m"):
        assert sorted(got[part]) == sorted(want[part])
        for key, w in want[part].items():
            if NOISE in key:
                continue
            a = got[part][key].numpy()
            assert a.shape == w.shape, (part, key)
            err = np.abs(a - w)
            if scales is None:
                change = w - start[key] if part == "params" else w
                assert np.linalg.norm(err) <= PARAM_TOL["rtol"] * \
                    np.linalg.norm(change), (part, key)
            else:
                bar = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(w) \
                    + INT8_FLIP * scales[key]
                assert np.all(err <= bar), (part, key, float(err.max()))
    assert float(max(np.abs(v).max() for v in
                     want["outer_m"].values())) > 0


def test_async_quorum_all_staleness_0_equals_the_mesh_sync_run(spawned):
    sync, _ = spawned[0]["sync-none"]
    asyn, _ = spawned[0]["async-equal"]
    assert (sync[0].result.mode, asyn[0].result.mode) == ("sync", "async")
    for s, a in zip(sync, asyn):
        assert a.result.losses == s.result.losses
        assert a.result.round_losses == s.result.round_losses
        for k in ("params", "outer_m"):
            for x, y in zip(TP.tree_leaves(a.state[k]),
                            TP.tree_leaves(s.state[k])):
                assert torch.equal(x, y)


def test_async_under_a_fault_plan_matches_jax(spawned):
    values, _ = spawned[0]["async-faults"]
    res = values[0].result
    jres = jax_run("none", **ASYNC)
    for f in ("outer_updates", "dropped_stale", "late_merged", "resyncs",
              "crashes", "fault_counts", "virtual_time_s", "per_replica_k",
              "inner_steps_total", "contributed_steps", "rounds"):
        assert getattr(res, f) == getattr(jres, f), f
    assert res.crashes >= 1 and res.fault_counts.get("rejoin", 0) >= 1
    np.testing.assert_allclose(res.losses, jres.losses, rtol=1e-4)
    np.testing.assert_allclose(res.round_losses, jres.round_losses,
                               rtol=1e-4)


@pytest.mark.parametrize("case", ["sync-none", "sync-int8", "async-equal",
                                  "async-faults"])
def test_every_rank_reports_the_same_run(spawned, case):
    """The ranks take every branch alike: the same losses, clock and
    counts on each."""
    values, _ = spawned[0][case]
    first = values[0].result
    assert [tuple(v.coordinate) for v in values] == [(0, 0), (0, 1),
                                                     (1, 0), (1, 1)]
    for v in values[1:]:
        for f in ("losses", "round_losses", "virtual_time_s",
                  "outer_updates", "dropped_stale", "resyncs", "crashes",
                  "fault_counts", "sync_wire_bytes_per_round"):
            assert getattr(v.result, f) == getattr(first, f), f


# --------------------------------------------------------------------------- #
# Compression of each rank's blocks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compression_of_each_ranks_blocks_equals_one_device(spawned,
                                                            method):
    """int8 and top-k (with error feedback) of a tree placed on the mesh,
    joined from the ranks' blocks, equal ``compress_grads`` of the whole
    tree on one device exactly: the same int8 blocks and codes, top-k's
    same picks (the tree's magnitudes tie at the threshold)."""
    values, _ = spawned[0][f"compress-{method}"]
    ties = method == "topk"
    g = TP.tree_map(torch.from_numpy, grad_tree(1, ties))
    e = TP.tree_map(torch.from_numpy, grad_tree(2, ties))
    sent, err = TCP.compress_grads(g, e, TCP.CompressConfig(
        method=method, topk_fraction=0.05))
    for key, want in (("shards", sent), ("error", err)):
        got = spmd.join_shards([{"coordinate": v["coordinate"],
                                 "shards": v[key]} for v in values],
                               TCFG, MESH, NAMES)
        for (path, a), (_, b) in zip(bridge.flatten(got),
                                     bridge.flatten(want)):
            assert torch.equal(a, b), (key, path)
    if ties:
        leaf = TP.tree_leaves(g)[0].reshape(-1)
        k = max(1, int(leaf.numel() * 0.05))
        thresh = torch.topk(leaf.abs(), k).values[-1]
        assert int((leaf.abs() == thresh).sum()) > 1


def placements_of(spec, names):
    from torch.distributed.tensor import Replicate, Shard
    by = {}
    for d, part in enumerate(spec):
        for n in ((part,) if isinstance(part, str) else (part or ())):
            by[n] = d
    return [Shard(by[n]) if n in by else Replicate() for n in names]


def misaligned(cfg, mesh):
    specs = dict(bridge.flatten(sharding.param_shardings(
        cfg, sharding.AbstractMesh(mesh, NAMES))))
    shapes = dict(bridge.flatten(TP.abstract_params(cfg)))
    return sorted(k for k, spec in specs.items()
                  if not TCP.blocks_whole(tuple(shapes[k].shape),
                                          placements_of(spec, NAMES),
                                          mesh, 256))


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_int8_blocks_stay_whole_at_opt_1_3b_widths(mesh):
    """Every opt-1.3b leaf quantizes on the rank's own block (no gather),
    at the smoke widths most leaves do not (the gather-whole branch)."""
    assert misaligned(torch_config("opt-1.3b"), mesh) == []
    smoke = misaligned(TCFG, mesh)
    assert len(smoke) >= 5
    assert ("['decoder']['g0']['s1_mlp']['wi']" in smoke) == (mesh == (1, 4))


# --------------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------------- #

def test_local_sgd_checkpoint_of_the_mesh_restores_in_either_package(
        spawned):
    """The int8 run's round-2 checkpoint, one leaf-modulo shard a rank,
    restored by one process of either package: the joined final state,
    bit for bit."""
    values, _ = spawned[0]["sync-int8"]
    d = spawned[1] / "int8"
    want = spmd.join_state(values, TCFG, MESH, NAMES)
    assert TC.latest_complete_step(d) == JC.latest_complete_step(d) == 2
    m = json.loads((d / "step_00000002" / "manifest_3.json").read_text())
    assert (m["num_shards"], m["shard_id"]) == (4, 3)
    got = TC.restore(d, want)
    jgot = JC.restore(d, jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: t.numpy(), want)))
    for (path, a), b, c in zip(bridge.flatten(want), TP.tree_leaves(got),
                               jax.tree.leaves(jgot)):
        assert torch.equal(a, b), path
        np.testing.assert_array_equal(a.numpy(), np.asarray(c),
                                      err_msg=path)


@pytest.mark.parametrize("transport", ["host", "gloo"])
def test_mesh_save_gathers_each_leaf_for_its_writer(spawned, transport,
                                                    tmp_path_factory):
    """A placed tree saved on 2 x 2, restored bit for bit by one process.
    Over the ``host`` transport each leaf's blocks meet in host memory on
    its writer, with no DTensor collective; over ``gloo`` (no host
    slots; a 1 x 2 mesh, two processes) DTensor's ``full_tensor`` gathers
    the leaf on every rank, an all-gather or more for each sharded
    leaf."""
    if transport == "host":
        mesh = MESH
        calls, d = spawned[0]["save-host"][0], spawned[1] / "save-host"
    else:
        mesh = (1, 2)
        d = tmp_path_factory.mktemp("save-gloo")
        calls = runtime.spawn(
            [functools.partial(save_on_mesh, directory=str(d),
                               tree=grad_tree(3))],
            shape=mesh, names=NAMES, transport="gloo",
            device="cpu").values[0]
    tree = TP.tree_map(torch.from_numpy, grad_tree(3))
    got = TC.restore(d, tree)
    for (path, a), b in zip(bridge.flatten(tree), TP.tree_leaves(got)):
        assert torch.equal(a, b), path
    specs = TP.tree_leaves(sharding.param_shardings(
        TCFG, sharding.AbstractMesh(mesh, NAMES)))
    from torch.distributed.tensor import Shard
    sharded = sum(any(isinstance(p, Shard) and n > 1 for p, n in
                      zip(placements_of(spec, NAMES), mesh))
                  for spec in specs)
    assert sharded >= 5
    gathers = [c.get("all-gather", 0) for c in calls]
    if transport == "host":
        assert gathers == [0] * 4
    else:
        assert min(gathers) >= sharded


def jax_trainer(steps, start=None):
    """(params, opt state, losses) of ``steps`` JAX ``make_train_step``
    steps on the port's batches of seed 0 with the launcher's AdamW, from
    the port's ``init_params(seed=0)`` or from ``start``."""
    oc = JA.OptConfig(learning_rate=3e-4, warmup_steps=10, decay_steps=4)
    if start is None:
        jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(
            TP.init_params(TCFG, device="cpu", seed=0)))
        jopt = JA.init_opt_state(jp, oc)
    else:
        jp, jopt = start
    jstep = jax.jit(JS.make_train_step(JCFG, oc))
    data = make_batch_fn(TCFG, 2, 32, 0)
    losses = []
    for _ in range(steps):
        jp, jopt, m = jstep(jp, jopt, {k: jnp.asarray(v)
                                       for k, v in next(data).items()})
        losses.append(float(m["loss"]))
    return jp, jopt, losses


def jax_like(steps):
    jp, jopt, _ = jax_trainer(steps)
    return {"params": jp, "opt": jopt}


def test_mesh_trainer_checkpoint_read_by_jax_holds_the_jax_state(spawned):
    """``--mesh 2,2 --checkpoint-dir``: the step-4 checkpoint, read by
    the JAX package's ``restore``, against 4 steps of the JAX train step
    from the same weights and batches."""
    values, _ = spawned[0]["records-train"]
    d = spawned[1] / "ckpt-mesh"
    assert JC.latest_complete_step(d) == 4
    want = jax_like(4)
    got = JC.restore(d, want, step=4)
    assert int(got["opt"]["step"]) == 4
    for (path, a), (_, b) in zip(bridge.flatten(jax.tree.map(np.asarray,
                                                             got)),
                                 bridge.flatten(jax.tree.map(np.asarray,
                                                             want))):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if NOISE not in path:
            np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=path)
    _, _, losses = jax_trainer(4)
    np.testing.assert_allclose(values[0].losses, losses, rtol=1e-4)


def test_resume_without_a_mesh_continues_from_the_mesh_checkpoint(
        spawned, capsys):
    """One process resumes the mesh's step-4 checkpoint and takes a step:
    the JAX train step from the restored state on the same batch."""
    d = spawned[1] / "ckpt-mesh"
    oc = TA.OptConfig(learning_rate=3e-4, warmup_steps=10, decay_steps=4)
    res = TT.train(TCFG, TT.TrainerConfig(
        steps=1, attn_impl="chunked", checkpoint_dir=str(d), resume=True,
        **KW), oc, device="cpu")
    assert res.resumed_from_step == 4
    assert "resumed from step 4" in capsys.readouterr().out
    start = JC.restore(d, jax_like(4), step=4)
    _, _, losses = jax_trainer(1, start=(start["params"], start["opt"]))
    np.testing.assert_allclose(res.losses, losses, rtol=1e-4)


# --------------------------------------------------------------------------- #
# Records
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", list(FLAGS))
def test_mesh_records_validate_and_match_the_single_process(spawned, kind,
                                                            capsys):
    """The launcher's report of the mesh ranks' records (rank 0's metrics,
    health and SLO; every rank's trace, each its own process) validates,
    and its metric names and counters equal the single-process run's."""
    values, _ = spawned[0][f"records-{kind}"]
    tmp = spawned[1]
    argv, paths = records_args(kind, tmp, mesh=True)
    args = launcher.parse_args(argv)
    launcher.report(args, TCFG, values[0].result, values[0].records,
                    [v.records.tracer for v in values], "cpu")
    argv1, paths1 = records_args(kind, tmp, mesh=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("repro_torch.configs.get_config", lambda name: TCFG)
        launcher.main(argv1)
    capsys.readouterr()
    for p in paths + paths1:
        validate(p)
    trace = json.loads(open(paths[0]).read())["traceEvents"]
    procs = sorted(e["args"]["name"] for e in trace
                   if e["name"] == "process_name")
    assert procs == [f"train:{TCFG.name}:rank{r}" for r in range(4)]
    assert {e["pid"] for e in trace} == {1, 2, 3, 4}

    def metrics(path):
        out = {}
        for line in open(path):
            r = json.loads(line)
            if r["record"] == "metric":
                out[r["name"]] = r
        return out
    mesh, one = metrics(paths[1]), metrics(paths1[1])
    assert sorted(mesh) == sorted(one)
    for name, r in one.items():
        if r["type"] == "counter":
            assert mesh[name]["value"] == r["value"], name
        elif name.endswith("loss"):
            assert mesh[name]["count"] == r["count"], name
    if kind == "local":
        faults = {e["name"] for e in trace if e["name"].startswith("fault.")}
        assert {"fault.crash", "fault.rejoin", "fault.straggle"} <= faults
        for v in values[1:]:
            assert v.result.fault_counts == values[0].result.fault_counts
