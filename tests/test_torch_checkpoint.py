"""Checkpoints across the two packages: the port restores what the JAX
package wrote (leaf-modulo, sharded, and the JAX package's layer-sliced
elastic layout) and the JAX package restores what the port wrote, bit
for bit with bf16 leaves; CRC corruption, incomplete steps and pruning;
and trainer and local-SGD resume from either package's checkpoints
against the JAX package's own resume."""

import json
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointSpec  # noqa: E402
from repro.checkpoint import ckpt as JC  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import local_sgd as JL  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt as TC  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import local_sgd as TL  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import bridged  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_train import TRAIN_ARCHS, train_configs  # noqa: E402

L = 4


def bf16_configs():
    """A small opt-125m in its own bf16 params, in both packages."""
    red = dict(num_layers=L, d_model=32, vocab_size=64)
    return (jax_config("opt-125m").reduced(**red),
            torch_config("opt-125m").reduced(**red))


def jax_state(seed=0):
    jcfg, _ = bf16_configs()
    params = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    opt = JA.init_opt_state(params, JA.OptConfig())
    opt["step"] = opt["step"] + 7
    return {"params": params, "opt": opt}


def port_state(seed=1):
    _, tcfg = bf16_configs()
    params = TP.init_params(tcfg, device="cpu", seed=seed)
    opt = TA.init_opt_state(params, TA.OptConfig())
    opt["mu"] = TP.tree_map(lambda m: torch.randn_like(m), opt["mu"])
    opt["step"] = opt["step"] + 3
    return {"params": params, "opt": opt}


def bits(x):
    """Leaf -> numpy array whose equality is bit equality."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x) \
            .numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.kind == "V" else a


def assert_bitexact(port_tree, jax_tree):
    mine = dict(bridge.flatten(port_tree))
    ref = dict(bridge.flatten(jax.tree.map(np.asarray, jax_tree)))
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(bits(mine[k]), bits(ref[k]),
                                      err_msg=k)
        assert bits(mine[k]).dtype == bits(ref[k]).dtype, k


def port_like(jstate):
    """Port tensors of the JAX state's layout (values irrelevant)."""
    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return bridge._to_tensor(np.zeros_like(np.asarray(node)), "cpu")
    return build(jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("layout", ["leaf-modulo", "two-shards",
                                    "layer-sliced"])
def test_port_restores_what_jax_wrote_bitexact(layout, tmp_path):
    st = jax_state()
    if layout == "leaf-modulo":
        JC.save(tmp_path, 5, st)
    elif layout == "two-shards":
        for sid in range(2):
            JC.save(tmp_path, 5, st, num_shards=2, shard_id=sid)
    else:
        JC.save_for_placement(tmp_path, 5,
                              st, CheckpointSpec(L, (0, 1, 3, L),
                                                 replication=1))
        assert len(list((tmp_path / "step_00000005").glob("*.L*"))) > 0
    assert TC.latest_complete_step(tmp_path) == 5
    got = TC.restore(tmp_path, port_like(st))
    assert got["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32 and \
        int(got["opt"]["step"]) == 7
    assert_bitexact(got, st)


@pytest.mark.parametrize("shards", [1, 2])
def test_jax_restores_what_the_port_wrote_bitexact(shards, tmp_path):
    st = port_state()
    for sid in range(shards):
        TC.save(tmp_path, 3, st, num_shards=shards, shard_id=sid)
    assert JC.latest_complete_step(tmp_path) == 3
    got = JC.restore(tmp_path, jax_state(seed=4))
    assert_bitexact(st, got)
    assert int(got["opt"]["step"]) == 3


def test_both_packages_write_the_same_files(tmp_path):
    st = jax_state()
    JC.save(tmp_path / "jax", 2, st)
    TC.save(tmp_path / "port", 2, TC.restore(tmp_path / "jax",
                                             port_like(st)))
    a, b = tmp_path / "jax" / "step_00000002", \
        tmp_path / "port" / "step_00000002"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _corrupt_payload(path):
    data = bytearray(path.read_bytes())
    data[-1] ^= 0x5A                          # past the npy header
    path.write_bytes(bytes(data))


def test_crc_corruption_raises(tmp_path):
    st = port_state()
    TC.save(tmp_path, 1, st)
    d = tmp_path / "step_00000001"
    target = d / TC._leaf_name("['params']['final_norm']['scale']")
    _corrupt_payload(target)
    crc = json.loads((d / "manifest_0.json").read_text())["checksums"][
        target.name]
    with pytest.raises(TC.ShardChecksumError, match="CRC32"):
        TC._load_array(target, crc=crc, policy=TC.RestorePolicy())
    with pytest.raises(TC.ShardReadError, match="final_norm"):
        TC.restore(tmp_path, st)
    with pytest.raises(JC.ShardReadError):     # the JAX package agrees
        JC.restore(tmp_path, jax_state())
    # without verification the (rotten) bytes load
    TC.restore(tmp_path, st, policy=TC.RestorePolicy(verify_checksums=False))


def test_incomplete_step_raises_and_restore_falls_back(tmp_path):
    st = port_state()
    TC.save(tmp_path, 1, st)
    TC.save(tmp_path, 2, st)
    TC.save(tmp_path / "neighbour", 2, st)
    (tmp_path / "step_00000002" /
     TC._leaf_name("['opt']['step']")).unlink()
    with pytest.raises(TC.IncompleteCheckpointError, match="opt.*step"):
        TC.restore(tmp_path, st, step=2)
    assert TC.latest_step(tmp_path) == 2
    assert TC.complete_steps(tmp_path) == [1]
    assert TC.latest_complete_step(tmp_path) == \
        JC.latest_complete_step(tmp_path) == 1
    got = TC.restore(tmp_path, st)              # the newest complete step
    assert_bitexact(got, jax.tree.map(np.asarray, bridge.params_to_numpy(
        st)))
    with pytest.raises(ValueError, match="tree structure"):
        TC.restore(tmp_path, {"params": st["params"]})
    # a neighbour's copy heals the missing file (sources=)
    rep = TC.HealReport()
    got = TC.restore(tmp_path, st, step=2,
                     sources=[tmp_path / "neighbour"], heal_report=rep)
    assert [h["reason"] for h in rep.healed] == ["missing"]
    assert TC.complete_steps(tmp_path) == [1, 2]
    assert_bitexact(got, jax.tree.map(np.asarray, bridge.params_to_numpy(
        st)))


def test_prune_keeps_the_newest_complete_steps(tmp_path):
    st = {"w": torch.arange(4.0)}
    for s in range(5):
        TC.save(tmp_path, s, st)
    for s in (0, 4):                  # a dead partial write, an in-flight one
        (tmp_path / f"step_{s:08d}" / TC._leaf_name("['w']")).unlink()
    TC.prune(tmp_path, keep=2)
    assert TC._all_steps(tmp_path) == [2, 3, 4]
    assert TC.complete_steps(tmp_path) == [2, 3]
    empty = tmp_path / "none"
    empty.mkdir()
    TC.prune(empty)                   # nothing restorable: keeps all
    assert TC.latest_step(empty) is None


def test_trainer_resume_matches_jax_resume(tmp_path):
    jcfg, tcfg = train_configs(*TRAIN_ARCHS[0])
    kw = dict(batch=2, seq_len=32, log_every=0, seed=0)
    base = tmp_path / "jax"
    JT.train(jcfg, JT.TrainerConfig(steps=4, checkpoint_every=2,
                                    checkpoint_dir=str(base),
                                    attn_impl="chunked", **kw))
    shutil.copytree(base, tmp_path / "port")
    resume = dict(steps=2, checkpoint_every=2, resume=True,
                  attn_impl="chunked", **kw)
    jres = JT.train(jcfg, JT.TrainerConfig(checkpoint_dir=str(base),
                                           **resume))
    _, tp = bridged(jcfg, tcfg, seed=5)          # overwritten on resume
    tres = TT.train(tcfg, TT.TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **resume), params=tp,
        device="cpu")
    assert tres.resumed_from_step == jres.resumed_from_step == 4
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    # the port's step-6 checkpoint restores in the JAX package, and its
    # optimizer carried on from the saved step
    jstate = {"params": JP.init_params(jcfg, jax.random.PRNGKey(0)),
              "opt": JA.init_opt_state(JP.init_params(
                  jcfg, jax.random.PRNGKey(0)), JA.OptConfig())}
    theirs = JC.restore(tmp_path / "port", jstate, step=6)
    assert int(theirs["opt"]["step"]) == 6
    ref = dict(bridge.flatten(jax.tree.map(np.asarray, JC.restore(
        base, jstate, step=6)["params"])))
    for key, a in bridge.flatten(jax.tree.map(np.asarray,
                                              theirs["params"])):
        if key.endswith("['bk']"):
            # a gradient that is zero in exact arithmetic: AdamW turns
            # both packages' rounding noise into steps of up to the lr
            assert np.abs(a - ref[key]).max() <= 2 * 2 * 3e-4
        else:
            np.testing.assert_allclose(a, ref[key], rtol=1e-4, atol=1e-6,
                                       err_msg=key)
    assert TC.latest_complete_step(tmp_path / "port") == 6
    # checkpoint_placement saves layer-sliced (its resume parity is in
    # tests/test_torch_elastic.py)
    from repro_torch.checkpoint import CheckpointSpec as TCS
    TT.train(tcfg, TT.TrainerConfig(
        steps=1, checkpoint_every=1, checkpoint_dir=str(tmp_path / "lay"),
        checkpoint_placement=TCS(tcfg.num_layers, (0, 1, tcfg.num_layers)),
        **kw), device="cpu")
    m = TC._read_manifest(TC._step_dir(tmp_path / "lay", 1))
    assert m["layout"] == "layer_sliced" and m["boundaries"] == [0, 1, 2]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_local_sgd_resume_matches_jax_resume(writer, tmp_path):
    jcfg, tcfg = train_configs(*TRAIN_ARCHS[0])
    tc = dict(steps=4, batch=2, seq_len=32, log_every=0, seed=1,
              attn_impl="chunked")
    ls = dict(replicas=2, inner_steps=2, checkpoint_every_rounds=1)
    first = tmp_path / "first"
    if writer == "jax":
        JL.train_local_sgd(jcfg, JT.TrainerConfig(**tc), JL.LocalSGDConfig(
            checkpoint_dir=str(first), **ls))
    else:
        _, tp = bridged(jcfg, tcfg, seed=1)
        res = TL.train_local_sgd(tcfg, TT.TrainerConfig(**tc),
                                 TL.LocalSGDConfig(checkpoint_dir=str(first),
                                                   **ls),
                                 params=tp, device="cpu")
        # what was saved is the run's final outer state, bit for bit
        saved = TC.restore(first, res.outer_state)
        for a, b in zip(TP.tree_leaves(saved),
                        TP.tree_leaves(res.outer_state)):
            assert torch.equal(a, b)
        assert float(saved["outer_m"]["embed"]["tok"].abs().max()) > 0
    assert TC.latest_complete_step(first) == 2
    shutil.copytree(first, tmp_path / "second")
    jres = JL.train_local_sgd(jcfg, JT.TrainerConfig(**tc),
                              JL.LocalSGDConfig(checkpoint_dir=str(first),
                                                resume=True, **ls))
    _, tp = bridged(jcfg, tcfg, seed=1)
    tres = TL.train_local_sgd(
        tcfg, TT.TrainerConfig(**tc),
        TL.LocalSGDConfig(checkpoint_dir=str(tmp_path / "second"),
                          resume=True, **ls), params=tp, device="cpu")
    assert tres.resumed_from_round == jres.resumed_from_round == 2
    assert TC.latest_complete_step(tmp_path / "second") == 4
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    np.testing.assert_allclose(tres.round_losses, jres.round_losses,
                               rtol=1e-4)
