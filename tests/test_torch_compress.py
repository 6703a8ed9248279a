"""Gradient compression: the port's ``compress_grads`` (int8 through the
quant8 kernels' plain versions on the CPU, and top-k; error feedback on
and off; a None error state) against the JAX package's leaf for leaf, the
error-feedback contract, the wire-byte counts, and the train step's
``compress`` hook against the JAX step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels.quant8 import ops as q8  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compress as TC  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

from test_torch_helpers import bridged, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_train import (GRAD_TOL, TRAIN_ARCHS,  # noqa: E402
                              np_batch, train_configs)

# leaves whose flat sizes give regular, ragged and one-row block counts
SHAPES = {"a": {"w": (37, 129)}, "b": (1024,), "c": (3, 5, 7),
          "d": (256, 256)}


def grads(seed):
    rs = np.random.RandomState(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return (rs.randn(*node) * 0.01).astype(np.float32)
    return build(SHAPES)


def to_torch(tree):
    return None if tree is None else jax.tree.map(t, tree)


def to_jax(tree):
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


# called eagerly, as the JAX local-SGD loop calls it (its quant8 kernels
# are jitted inside); jitting the whole call would let XLA fuse
# gf - q * s into one fused multiply-add and round the error differently
_jax_compress = JC.compress_grads

CASES = [("int8", True), ("int8", False), ("topk", True), ("topk", False)]


@pytest.mark.parametrize("with_error", [False, True],
                         ids=["error-none", "error-given"])
@pytest.mark.parametrize("method,ef", CASES,
                         ids=["int8-ef", "int8", "topk-ef", "topk"])
def test_compress_grads_equals_jax_leaf_for_leaf(method, ef, with_error):
    g = grads(0)
    err = grads(1) if with_error else None
    jcfg = JC.CompressConfig(method=method, topk_fraction=0.05,
                             error_feedback=ef)
    tcfg = TC.CompressConfig(method=method, topk_fraction=0.05,
                             error_feedback=ef)
    jsent, jerr = _jax_compress(to_jax(g), to_jax(err), jcfg)
    tsent, terr = TC.compress_grads(to_torch(g), to_torch(err), tcfg)
    flat_j = dict(bridge.flatten(jax.tree.map(np.asarray, jsent)))
    for key, mine in bridge.flatten(tsent):
        np.testing.assert_array_equal(mine.numpy(), flat_j[key],
                                      err_msg=key)
    if not ef:
        assert jerr is None and terr is None
        return
    flat_e = dict(bridge.flatten(jax.tree.map(np.asarray, jerr)))
    for key, mine in bridge.flatten(terr):
        np.testing.assert_array_equal(mine.numpy(), flat_e[key],
                                      err_msg=key)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_error_feedback_sent_plus_error_reconstructs_the_input(method):
    g, e = to_torch(grads(2)), to_torch(grads(3))
    cfg = TC.CompressConfig(method=method)
    sent, new_e = TC.compress_grads(g, e, cfg)
    for gi, ei, si, ni in zip(*(tree_leaves(x) for x in (g, e, sent,
                                                         new_e))):
        assert si.dtype == gi.dtype and ni.dtype == torch.float32
        torch.testing.assert_close(si + ni, gi + ei, rtol=1e-6, atol=1e-9)
    # the list form gives the same leaves
    lsent, lerr = TC.compress_grads(tree_leaves(g), tree_leaves(e), cfg)
    assert all(torch.equal(a, b) for a, b in zip(lsent, tree_leaves(sent)))
    assert all(torch.equal(a, b) for a, b in zip(lerr, tree_leaves(new_e)))


def test_none_method_is_the_identity_and_error_toggles():
    g = to_torch(grads(4))
    same, err = TC.compress_grads(g, None, TC.CompressConfig())
    assert same is g and err is None
    _, err = TC.compress_grads(g, None, TC.CompressConfig(
        method="int8", error_feedback=False))
    assert err is None
    # toggling error feedback on afterwards starts from zero residuals
    _, err2 = TC.compress_grads(g, err, TC.CompressConfig(method="int8"))
    assert tree_leaves(err2)[0].shape == tree_leaves(g)[0].shape
    z = TC.init_error(g)
    assert all(float(x.abs().max()) == 0 and x.dtype == torch.float32
               for x in tree_leaves(z))
    with pytest.raises(ValueError):
        TC.compress_grads(g, None, TC.CompressConfig(method="fp4"))


@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_wire_bytes_equal_jax(method):
    g = grads(5)
    jcfg = JC.CompressConfig(method=method, topk_fraction=0.02)
    tcfg = TC.CompressConfig(method=method, topk_fraction=0.02)
    assert TC.wire_bytes(to_torch(g), tcfg) == JC.wire_bytes(to_jax(g),
                                                             jcfg)
    bf = {"x": t(np.zeros((300,), np.float32)).bfloat16()}
    assert TC.wire_bytes(bf, tcfg) == JC.wire_bytes(
        {"x": jnp.zeros((300,), jnp.bfloat16)}, jcfg)
    for n in (1, 255, 256, 257, 1_315_524_608):
        assert TC.wire_bytes_count(n, tcfg) == JC.wire_bytes_count(n, jcfg)
        assert TC.wire_bytes_count(n, None, dtype_bytes=2) == \
            JC.wire_bytes_count(n, None, dtype_bytes=2)


# The step's gradients agree across the packages to within about 2e-4 of
# an int8 code step (opt L2/d128, fp32), and are held to GRAD_TOL.  An
# element whose gradient lies closer to a rounding boundary than the two
# packages' gradients lie apart may be rounded the other way by the other
# package: an int8 code on a half-integer, or a top-k magnitude at the
# leaf's threshold.  The band around each boundary is TIE_BAND (of a code
# step, or of the threshold), or the largest measured difference between
# the two gradients (in the element's quantization block, or the leaf for
# top-k) where that is wider: a process whose CPU fp32 exp is off by up
# to 1e-4 in its first call (seen in processes that ran JAX) moves them
# up to 8e-3 of a code step apart, still within GRAD_TOL.  Outside the
# band both packages send the same values.
TIE_BAND = 5e-3


def _tie_band(g: torch.Tensor, ref: np.ndarray, method: str,
              cfg) -> np.ndarray:
    """Elements of the port's gradient ``g`` that lie within the band of
    a rounding boundary of ``method``; ``ref`` is the JAX gradient."""
    flat = g.detach().reshape(-1).numpy()
    apart = np.abs(flat - ref.reshape(-1))
    if method == "topk":
        k = max(1, int(flat.size * cfg.topk_fraction))
        thresh = np.sort(np.abs(flat))[-k]
        near = np.abs(np.abs(flat) - thresh) <= max(TIE_BAND * thresh,
                                                    apart.max())
        return near.reshape(g.shape)
    _, s, _ = q8.quantize(g.detach(), cfg.block)
    rows = np.repeat(s.numpy(), cfg.block)[:flat.size]
    # the measured difference, the largest of each quantization block
    pad = np.zeros(-flat.size % cfg.block, apart.dtype)
    apart = np.repeat(np.concatenate([apart, pad]).reshape(
        -1, cfg.block).max(1), cfg.block)[:flat.size]
    u = flat / rows
    near = np.abs(u - np.floor(u) - 0.5) <= np.maximum(TIE_BAND,
                                                       apart / rows)
    return near.reshape(g.shape)


def _grads_both(jcfg, tcfg, jp, tp, nb):
    """The gradients of the train step's loss in each package, by key."""
    jloss = jax.jit(jax.grad(lambda p, b: JM.forward_train(
        p, jcfg, b, attn_impl="chunked")[0]))
    jg = jloss(jp, {k: jnp.asarray(v) for k, v in nb.items()})
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()},
                               attn_impl="chunked")
    tg = torch.autograd.grad(loss, leaves)
    keys = [k for k, _ in bridge.flatten(tp)]
    return dict(bridge.flatten(jax.tree.map(np.asarray, jg))), \
        dict(zip(keys, tg))


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_train_step_compress_hook_matches_jax(method):
    jcfg, tcfg = train_configs(*TRAIN_ARCHS[0])
    jp, tp = bridged(jcfg, tcfg)
    opt = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    nb = np_batch(jcfg)
    jccfg = JC.CompressConfig(method=method, topk_fraction=0.1)
    tccfg = TC.CompressConfig(method=method, topk_fraction=0.1)

    # The compressed gradients, before AdamW, against JAX's.  The key
    # bias's gradient is zero in exact arithmetic (softmax does not see a
    # per-query constant), so both packages compress rounding noise
    # there: check that it is noise, and leave its values out.
    jg, tg = _grads_both(jcfg, tcfg, jp, tp, nb)
    jsent = _jax_compress({k: jnp.asarray(v) for k, v in jg.items()},
                          None, jccfg)[0]
    tsent = TC.compress_grads(tg, None, tccfg)[0]
    biggest = max(float(g.abs().max()) for g in tg.values())
    band = {}
    for key, g in tg.items():
        if key.endswith("['bk']"):
            assert float(g.abs().max()) <= 1e-6 * biggest
            assert np.abs(jg[key]).max() <= 1e-6 * biggest
            continue
        np.testing.assert_allclose(g.detach().numpy(), jg[key], **GRAD_TOL,
                                   err_msg=key)
        band[key] = _tie_band(g, jg[key], method, tccfg)
        mine, ref = tsent[key].detach().numpy(), np.asarray(jsent[key])
        # int8 sends the same codes times scales equal to the last bits;
        # top-k sends the gradients themselves, held to the gradient bar
        tol = dict(rtol=1e-4, atol=0) if method == "int8" else GRAD_TOL
        np.testing.assert_allclose(mine[~band[key]], ref[~band[key]],
                                   err_msg=key, **tol)

    # Parameters after one step, through the hook.  The port's step is
    # eager, so its gradients are the ones above and the band holds for
    # them; outside it the parameters agree to rtol 1e-4.  In the band,
    # and at the key bias, AdamW turns a flipped or noisy value into an
    # update of up to the learning rate whatever its size: those elements
    # are held to two updates' size.
    _, tp = bridged(jcfg, tcfg)
    jstep = jax.jit(JS.make_train_step(
        jcfg, JA.OptConfig(**opt), attn_impl="chunked", compress=jccfg))
    jp2, _, jm = jstep(jp, JA.init_opt_state(jp, JA.OptConfig(**opt)),
                       {k: jnp.asarray(v) for k, v in nb.items()})
    tstep = TS.make_train_step(tcfg, TA.OptConfig(**opt),
                               attn_impl="chunked", compress=tccfg)
    tp2, _, tm = tstep(tp, TA.init_opt_state(tp, TA.OptConfig(**opt)),
                       {k: t(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    lr = opt["learning_rate"]
    flat_j = dict(bridge.flatten(jax.tree.map(np.asarray, jp2)))
    for key, mine in bridge.flatten(tp2):
        mine, ref = mine.detach().numpy(), flat_j[key]
        assert np.abs(mine - ref).max() <= 2 * lr, key
        if key in band:
            np.testing.assert_allclose(mine[~band[key]], ref[~band[key]],
                                       rtol=1e-4, atol=1e-6, err_msg=key)
    # the hook changed the update: the uncompressed step lands elsewhere
    _, tpu = bridged(jcfg, tcfg)
    plain = TS.make_train_step(tcfg, TA.OptConfig(**opt),
                               attn_impl="chunked")
    tpu, _, _ = plain(tpu, TA.init_opt_state(tpu, TA.OptConfig(**opt)),
                      {k: t(v) for k, v in nb.items()})
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(tpu), tree_leaves(tp2)))


def test_compress_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(TC.CompressConfig)] == \
        [f.name for f in dataclasses.fields(JC.CompressConfig)]
    assert dataclasses.asdict(TC.CompressConfig()) == \
        dataclasses.asdict(JC.CompressConfig())
