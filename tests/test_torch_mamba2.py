"""Mamba2 in the port against the JAX package: the parameter spec (keys,
shapes, the fp32 decay leaves, the count), the ssm sublayer's full-sequence
pass (kernel path and oracle path) and its decode step, the whole model's
``forward_logits`` and ``decode_step``, on weights bridged from the JAX
package's ``init_params`` (fp32, reduced mamba2-130m)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import mamba2 as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch.bridge import flatten, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_bhcq  # noqa: E402
from repro_torch.models import mamba2 as TMB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

from test_torch_helpers import bridged, configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

# fp32 throughout; the two packages sum in different orders (the scan's
# decays carry cumsums of up to a chunk of terms)
TOL = dict(rtol=1e-4, atol=1e-4)
# (patch, id): mamba2-130m-smoke (one B/C group, chunk 32), and two groups
# with a chunk of 16 so that a 40-token sequence ends in a ragged chunk
VARIANTS = [({}, "g1"),
            (dict(ssm=dict(n_groups=2, chunk_size=16)), "g2-c16")]


def mamba_configs(patch):
    jcfg, tcfg = configs("mamba2-130m")
    if "ssm" in patch:
        jcfg = dataclasses.replace(
            jcfg, ssm=dataclasses.replace(jcfg.ssm, **patch["ssm"]))
        tcfg = dataclasses.replace(
            tcfg, ssm=dataclasses.replace(tcfg.ssm, **patch["ssm"]))
    return jcfg, tcfg


def layer(tree, i=0):
    """Layer i's ssm parameters of the stacked group."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def test_full_config_and_param_count_agree():
    jcfg, tcfg = jax_config("mamba2-130m"), torch_config("mamba2-130m")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.param_count() == jcfg.param_count() == 128_958_912
    assert tcfg.active_param_count() == tcfg.param_count()
    assert TP.decoder_groups(tcfg) == [TP.ScanGroup(("ssm",), 24, 0)]


@pytest.mark.parametrize("name", ["mamba2-130m", "mamba2-130m-smoke"])
def test_model_spec_keys_shapes_and_fp32_leaves_match_jax(name):
    jcfg, tcfg = jax_config(name), torch_config(name)
    abstract = jax.tree_util.tree_flatten_with_path(JP.abstract_params(jcfg))
    want = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
            for p, a in abstract[0]}
    got = {}
    for key, s in flatten(TP.model_spec(tcfg)):
        dtype = "float32" if s.init in TP.FP32_INITS else tcfg.param_dtype
        got[key] = (s.shape, dtype)
    assert got == want
    assert TP.count_params(tcfg) == JP.count_params(jcfg)


def test_bridge_accepts_the_full_jax_tree_unchanged():
    """mamba2-130m's JAX parameter tree at full size (zeros of the JAX
    package's abstract shapes and dtypes): the same keystr keys, the
    (24, ...) stacked leaves of the one ("ssm",) group, bf16 weights and
    the fp32 decay leaves kept fp32."""
    jcfg, tcfg = jax_config("mamba2-130m"), torch_config("mamba2-130m")
    tree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                        JP.abstract_params(jcfg))
    tp = params_from_numpy(tree, tcfg, "cpu")
    ssm = tp["decoder"]["g0"]["s0_ssm"]
    assert ssm["wx"].shape == (24, 768, 1536)
    assert ssm["wx"].dtype == torch.bfloat16
    assert ssm["A_log"].shape == (24, 24)
    assert ssm["A_log"].dtype == ssm["dt_bias"].dtype == torch.float32
    assert sum(x.numel() for x in TP.tree_leaves(tp)) == 128_958_912


def test_bf16_init_and_bridge_keep_the_decay_leaves_fp32():
    jcfg = jax_config("mamba2-130m-smoke")
    tcfg = torch_config("mamba2-130m-smoke")
    assert tcfg.param_dtype == "bfloat16"
    tp = TP.init_params(tcfg, device="cpu", seed=0)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    bp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    for tree in (tp, bp):
        ssm = tree["decoder"]["g0"]["s0_ssm"]
        assert ssm["A_log"].dtype == torch.float32
        assert ssm["dt_bias"].dtype == torch.float32
        assert ssm["wx"].dtype == torch.bfloat16
        assert ssm["D"].dtype == torch.bfloat16
    # the torch-RNG draws follow the JAX package's distributions: A in
    # [1, 16), dt = softplus(dt_bias) in [dt_min, dt_max]
    ssm = tp["decoder"]["g0"]["s0_ssm"]
    A = torch.exp(ssm["A_log"])
    assert float(A.min()) >= 1.0 and float(A.max()) < 16.0
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert float(dt.min()) >= tcfg.ssm.dt_min * (1 - 1e-5)
    assert float(dt.max()) <= tcfg.ssm.dt_max * (1 + 1e-5)


@pytest.mark.parametrize("patch,vid", VARIANTS, ids=[v[1] for v in VARIANTS])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_forward_matches_jax(patch, vid, use_kernel):
    jcfg, tcfg = mamba_configs(patch)
    jp, tp = bridged(jcfg, tcfg)
    x = np.random.RandomState(1).randn(2, 40, jcfg.d_model).astype(
        np.float32)
    want = JMB.ssm_forward(layer(jp["decoder"]["g0"]["s0_ssm"]),
                           jnp.asarray(x), jcfg, use_kernel=use_kernel)
    before = ssd_bhcq.launches
    with torch.no_grad():
        got = TMB.ssm_forward(layer(tp["decoder"]["g0"]["s0_ssm"]), t(x),
                              tcfg, use_kernel=use_kernel)
    assert ssd_bhcq.launches == before          # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("patch,vid", VARIANTS, ids=[v[1] for v in VARIANTS])
def test_ssm_decode_matches_jax(patch, vid):
    jcfg, tcfg = mamba_configs(patch)
    jp, tp = bridged(jcfg, tcfg)
    rs = np.random.RandomState(2)
    cache = {k: rs.randn(*v.shape).astype(np.float32) for k, v in
             TMB.init_ssm_cache(tcfg, 3, device="cpu").items()}
    x = rs.randn(3, 1, jcfg.d_model).astype(np.float32)
    jy, jc = JMB.ssm_decode(layer(jp["decoder"]["g0"]["s0_ssm"]),
                            jnp.asarray(x), jcfg,
                            cache={k: jnp.asarray(v) for k, v in
                                   cache.items()})
    ty, tc = TMB.ssm_decode(layer(tp["decoder"]["g0"]["s0_ssm"]), t(x), tcfg,
                            cache={k: t(v) for k, v in cache.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tc) == set(jc)
    for k in jc:
        assert tc[k].dtype == torch.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_ssm_cache_is_fp32_whatever_the_model_dtype():
    tcfg = torch_config("mamba2-130m-smoke")
    cache = TM.init_cache(tcfg, 2, 8, dtype=torch.bfloat16, device="cpu")
    unit = cache["g0"]["s0_ssm"]
    ssm = tcfg.ssm
    nh = ssm.num_heads(tcfg.d_model)
    assert unit["state"].shape == (tcfg.num_layers, 2, nh, ssm.head_dim,
                                   ssm.d_state)
    assert unit["conv_x"].shape == (tcfg.num_layers, 2, ssm.conv_kernel - 1,
                                    ssm.d_inner(tcfg.d_model))
    assert all(v.dtype == torch.float32 for v in unit.values())


@pytest.mark.parametrize("patch,vid", VARIANTS, ids=[v[1] for v in VARIANTS])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_matches_jax(patch, vid, use_kernel):
    jcfg, tcfg = mamba_configs(patch)
    jp, tp = bridged(jcfg, tcfg)
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 40))
    want = JM.forward_logits(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = TM.forward_logits(tp, tcfg, {"tokens": t(toks)},
                            use_kernel=use_kernel)
    assert got.shape == (2, 40, jcfg.padded_vocab_size)
    pad = got[..., jcfg.vocab_size:]
    assert pad.numel() == 0 or float(pad.max()) == -1e30
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("patch,vid", VARIANTS, ids=[v[1] for v in VARIANTS])
def test_decode_step_matches_own_prefill(patch, vid):
    """tests/test_system.py's check, in the port: token-by-token decode
    through the dense cache equals the full-sequence logits (the kernel
    path's plain version here) at every position."""
    _, tcfg = mamba_configs(patch)
    tp = TP.init_params(tcfg, device="cpu", seed=0)
    B, S = 2, 37
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, tcfg.vocab_size, (B, S)))
    with torch.no_grad():
        full = TM.forward_logits(tp, tcfg, {"tokens": toks})
        cache = TM.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
        outs = []
        for i in range(S):
            lg, cache = TM.decode_step(tp, tcfg, cache, toks[:, i:i + 1], i)
            outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-4)


def test_decode_step_matches_jax_token_by_token():
    jcfg, tcfg = configs("mamba2-130m")
    jp, tp = bridged(jcfg, tcfg)
    B, S = 2, 9
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (B, S))
    jc = JM.init_cache(jcfg, B, S, jnp.float32)
    tc = TM.init_cache(tcfg, B, S, torch.float32, "cpu")
    step = jax.jit(lambda p, c, x, i: JM.decode_step(p, jcfg, c, x, i))
    for i in range(S):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        tl, tc = TM.decode_step(tp, tcfg, tc, t(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
    for (key, got), (_, want) in zip(flatten(tc), flatten(
            jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=key)


def test_training_forward_takes_the_differentiable_oracle():
    """forward_train leaves use_kernel unset, so the ssm layers run
    ssd_reference (as the JAX package does) and train; the kernel path
    refuses a gradient."""
    _, tcfg = configs("mamba2-130m")
    tp = TP.init_params(tcfg, device="cpu", seed=1)
    leaves = [p.requires_grad_(True) for p in TP.tree_leaves(tp)]
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, tcfg.vocab_size, (2, 20)))
    loss, _ = TM.forward_train(tp, tcfg, {"tokens": toks[:, :-1],
                                          "labels": toks[:, 1:]})
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(RuntimeError, match="no backward"):
        TM.forward_logits(tp, tcfg, {"tokens": toks})
