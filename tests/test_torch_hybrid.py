"""Mamba2 training and the jamba hybrid in the port against the JAX package,
on bridged weights in fp32: ``forward_train`` loss and gradients of
``mamba2-130m-smoke`` (its ssm layers train through the differentiable
``ssd_reference``, as in the JAX package), and of ``jamba-v0.1-52b-smoke``
(an SSD mixer with an MLP, then attention with no positional encoding
and a 4-expert MoE), jamba's ``forward_logits``, ``decode_step`` over its
attn + ssm + moe caches, ``greedy_generate`` ids, 8-step trainer
trajectories, ``positional`` for every non-rotary embedding, the hybrid's
layer groups and parameter counts, and both launchers on the CPU (the
bridge's jamba case is in ``tests/test_torch_port.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.serve import step as JSS  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.serve import step as TSS  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import bridged, configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_train import GRAD_TOL, LOSS_RTOL, np_batch  # noqa: E402

JAMBA = "jamba-v0.1-52b"
ARCHS = ["mamba2-130m", JAMBA]
# port impl -> the JAX impl of the same attention algorithm (mamba2 has no
# attention layer, so one impl covers it)
TRAIN_CASES = [("mamba2-130m", "chunked"), (JAMBA, "chunked"),
               (JAMBA, "kernel")]
JAX_IMPL = {"chunked": "chunked", "kernel": "pallas"}
# model-level bars of tests/test_torch_mamba2.py (fp32; the scan's decays
# carry cumsums of up to a chunk of terms)
TOL = dict(rtol=1e-4, atol=1e-4)


def grads_both(jcfg, tcfg, jp, tp, nb, impl):
    """(JAX loss, its grads by key, port loss, its grads by key)."""
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b,
                                      attn_impl=JAX_IMPL[impl])[0]))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    leaves = [p.requires_grad_(True) for p in TP.tree_leaves(tp)]
    tloss, _ = TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()},
                                attn_impl=impl)
    tg = torch.autograd.grad(tloss, leaves)
    keys = [k for k, _ in bridge.flatten(tp)]
    return (float(jloss), dict(bridge.flatten(jax.tree.map(np.asarray, jg))),
            float(tloss.detach()), dict(zip(keys, tg)))


@pytest.mark.parametrize("arch,impl", TRAIN_CASES,
                         ids=["mamba2", "jamba-chunked", "jamba-kernel"])
def test_forward_train_loss_and_grads_match_jax(arch, impl):
    """40 tokens a row: one full chunk of 32 and a ragged one."""
    jcfg, tcfg = configs(arch)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=40)
    jloss, jg, tloss, tg = grads_both(jcfg, tcfg, jp, tp, nb, impl)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert set(jg) == set(tg)
    for key, ref in jg.items():
        np.testing.assert_allclose(tg[key].numpy(), ref, **GRAD_TOL,
                                   err_msg=key)
    # every leaf trains: the ssm decay leaves and the router included
    for leaf in ("A_log", "dt_bias", "conv_x", "wdt") + (
            ("router", "wq") if arch == JAMBA else ()):
        key = next(k for k in tg if k.endswith(f"['{leaf}']"))
        assert float(tg[key].abs().max()) > 0, key


def test_jamba_aux_loss_and_its_gradient_match_jax():
    jcfg, tcfg = configs(JAMBA)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=24)
    jaux, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.forward_train(
        p, jcfg, b)[1]["aux_loss"]))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    leaves = [p.requires_grad_(True) for p in TP.tree_leaves(tp)]
    _, mets = TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()},
                               attn_impl="chunked")
    assert float(jaux) > 0
    np.testing.assert_allclose(float(mets["aux_loss"].detach()), float(jaux),
                               rtol=1e-5)
    tg = torch.autograd.grad(mets["aux_loss"], leaves, allow_unused=True)
    keys = [k for k, _ in bridge.flatten(tp)]
    flat = dict(bridge.flatten(jax.tree.map(np.asarray, jg)))
    for key, g in zip(keys, tg):
        g = np.zeros_like(flat[key]) if g is None else g.numpy()
        np.testing.assert_allclose(g, flat[key], **GRAD_TOL, err_msg=key)
    router = next(k for k in keys if k.endswith("['router']"))
    assert np.abs(flat[router]).max() > 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_jamba_forward_logits_match_jax(use_kernel):
    jcfg, tcfg = configs(JAMBA)
    jp, tp = bridged(jcfg, tcfg)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 40))
    jl = JM.forward_logits(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl = TM.forward_logits(tp, tcfg, {"tokens": t(toks)},
                               attn_impl="kernel", use_kernel=use_kernel)
    assert tl.shape == (2, 40, tcfg.padded_vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_jamba_decode_steps_match_jax_and_own_prefill():
    """Token by token through the dense attn + ssm + moe caches, against
    the JAX decode step (logits and every cache leaf) and the port's own
    full-sequence logits."""
    jcfg, tcfg = configs(JAMBA)
    jp, tp = bridged(jcfg, tcfg)
    B, S = 2, 12
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (B, S))
    jc = JM.init_cache(jcfg, B, 16, jnp.float32)
    tc = TM.init_cache(tcfg, B, 16, torch.float32, "cpu")
    assert set(tc["g0"]) == {"s0_ssm", "s1_mlp", "s2_attn", "s3_moe"}
    outs = []
    for i in range(S):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, i:i + 1]),
                                jnp.int32(i))
        with torch.no_grad():
            tl, tc = TM.decode_step(tp, tcfg, tc, t(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        outs.append(tl)
    for (key, got), (_, want) in zip(bridge.flatten(tc), bridge.flatten(
            jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=key)
    with torch.no_grad():
        full = TM.forward_logits(tp, tcfg, {"tokens": t(toks)},
                                 attn_impl="kernel")
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_jamba_greedy_generate_ids_equal_jax():
    """bf16 K/V for attention and fp32 state for ssm (the JAX package's
    dense-cache defaults), 7 prompt tokens then 6 greedy ones."""
    jcfg, tcfg = configs(JAMBA)
    jp, tp = bridged(jcfg, tcfg)
    prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 7))
    want = JSS.greedy_generate(jp, jcfg, jnp.asarray(prompt), 6)
    got = TSS.greedy_generate(tp, tcfg, t(prompt), 6)
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not TM.paged_decode_supported(tcfg)


@pytest.mark.parametrize("arch", ARCHS, ids=["mamba2", "jamba"])
def test_trainer_loss_trajectory_matches_jax_step_for_step(arch):
    jcfg, tcfg = configs(arch)
    kw = dict(steps=8, batch=2, seq_len=48, log_every=4, seed=0)
    jres = JT.train(jcfg, JT.TrainerConfig(attn_impl="chunked", **kw))
    _, tp = bridged(jcfg, tcfg, seed=0)          # the JAX trainer's init
    tres = TT.train(tcfg, TT.TrainerConfig(attn_impl="kernel", **kw),
                    params=tp, device="cpu")
    assert len(tres.losses) == len(jres.losses) == 8
    # fp32; 8 AdamW steps carry the summation-order differences forward
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)


@pytest.mark.parametrize("kind", ["none", "sinusoidal", "learned", "rope"])
def test_positional_matches_jax(kind):
    """Rotary embeddings rotate q and k; every other kind leaves them
    as they are (learned and sinusoidal tables are added at the
    embedding layer, none adds nothing), as in the JAX package."""
    jcfg, tcfg = configs("qwen2-7b", pos_embedding=kind)
    x = np.random.RandomState(2).randn(2, 5, 4, 16).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    want = np.asarray(JL.positional(jnp.asarray(x), jnp.asarray(pos), jcfg))
    got = TL.positional(t(x), t(pos), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if kind != "rope":
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("layers", [None, 8, 2])
def test_jamba_groups_and_param_counts_equal_jax(layers):
    """The full config, the card's 8 layers (one whole period: attention
    at layer 4, MoE at 1, 3, 5, 7) and the smoke config's 2."""
    if layers == 2:
        jcfg, tcfg = configs(JAMBA)
    else:
        jcfg, tcfg = jax_config(JAMBA), torch_config(JAMBA)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        if layers:
            jcfg = dataclasses.replace(jcfg, num_layers=layers)
            tcfg = dataclasses.replace(tcfg, num_layers=layers)
    jg = [(g.sublayers, g.depth, g.first_layer)
          for g in JP.decoder_groups(jcfg)]
    assert [(g.sublayers, g.depth, g.first_layer)
            for g in TP.decoder_groups(tcfg)] == jg
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if layers == 8:
        assert jg == [(("ssm", "mlp", "ssm", "moe", "ssm", "mlp", "ssm",
                        "moe", "attn", "mlp", "ssm", "moe", "ssm", "mlp",
                        "ssm", "moe"), 1, 0)]
        assert tcfg.param_count() == 13_267_598_848
    if layers is None:
        assert jg[0][1] == 4 and tcfg.param_count() == 51_459_770_368


@pytest.mark.parametrize("arch", ["mixtral-8x7b", JAMBA])
def test_launchers_run_the_smoke_variant_on_the_cpu(arch, capsys):
    """``--arch`` without ``--full`` trains and serves the -smoke config;
    jamba's serving falls back to the dense greedy path."""
    from repro_torch.launch import serve, train
    train.main(["--torch-device", "cpu", "--arch", arch, "--steps", "2",
                "--batch", "2", "--seq", "16"])
    serve.main(["--torch-device", "cpu", "--arch", arch, "--max-new", "3",
                "--prompt-len", "5", "--batch", "2"])
    text = capsys.readouterr().out
    assert f"{arch}-smoke" in text and "final loss" in text
    assert ("legacy dense: 6 tokens" in text) == (arch == JAMBA)
