"""Training through the port's mixture-of-experts layer against the JAX
package, on bridged ``mixtral-8x7b-smoke`` weights in fp32 (4 experts,
top-2, a 6-token window, 2 KV heads): the loss and gradients of
``forward_train`` through the fp32 router's softmax and renormalised
top-k weights, the dispatch into the capacity buffer, the expert
``bmm``s, the combine and the load-balance loss, with and without dropped
tokens; the aux loss's own gradient; ``remat="full"`` against ``"none"``;
a step of 2 microbatches against the JAX step of 2; an 8-step trainer
trajectory; and ``train_flops`` counting top-k of the experts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import flops as JF  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core import flops as TF  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import bridged, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_moe import moe_configs  # noqa: E402
from test_torch_train import (GRAD_TOL, LOSS_RTOL,  # noqa: E402
                              assert_tree_close, np_batch)

# capacity factors: 4.0 gives each expert C = 64 slots a row for the
# 2 x 32 = 64 assignments of a 32-token row, so nothing drops; 0.5 gives
# C = 8, so both packages drop (the same) assignments
NO_DROPS, DROPS = 4.0, 0.5


def jax_loss_and_grads(jcfg, jp, nb, **kw):
    """jit of ``jax.value_and_grad`` of the JAX ``forward_train``: (loss,
    metrics, grads by key)."""
    (loss, mets), g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b, **kw), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    return float(loss), mets, dict(bridge.flatten(jax.tree.map(np.asarray,
                                                               g)))


def port_loss_and_grads(tcfg, tp, nb, of="loss", **kw):
    """The port's (loss, metrics, grads by key) of ``of``: the total loss
    or one of its metrics."""
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    loss, mets = TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()},
                                  **kw)
    target = loss if of == "loss" else mets[of]
    grads = torch.autograd.grad(target, leaves, allow_unused=True)
    keys = [k for k, _ in bridge.flatten(tp)]
    return float(loss.detach()), {k: v.detach() for k, v in mets.items()}, \
        dict(zip(keys, grads))


def kept_per_layer(monkeypatch, tcfg, tp, nb):
    """Assignments each MoE layer of the port's forward kept (filled rows
    of its dispatch buffer), by a spy on ``_expert_ffn``."""
    kept = []
    ffn = TMOE._expert_ffn

    def spy(p, buf, cfg):
        kept.append(int((buf.detach() != 0).any(-1).sum()))
        return ffn(p, buf, cfg)
    monkeypatch.setattr(TMOE, "_expert_ffn", spy)
    with torch.no_grad():
        TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()})
    return kept


@pytest.mark.parametrize("cf", [NO_DROPS, DROPS], ids=["no-drops", "drops"])
@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_forward_train_loss_and_grads_match_jax(cf, impl, monkeypatch):
    jcfg, tcfg = moe_configs(capacity_factor=cf)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=32)
    jloss, jm, jg = jax_loss_and_grads(
        jcfg, jp, nb, attn_impl="pallas" if impl == "kernel" else impl)
    tloss, tm, tg = port_loss_and_grads(tcfg, tp, nb, attn_impl=impl)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5)
    assert set(tg) == set(jg)
    for key, ref in jg.items():
        np.testing.assert_allclose(tg[key].numpy(), ref, **GRAD_TOL,
                                   err_msg=key)
    for leaf in ("router", "wi", "wg", "wo"):
        key = next(k for k in tg if k.endswith(f"['s1_moe']['{leaf}']"))
        assert float(tg[key].abs().max()) > 0, key

    # drops: the port's buffers keep fewer than every assignment, and the
    # JAX loss moves with the capacity (it cannot unless JAX drops too)
    total = nb["tokens"].size * jcfg.moe.experts_per_token
    kept = kept_per_layer(monkeypatch, tcfg, tp, nb)
    assert len(kept) == jcfg.num_layers
    if cf == NO_DROPS:
        assert kept == [total] * jcfg.num_layers
    else:
        assert all(k < total for k in kept), kept
        jfull, _ = jax.jit(lambda p, b: JM.forward_train(
            p, dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=NO_DROPS)), b))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
        assert abs(float(jfull) - jloss) > 1e-4


def test_aux_loss_gradient_matches_jax():
    """The load-balance loss alone: its gradient reaches each layer's
    router and, through the router's input, the layers below."""
    jcfg, tcfg = moe_configs(capacity_factor=DROPS)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=32)
    jaux, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b)[1]["aux_loss"]))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    jg = dict(bridge.flatten(jax.tree.map(np.asarray, jg)))
    _, tm, tg = port_loss_and_grads(tcfg, tp, nb, of="aux_loss",
                                    attn_impl="chunked")
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jaux), rtol=1e-5)
    for key, ref in jg.items():
        got = np.zeros_like(ref) if tg[key] is None else tg[key].numpy()
        np.testing.assert_allclose(got, ref, **GRAD_TOL, err_msg=key)
    # the last layer's experts feed no router; the layers below do
    router = next(k for k in jg if k.endswith("['router']"))
    expert = next(k for k in jg if k.endswith("['s1_moe']['wi']"))
    assert np.abs(jg[router]).max() > 0
    assert not np.abs(jg[expert][-1]).any() and np.abs(jg[expert][0]).any()


def test_remat_full_gives_the_grads_of_none_and_of_jax():
    """``remat="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``), the aux loss included: on the CPU the
    recompute routes every token as the forward did, so the gradients
    are those of ``"none"``; they hold to the JAX package's remat step."""
    jcfg, tcfg = moe_configs(capacity_factor=DROPS)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=32)
    loss0, m0, g0 = port_loss_and_grads(tcfg, tp, nb, attn_impl="kernel")
    loss1, m1, g1 = port_loss_and_grads(tcfg, tp, nb, attn_impl="kernel",
                                        remat="full")
    assert loss1 == loss0 and float(m1["aux_loss"]) == float(m0["aux_loss"])
    for key in g0:
        torch.testing.assert_close(g1[key], g0[key], rtol=1e-6, atol=1e-9,
                                   msg=key)
    jloss, _, jg = jax_loss_and_grads(jcfg, jp, nb, attn_impl="chunked",
                                      remat="full")
    np.testing.assert_allclose(loss1, jloss, rtol=LOSS_RTOL)
    for key, ref in jg.items():
        np.testing.assert_allclose(g1[key].numpy(), ref, **GRAD_TOL,
                                   err_msg=key)


def test_two_microbatches_match_the_jax_step_of_two():
    """Each microbatch computes its own load-balance product, so a step
    of 2 is not a step of 1; the port's step of 2 is the JAX step of 2."""
    jcfg, tcfg = moe_configs(capacity_factor=DROPS)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=4, S=32, masked=0)
    # eps 1e-3 keeps Adam's first step a smooth function of the gradient
    # (see tests/test_torch_train.py)
    ocfg = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=4, eps=1e-3)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    out = {}
    for m in (1, 2):
        jstep = jax.jit(JS.make_train_step(jcfg, JA.OptConfig(**ocfg),
                                           attn_impl="chunked",
                                           microbatches=m))
        out[m] = jstep(jp, JA.init_opt_state(jp, JA.OptConfig(**ocfg)),
                       jbatch)
    assert float(out[2][2]["loss"]) != float(out[1][2]["loss"])
    step = TS.make_train_step(tcfg, TA.OptConfig(**ocfg), attn_impl="kernel",
                              microbatches=2)
    p = tree_map(lambda a: a.clone(), tp)
    p, state, mets = step(p, TA.init_opt_state(p, TA.OptConfig(**ocfg)),
                          {k: t(v) for k, v in nb.items()})
    jp2, _, jm = out[2]
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(mets["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(mets["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert_tree_close(p, jp2, rtol=1e-5, atol=1e-6)


def test_trainer_loss_trajectory_matches_jax_step_for_step():
    jcfg, tcfg = moe_configs()
    kw = dict(steps=8, batch=2, seq_len=32, log_every=4, seed=0)
    jres = JT.train(jcfg, JT.TrainerConfig(attn_impl="chunked", **kw))
    _, tp = bridged(jcfg, tcfg, seed=0)          # the JAX trainer's init
    tres = TT.train(tcfg, TT.TrainerConfig(attn_impl="kernel", **kw),
                    params=tp, device="cpu")
    assert len(tres.losses) == len(jres.losses) == 8
    # fp32; 8 AdamW steps carry the summation-order differences forward
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b"])
def test_train_flops_count_top_k_of_the_experts(arch):
    """MFU is the active work: 6 N_active D plus attention and scan, as
    in the JAX package, well under 6 N D with every expert."""
    from repro.configs import get_config as jax_config
    tcfg, jcfg = torch_config(arch), jax_config(arch)
    for layers in (2, 8, tcfg.num_layers):
        tc = dataclasses.replace(tcfg, num_layers=layers)
        jc = dataclasses.replace(jcfg, num_layers=layers)
        for remat in (False, True):
            assert TF.train_flops(tc, 1, 8192, remat=remat) == \
                JF.train_flops(jc, 1, 8192, remat=remat)
        dense = 6.0 * tc.param_count() * 8192
        active = 6.0 * tc.active_param_count() * 8192
        got = TF.train_flops(tc, 1, 8192, remat=False)
        assert active < got < dense
