"""Multi-head latent attention, DeepSeek's dense prefix and multi-token
prediction in the port against the JAX package, on bridged weights in
fp32: ``deepseek-v3-671b-smoke`` (one dense layer, one MoE layer, plain
``wq``) and a variant with the q-LoRA branch, a stacked dense prefix of
two layers and a stacked MoE group of two.  Losses with the MTP loss,
logits for every attention impl, gradients (the MTP block's included),
an 8-step trainer trajectory, the absorbed dense decode, greedy ids,
layer groups and bridged paths; the engine's refusal, both launchers on
the CPU; then ``forward_train`` and ``decode_step_paged`` parity for the
three dense configs of this slice (granite-3-2b, qwen1.5-32b,
llama3-405b)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import no_drop  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.serve import engine as JSE  # noqa: E402
from repro.serve import step as JSS  # noqa: E402
from repro.serve.paged_cache import PagedKVCache  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.serve import engine as TSE  # noqa: E402
from repro_torch.serve import step as TSS  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import bridged, configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_model import TOL  # noqa: E402
from test_torch_moe import TOL as MOE_TOL  # noqa: E402
from test_torch_train import GRAD_TOL, np_batch  # noqa: E402

DS = "deepseek-v3-671b"
VARIANTS = ["smoke", "qlora"]
# port impl -> the JAX impl of the same attention algorithm
JAX_IMPL = {"naive": "naive", "chunked": "chunked", "kernel": "pallas"}
DENSE = ["granite-3-2b", "qwen1.5-32b", "llama3-405b"]


def ds_configs(variant):
    """(JAX config, port config): the smoke config, or the same with
    ``q_lora_rank`` 32, 4 layers and a 2-layer dense prefix."""
    jcfg, tcfg = configs(DS)
    if variant == "qlora":
        kw = dict(num_layers=4, first_dense_layers=2)
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
            jcfg.mla, q_lora_rank=32), **kw)
        tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(
            tcfg.mla, q_lora_rank=32), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def groups(P, cfg):
    return [(g.sublayers, g.depth, g.first_layer)
            for g in P.decoder_groups(cfg)]


def spec_paths(P, cfg):
    """{keystr path: shape} of a spec tree (no weights drawn)."""
    spec = P.model_spec(cfg)
    if P is JP:
        flat = jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: isinstance(x, JP.ParamSpec))[0]
        return {jax.tree_util.keystr(p): s.shape for p, s in flat}
    return {k: s.shape for k, s in bridge.flatten(spec)}


@pytest.mark.parametrize("case", ["smoke", "qlora", "full", "card-5",
                                  "card-3"])
def test_layer_groups_spec_paths_and_counts_equal_jax(case):
    """Groups, parameter paths with their shapes, and counts: the two test
    variants, the full model (3 dense + 58 MoE layers, two groups) and
    the card's cuts (3 dense + 2 MoE layers; the dense prefix alone)."""
    if case in VARIANTS:
        jcfg, tcfg = ds_configs(case)
    else:
        jcfg, tcfg = jax_config(DS), torch_config(DS)
        layers = {"full": None, "card-5": 5, "card-3": 3}[case]
        if layers:
            kw = dict(num_layers=layers,
                      first_dense_layers=min(3, layers))
            jcfg = dataclasses.replace(jcfg, **kw)
            tcfg = dataclasses.replace(tcfg, **kw)
    assert groups(TP, tcfg) == groups(JP, jcfg)
    assert spec_paths(TP, tcfg) == spec_paths(JP, jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    want = {"smoke": [(("mla", "mlp"), 1, 0), (("mla", "moe"), 1, 1)],
            "qlora": [(("mla", "mlp"), 2, 0), (("mla", "moe"), 2, 2)],
            "full": [(("mla", "mlp"), 3, 0), (("mla", "moe"), 58, 3)],
            "card-5": [(("mla", "mlp"), 3, 0), (("mla", "moe"), 2, 3)],
            "card-3": [(("mla", "mlp"), 3, 0)]}[case]
    assert groups(TP, tcfg) == want
    counts = {"card-5": 27_304_645_632, "card-3": 4_290_073_600}
    if case in counts:
        assert tcfg.param_count() == counts[case]
    paths = spec_paths(TP, tcfg)
    assert "['mtp']['d0']['block']['s0_mla']['wkv_b']" in paths
    assert ("['decoder']['g0']['s0_mla']['wq_a']" in paths) == (
        case != "smoke")


@pytest.mark.parametrize("variant", VARIANTS)
def test_bridge_carries_every_leaf_by_its_jax_path(variant):
    jcfg, tcfg = ds_configs(variant)
    jp, tp = bridged(jcfg, tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jflat}
    got = dict(bridge.flatten(tp))
    assert set(got) == set(want)
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)
    back = bridge.params_to_numpy(tp)
    assert set(dict(bridge.flatten(back))) == set(want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_forward_train_loss_and_metrics_match_jax(variant, impl):
    """The loss and its parts, ``mtp_loss`` among them, with 5 masked
    labels a row."""
    jcfg, tcfg = ds_configs(variant)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=24)
    jl, jm = JM.forward_train(jp, jcfg,
                              {k: jnp.asarray(v) for k, v in nb.items()},
                              attn_impl=JAX_IMPL[impl])
    with torch.no_grad():
        tl, tm = TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()},
                                  attn_impl=impl)
    assert set(tm) == set(jm) == {"ce_loss", "aux_loss", "tokens",
                                  "mtp_loss"}
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    assert float(tm["mtp_loss"]) > 0 and float(tm["aux_loss"]) > 0


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_forward_logits_match_jax(variant, impl):
    jcfg, tcfg = ds_configs(variant)
    jp, tp = bridged(jcfg, tcfg)
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 20))
    jl = JM.forward_logits(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           attn_impl=JAX_IMPL[impl])
    with torch.no_grad():
        tl = TM.forward_logits(tp, tcfg, {"tokens": t(toks)},
                               attn_impl=impl)
    assert tl.shape == (2, 20, tcfg.padded_vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("variant,impl", [("smoke", "chunked"),
                                          ("smoke", "kernel"),
                                          ("qlora", "kernel")])
def test_gradients_match_jax_grad(variant, impl):
    """Every leaf's gradient, the MTP block's and the q-LoRA pair's
    included, against ``jax.grad`` of the JAX loss."""
    jcfg, tcfg = ds_configs(variant)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=24)
    jg = jax.jit(jax.grad(lambda p, b: JM.forward_train(
        p, jcfg, b, attn_impl=JAX_IMPL[impl])[0]))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    leaves = [p.requires_grad_(True) for p in TP.tree_leaves(tp)]
    tloss, _ = TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()},
                                attn_impl=impl)
    tg = dict(zip([k for k, _ in bridge.flatten(tp)],
                  torch.autograd.grad(tloss, leaves)))
    want = dict(bridge.flatten(jax.tree.map(np.asarray, jg)))
    assert set(tg) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(tg[key].numpy(), ref, **GRAD_TOL,
                                   err_msg=key)
    for leaf in ("['mtp']['d0']['proj']", "['mtp']['d0']['norm_emb']",
                 "['s0_mla']['wkv_b']", "['router']") + (
            ("['wq_a']", "['q_norm']") if variant == "qlora" else ()):
        keys = [k for k in tg if leaf in k]
        assert keys and all(float(tg[k].abs().max()) > 0 for k in keys), \
            leaf


@pytest.mark.parametrize("variant", VARIANTS)
def test_trainer_loss_trajectory_matches_jax_step_for_step(variant):
    jcfg, tcfg = ds_configs(variant)
    kw = dict(steps=8, batch=2, seq_len=24, log_every=4, seed=0)
    jres = JT.train(jcfg, JT.TrainerConfig(attn_impl="chunked", **kw))
    _, tp = bridged(jcfg, tcfg, seed=0)          # the JAX trainer's init
    tres = TT.train(tcfg, TT.TrainerConfig(attn_impl="kernel", **kw),
                    params=tp, device="cpu")
    assert len(tres.losses) == len(jres.losses) == 8
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_steps_match_jax(variant):
    """``init_cache`` (the latent and the rope key a layer), then
    ``decode_step`` token by token through the absorbed form: logits and
    every cache leaf against the JAX decode."""
    jcfg, tcfg = ds_configs(variant)
    jp, tp = bridged(jcfg, tcfg)
    B, S, T = 2, 9, 12
    jc = JM.init_cache(jcfg, B, T, jnp.float32)
    tc = TM.init_cache(tcfg, B, T, torch.float32, "cpu")
    jshapes = {k: v.shape for k, v in bridge.flatten(
        jax.tree.map(np.asarray, jc))}
    assert {k: tuple(v.shape) for k, v in bridge.flatten(tc)} == jshapes
    m = tcfg.mla
    assert tc["g0"]["s0_mla"]["latent"].shape[-1] == m.kv_lora_rank
    assert tc["g0"]["s0_mla"]["k_rope"].shape[-1] == m.qk_rope_head_dim
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (B, S))
    for i in range(S):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, i:i + 1]),
                                jnp.int32(i))
        with torch.no_grad():
            tl, tc = TM.decode_step(tp, tcfg, tc, t(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MOE_TOL,
                                   err_msg=f"step {i}")
    for (key, got), (_, want) in zip(bridge.flatten(tc), bridge.flatten(
            jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(got.numpy(), want, **MOE_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_generate_ids_equal_jax(variant):
    """bf16 latent caches, the dense-cache default of both packages."""
    jcfg, tcfg = ds_configs(variant)
    jp, tp = bridged(jcfg, tcfg)
    prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 7))
    want = JSS.greedy_generate(jp, jcfg, jnp.asarray(prompt), 6)
    got = TSS.greedy_generate(tp, tcfg, t(prompt), 6)
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", VARIANTS)
def test_absorbed_decode_equals_the_expanded_prefill(variant):
    """The port's own check of the two MLA forms: decode steps over the
    latent cache against ``forward_logits`` through the expanded form,
    at a capacity that drops nothing (the decode's flat dispatch never
    drops)."""
    _, tcfg = ds_configs(variant)
    tcfg = no_drop(tcfg)
    tp = TP.init_params(tcfg, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, tcfg.vocab_size, (2, 11)))
    cache = TM.init_cache(tcfg, 2, 11, torch.float32, "cpu")
    outs = []
    with torch.no_grad():
        for i in range(11):
            lg, cache = TM.decode_step(tp, tcfg, cache, toks[:, i:i + 1], i)
            outs.append(lg)
        full = TM.forward_logits(tp, tcfg, {"tokens": toks},
                                 attn_impl="kernel")
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_mla_kernel_inputs_start_every_row_on_16_bytes(monkeypatch):
    """At the full model's head widths (nope 128, rope 64, v 128, latent
    512, q-LoRA 1536) in bf16, the q, k and v that ``mla_forward`` hands
    to the FA-2 wrappers pass their 16-byte row check as they are: q and
    k are new tensors, v a slice of the ``wkv_b`` product 256 bytes in."""
    full = torch_config(DS).mla
    cfg = dataclasses.replace(torch_config(DS + "-smoke"), num_heads=2,
                              num_kv_heads=2, mla=full)
    p = TP.init_params(cfg, device="cpu", seed=0)["decoder"]["g0"]["s0_mla"]
    seen = {}

    def spy(q, k, v, **kw):
        seen.update(q=q, k=k, v=v)
        return FK.attention_fwd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      causal=kw["causal"])[0].transpose(1, 2)
    monkeypatch.setattr(TMLA, "run_attention", spy)
    x = torch.randn(1, 5, cfg.d_model).to(torch.bfloat16)
    pos = torch.arange(5)[None]
    with torch.no_grad():
        TMLA.mla_forward(p, x, cfg, positions=pos)
    assert seen["q"].shape[-1] == seen["k"].shape[-1] == 192
    assert seen["v"].shape[-1] == 128
    for name in ("q", "k", "v"):
        assert FK._rows_aligned(seen[name].transpose(1, 2)), name


def test_engine_refuses_mla_as_the_jax_engine_does():
    jcfg, tcfg = ds_configs("smoke")
    jp, tp = bridged(jcfg, tcfg)
    assert not JM.paged_decode_supported(jcfg)
    assert not TM.paged_decode_supported(tcfg)
    with pytest.raises(NotImplementedError):
        JSE.ServeEngine(jp, jcfg, JSE.EngineConfig())
    with pytest.raises(NotImplementedError, match="MLA"):
        TSE.ServeEngine(tp, tcfg, TSE.EngineConfig(), torch_device="cpu")


def test_launchers_run_deepseek_smoke_on_the_cpu(capsys):
    """``--arch deepseek-v3-671b`` trains the -smoke config (with its MTP
    loss) and serves it through the dense greedy path."""
    from repro_torch.launch import serve, train
    train.main(["--torch-device", "cpu", "--arch", DS, "--steps", "2",
                "--batch", "2", "--seq", "16"])
    serve.main(["--torch-device", "cpu", "--arch", DS, "--max-new", "3",
                "--prompt-len", "5", "--batch", "2"])
    text = capsys.readouterr().out
    assert f"{DS}-smoke" in text and "final loss" in text
    assert "legacy dense: 6 tokens" in text


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_forward_train_matches_jax(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = bridged(jcfg, tcfg)
    nb = np_batch(jcfg, B=2, S=24)
    jl, jm = JM.forward_train(jp, jcfg,
                              {k: jnp.asarray(v) for k, v in nb.items()})
    with torch.no_grad():
        tl, tm = TM.forward_train(tp, tcfg, {k: t(v) for k, v in nb.items()},
                                  attn_impl="kernel")
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["ce_loss"]), float(jm["ce_loss"]),
                               **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_decode_step_paged_matches_jax(arch):
    """A 9-token prompt through the paged cache in chunks of 4 (the last
    one ragged), then 3 single-token steps."""
    jcfg, tcfg = configs(arch)
    assert TM.paged_decode_supported(tcfg)
    jp, tp = bridged(jcfg, tcfg)
    B, bs, nblocks = 2, 4, 12
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, 12))
    kv = PagedKVCache(num_blocks=nblocks, block_size=bs, max_slots=B,
                      max_blocks_per_seq=4)
    jpages = JM.init_paged_cache(jcfg, nblocks, bs, jnp.float32)
    tpages = TM.init_paged_cache(tcfg, nblocks, bs, torch.float32, "cpu")
    for s in range(B):
        kv.open_slot(s)
    i = 0
    for n, C in ((4, 4), (4, 4), (1, 4), (1, 1), (1, 1), (1, 1)):
        chunk = np.zeros((B, C), np.int32)
        chunk[:, :n] = toks[:, i:i + n]
        nf = np.full((B,), n, np.int32)
        for s in range(B):
            assert kv.ensure_capacity(s, n)
        bt, sl = kv.device_tables(), kv.seq_lens()
        jl, jpages = JM.decode_step_paged(
            jp, jcfg, jpages, jnp.asarray(chunk), jnp.asarray(bt),
            jnp.asarray(sl), num_feed=jnp.asarray(nf))
        with torch.no_grad():
            tl, tpages = TM.decode_step_paged(
                tp, tcfg, tpages, t(chunk), t(bt), t(sl),
                attn_impl="kernel", num_feed=t(nf))
        for s in range(B):
            for _ in range(n):
                kv.commit_token(s)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} at token {i}")
        i += n
