"""Whisper's encoder-decoder and the Qwen2-VL backbone in the port against
the JAX package, on bridged weights in fp32: ``whisper-medium-smoke``
(the encoder, cross-attention, learned positions, the warmed cross cache
and the legacy ``enc=`` decode) and ``qwen2-vl-2b-smoke`` (M-RoPE with
distinct t/h/w streams, the vision prefix, GQA).  Losses and logits for
every attention impl, the encoder and cross-attention pieces, gradients,
8-step trainer trajectories, dense and paged decode, greedy ids, batches,
bridged paths, the launchers; then the two faults this slice repaired: a
decode step past the learned position table, and M-RoPE positions split
into microbatches on their batch axis."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import make_batch_fn as j_batches  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.serve import engine as JSE  # noqa: E402
from repro.serve import step as JSS  # noqa: E402
from repro.serve.paged_cache import PagedKVCache  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn as t_batches  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.launch.specs import vlm_split  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.serve import engine as TSE  # noqa: E402
from repro_torch.serve import step as TSS  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

from test_torch_helpers import configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401
from test_torch_model import TOL  # noqa: E402
from test_torch_train import GRAD_TOL, LOSS_RTOL, assert_tree_close  # noqa: E402

WH, VL = "whisper-medium", "qwen2-vl-2b"
ARCHS = [WH, VL]
# port impl -> the JAX impl of the same attention algorithm
JAX_IMPL = {"naive": "naive", "chunked": "chunked", "kernel": "pallas"}
IMPLS = list(JAX_IMPL)
_jax_decode = jax.jit(JM.decode_step, static_argnums=(1,))
_jax_paged = jax.jit(JM.decode_step_paged, static_argnums=(1,))


def mrope_positions(B, grid, St):
    """(3, B, grid * grid + St) Qwen2-VL position ids with distinct
    streams: the vision tokens take (t, h, w) = (0, row, column) on a
    grid x grid patch grid, and the text continues after the largest of
    them with t = h = w."""
    Sv = grid * grid
    idx = np.arange(Sv)
    vis = np.stack([np.zeros(Sv), idx // grid, idx % grid])
    text = np.broadcast_to(grid + np.arange(St), (3, St))
    pos = np.concatenate([vis, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, B, Sv + St)))


@pytest.fixture(scope="module")
def models():
    """{arch: (JAX config, port config, JAX params, port params)}."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = configs(arch)
        jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch] = (jcfg, tcfg, jp, bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def batch_of(arch, cfg, B=2, S=64):
    """The pipeline's first batch; for the VLM (16 vision + 48 text
    tokens at S = 64, 9 + 27 at S = 36) with distinct M-RoPE streams."""
    nb = next(t_batches(cfg, B, S, seed=0))
    if arch == VL:
        Sv, St = vlm_split(S)
        grid = int(round(Sv ** 0.5))
        assert grid * grid == Sv, S
        nb["positions"] = mrope_positions(B, grid, St)
    return nb


def jx(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def tx(nb):
    return {k: t(v) for k, v in nb.items()}


def spec_paths(P, cfg):
    spec = P.model_spec(cfg)
    if P is JP:
        flat = jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: isinstance(x, JP.ParamSpec))[0]
        return {jax.tree_util.keystr(p): s.shape for p, s in flat}
    return {k: s.shape for k, s in bridge.flatten(spec)}


@pytest.mark.parametrize("arch", ARCHS)
def test_groups_paths_and_counts_equal_jax(arch, models):
    """Decoder (and encoder) groups, every parameter path with its shape,
    the counts, and every bridged leaf under its JAX path."""
    jcfg, tcfg, jp, tp = models[arch]
    groups = lambda P, fn, c: [(g.sublayers, g.depth, g.first_layer)  # noqa
                               for g in getattr(P, fn)(c)]
    assert groups(TP, "decoder_groups", tcfg) == \
        groups(JP, "decoder_groups", jcfg)
    assert spec_paths(TP, tcfg) == spec_paths(JP, jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = dict(bridge.flatten(tp))
    assert set(got) == set(want)
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)
    if arch == WH:
        assert groups(TP, "encoder_groups", tcfg) == \
            groups(JP, "encoder_groups", jcfg) == [(("attn", "mlp"), 2, 0)]
        assert groups(TP, "decoder_groups", tcfg) == [
            (("attn", "xattn", "mlp"), 2, 0)]
        for key in ("['encoder']['g0']['s0_attn']['wq']",
                    "['encoder']['final_norm']['bias']",
                    "['decoder']['g0']['s1_xattn']['bk']"):
            assert key in got, key


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_fn_gives_the_jax_batches(arch):
    jcfg, tcfg = configs(arch)
    jb, tb = j_batches(jcfg, 2, 40, seed=3), t_batches(tcfg, 2, 40, seed=3)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = {WH: {"tokens", "labels", "frames"},
            VL: {"tokens", "labels", "vision_embeds", "positions"}}[arch]
    assert set(b) == want
    if arch == VL:
        assert b["positions"].shape == (3, 2, 40)
        assert (b["labels"][:, :vlm_split(40)[0]] == -1).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_matches_jax(arch, impl, models):
    jcfg, tcfg, jp, tp = models[arch]
    nb = batch_of(arch, tcfg)
    jl, jm = JM.forward_train(jp, jcfg, jx(nb), attn_impl=JAX_IMPL[impl])
    with torch.no_grad():
        tl, tm = TM.forward_train(tp, tcfg, tx(nb), attn_impl=impl)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    assert float(tm["tokens"]) == float((nb["labels"] >= 0).sum())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl, models):
    jcfg, tcfg, jp, tp = models[arch]
    nb = batch_of(arch, tcfg, S=36)
    del nb["labels"]
    jl = JM.forward_logits(jp, jcfg, jx(nb), attn_impl=JAX_IMPL[impl])
    with torch.no_grad():
        tl = TM.forward_logits(tp, tcfg, tx(nb), attn_impl=impl)
    S = 36
    assert tl.shape == (2, S, tcfg.padded_vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_encoder_and_cross_attention_match_jax(impl, models):
    """``encoder_forward``; then layer 0's ``project_cross_kv`` and
    ``xattn_forward`` (S = 11 decoder rows over T = 64 frames)."""
    jcfg, tcfg, jp, tp = models[WH]
    rs = np.random.RandomState(2)
    frames = (rs.randn(2, tcfg.encoder_seq_len, tcfg.d_model) * 0.02
              ).astype(np.float32)
    jenc = JM.encoder_forward(jp, jcfg, jnp.asarray(frames),
                              {"attn_impl": JAX_IMPL[impl]})
    with torch.no_grad():
        tenc = TM.encoder_forward(tp, tcfg, t(frames), {"attn_impl": impl})
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    jx0 = jax.tree.map(lambda a: a[0], jp["decoder"]["g0"]["s1_xattn"])
    tx0 = TP.tree_map(lambda a: a[0], tp["decoder"]["g0"]["s1_xattn"])
    jk, jv = JL.project_cross_kv(jx0, jenc, jcfg)
    with torch.no_grad():
        tk, tv = TL.project_cross_kv(tx0, tenc, tcfg)
    assert tk.shape == (2, tcfg.encoder_seq_len, tcfg.num_kv_heads,
                        tcfg.resolved_head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    x = rs.randn(2, 11, tcfg.d_model).astype(np.float32)
    jy = JL.xattn_forward(jx0, jnp.asarray(x), jenc, jcfg,
                          impl=JAX_IMPL[impl])
    with torch.no_grad():
        ty = TL.xattn_forward(tx0, t(x), tenc, tcfg, impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_apply_mrope_matches_jax_with_distinct_streams():
    """Distinct t/h/w positions at head width 128 and sections (16, 24,
    24), Qwen2-VL's own, and the smoke config's (16, 8, 8): equal to the
    JAX function; with equal streams, equal to plain RoPE; with distinct
    ones, not."""
    rs = np.random.RandomState(0)
    for D, sections, theta in ((128, (16, 24, 24), 1e6), (64, (16, 8, 8),
                                                          1e4)):
        x = rs.randn(2, 20, 3, D).astype(np.float32)
        pos = rs.randint(0, 500, (3, 2, 20)).astype(np.int32)
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta,
                              sections)
        got = TL.apply_mrope(t(x), t(pos), theta, sections)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        same = np.broadcast_to(pos[:1], pos.shape)
        np.testing.assert_allclose(
            TL.apply_mrope(t(x), t(same), theta, sections).numpy(),
            TL.apply_rope(t(x), t(pos[0]), theta).numpy(), rtol=0, atol=0)
        assert not np.allclose(got.numpy(), TL.apply_rope(
            t(x), t(pos[0]), theta).numpy(), atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch, models):
    """Every leaf's gradient through the kernels' plain versions, the
    encoder's and the cross-attention's included, against ``jax.grad``
    through the Pallas kernels (interpret mode)."""
    jcfg, tcfg, jp, tp = models[arch]
    nb = batch_of(arch, tcfg, S=36)
    jg = jax.jit(jax.grad(lambda p, b: JM.forward_train(
        p, jcfg, b, attn_impl="pallas")[0]))(jp, jx(nb))
    p = TP.tree_map(lambda a: a.detach().clone().requires_grad_(True), tp)
    leaves = TP.tree_leaves(p)
    tloss, _ = TM.forward_train(p, tcfg, tx(nb), attn_impl="kernel")
    tg = dict(zip([k for k, _ in bridge.flatten(p)],
                  torch.autograd.grad(tloss, leaves)))
    want = dict(bridge.flatten(jax.tree.map(np.asarray, jg)))
    assert set(tg) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(tg[key].numpy(), ref, **GRAD_TOL,
                                   err_msg=key)
    probes = {WH: ("['encoder']['g0']['s0_attn']['wq']",
                   "['encoder']['final_norm']['scale']",
                   "['decoder']['g0']['s1_xattn']['wk']"),
              VL: ("['decoder']['g0']['s0_attn']['wq']",)}[arch]
    for key in probes:
        assert float(tg[key].abs().max()) > 0, key


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_loss_trajectory_matches_jax_step_for_step(arch):
    jcfg, tcfg = configs(arch)
    kw = dict(steps=8, batch=2, seq_len=32, log_every=4, seed=0)
    jres = JT.train(jcfg, JT.TrainerConfig(attn_impl="chunked", **kw))
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))   # the trainer's init
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tres = TT.train(tcfg, TT.TrainerConfig(attn_impl="kernel", **kw),
                    params=tp, device="cpu")
    assert len(tres.losses) == len(jres.losses) == 8
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)


def test_whisper_caches_and_decode_steps_match_jax(models):
    """``init_cache`` (self-attention K/V, and the (B, T_enc, K, D)
    cross-attention K/V), ``warm_cross_cache``, then ``decode_step``
    token by token against the warmed cache and along the legacy path
    that re-projects ``enc`` every step: logits against the JAX decode on
    each path, and the two paths against each other."""
    jcfg, tcfg, jp, tp = models[WH]
    B, S, T = 2, 7, 10
    frames = (np.random.RandomState(3).randn(
        B, tcfg.encoder_seq_len, tcfg.d_model) * 0.02).astype(np.float32)
    jenc = JM.encoder_forward(jp, jcfg, jnp.asarray(frames), {})
    with torch.no_grad():
        tenc = TM.encoder_forward(tp, tcfg, t(frames), {})
    jc = JM.init_cache(jcfg, B, T, jnp.float32)
    tc = TM.init_cache(tcfg, B, T, torch.float32, "cpu")
    shapes = {k: v.shape for k, v in bridge.flatten(
        jax.tree.map(np.asarray, jc))}
    assert {k: tuple(v.shape) for k, v in bridge.flatten(tc)} == shapes
    assert tc["g0"]["s1_xattn"]["k"].shape == (
        tcfg.num_layers, B, tcfg.encoder_seq_len, tcfg.num_kv_heads,
        tcfg.resolved_head_dim)
    jc = JM.warm_cross_cache(jp, jcfg, jc, jenc)
    assert TM.warm_cross_cache(tp, tcfg, tc, tenc) is tc
    for (key, got), (_, want) in zip(bridge.flatten(tc), bridge.flatten(
            jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=key)
    jlc = JM.init_cache(jcfg, B, T, jnp.float32)
    tlc = TM.init_cache(tcfg, B, T, torch.float32, "cpu")
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (B, S))
    for i in range(S):
        tok = toks[:, i:i + 1]
        jl, jc = _jax_decode(jp, jcfg, jc, jnp.asarray(tok), jnp.int32(i))
        jll, jlc = _jax_decode(jp, jcfg, jlc, jnp.asarray(tok),
                                  jnp.int32(i), enc=jenc)
        with torch.no_grad():
            tl, tc = TM.decode_step(tp, tcfg, tc, t(tok), i)
            tll, tlc = TM.decode_step(tp, tcfg, tlc, t(tok), i, enc=tenc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"warmed, step {i}")
        np.testing.assert_allclose(tll.numpy(), np.asarray(jll), **TOL,
                                   err_msg=f"legacy, step {i}")
        np.testing.assert_allclose(tll.numpy(), tl.numpy(), **TOL,
                                   err_msg=f"legacy vs warmed, step {i}")


def test_qwen2_vl_dense_decode_matches_jax(models):
    """``decode_step`` with the M-RoPE positions it broadcasts to three
    equal streams, and with distinct ones passed in."""
    jcfg, tcfg, jp, tp = models[VL]
    B, S = 2, 9
    jc = JM.init_cache(jcfg, B, S, jnp.float32)
    tc = TM.init_cache(tcfg, B, S, torch.float32, "cpu")
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (B, S))
    pos = mrope_positions(B, 2, S - 4)
    for i in range(S):
        kw_j, kw_t = {}, {}
        if i % 2:
            kw_j = dict(positions=jnp.asarray(pos[..., i:i + 1]))
            kw_t = dict(positions=t(pos[..., i:i + 1]))
        jl, jc = _jax_decode(jp, jcfg, jc, jnp.asarray(toks[:, i:i + 1]),
                                jnp.int32(i), **kw_j)
        with torch.no_grad():
            tl, tc = TM.decode_step(tp, tcfg, tc, t(toks[:, i:i + 1]), i,
                                    **kw_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_ids_equal_jax(arch, models):
    """bf16 dense caches, the default of both packages; whisper decodes
    against the encoder's output through the warmed cross cache."""
    jcfg, tcfg, jp, tp = models[arch]
    prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 7))
    jenc = tenc = None
    if arch == WH:
        frames = (np.random.RandomState(8).randn(
            2, tcfg.encoder_seq_len, tcfg.d_model) * 0.02).astype(np.float32)
        jenc = JM.encoder_forward(jp, jcfg, jnp.asarray(frames), {})
        with torch.no_grad():
            tenc = TM.encoder_forward(tp, tcfg, t(frames), {})
    want = JSS.greedy_generate(jp, jcfg, jnp.asarray(prompt), 6, enc=jenc)
    got = TSS.greedy_generate(tp, tcfg, t(prompt), 6, enc=tenc)
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", [1, 4])
def test_qwen2_vl_paged_decode_matches_jax(chunk, models):
    """An 11-token prompt through the paged cache (token by token, or in
    chunks of 4 with a ragged last one): ``decode_step_paged`` broadcasts
    its (B, C) positions to the three M-RoPE streams."""
    jcfg, tcfg, jp, tp = models[VL]
    B, S, bs, nblocks = 2, 11, 4, 12
    prompt = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S))
    kv = PagedKVCache(num_blocks=nblocks, block_size=bs, max_slots=B,
                      max_blocks_per_seq=4)
    jpages = JM.init_paged_cache(jcfg, nblocks, bs, jnp.float32)
    tpages = TM.init_paged_cache(tcfg, nblocks, bs, torch.float32, "cpu")
    for s in range(B):
        kv.open_slot(s)
    for i in range(0, S, chunk):
        n = min(chunk, S - i)
        toks = np.zeros((B, chunk), np.int32)
        toks[:, :n] = prompt[:, i:i + n]
        nf = np.full((B,), n, np.int32)
        for s in range(B):
            assert kv.ensure_capacity(s, n)
        bt, sl = kv.device_tables(), kv.seq_lens()
        jl, jpages = _jax_paged(
            jp, jcfg, jpages, jnp.asarray(toks), jnp.asarray(bt),
            jnp.asarray(sl), num_feed=jnp.asarray(nf))
        with torch.no_grad():
            tl, tpages = TM.decode_step_paged(
                tp, tcfg, tpages, t(toks), t(bt), t(sl),
                attn_impl="kernel", num_feed=t(nf))
        for s in range(B):
            for _ in range(n):
                kv.commit_token(s)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step at token {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_kernel_inputs_start_every_row_on_16_bytes(
        arch, monkeypatch):
    """At the full models' widths in bf16 (whisper: 16 heads x 64 over
    d 1024, its cross-attention's k and v projections of the encoder
    output plus a bias; Qwen2-VL: 12 / 2 heads x 128 over d 1536, q and k
    after M-RoPE), every q, k and v that reaches ``run_attention`` passes
    the FA-2 wrappers' 16-byte row check as it is."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=1,
                              encoder_layers=1 if arch == WH else 0,
                              encoder_seq_len=9 if arch == WH else 0,
                              vocab_size=64)
    p = TP.init_params(cfg, device="cpu", seed=0)
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return TL.attention_core(q, k, v, causal=kw["causal"])
    monkeypatch.setattr(TL, "run_attention", spy)
    toks = torch.randint(0, 64, (1, 5))
    batch = {"tokens": toks}
    if arch == WH:
        batch["frames"] = torch.randn(1, 9, cfg.d_model)
    else:
        batch["vision_embeds"] = torch.randn(1, 4, cfg.d_model)
        batch["positions"] = t(mrope_positions(1, 2, 5))
    with torch.no_grad():
        TM.forward_logits(p, cfg, batch, attn_impl="kernel")
    assert len(seen) == (3 if arch == WH else 1)
    for q, k, v in seen:
        assert q.dtype == torch.bfloat16
        for name, x in zip("qkv", (q, k, v)):
            assert FK._rows_aligned(x.transpose(1, 2)), (arch, name)


def test_engine_refuses_whisper_naming_encoder_decoder_caches(models):
    jcfg, tcfg, jp, tp = models[WH]
    assert not JM.paged_decode_supported(jcfg)
    assert not TM.paged_decode_supported(tcfg)
    assert TM.paged_decode_supported(models[VL][1]) == \
        JM.paged_decode_supported(models[VL][0]) is True
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        JSE.ServeEngine(jp, jcfg, JSE.EngineConfig())
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        TSE.ServeEngine(tp, tcfg, TSE.EngineConfig(), torch_device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_smoke_arch_on_the_cpu(arch, capsys):
    """``--arch`` trains the -smoke config; whisper serves through the
    dense path (encoder, warmed cross cache), Qwen2-VL through the paged
    engine."""
    from repro_torch.launch import serve, train
    train.main(["--torch-device", "cpu", "--arch", arch, "--steps", "2",
                "--batch", "2", "--seq", "32"])
    serve.main(["--torch-device", "cpu", "--arch", arch, "--max-new", "3",
                "--prompt-len", "5", "--batch", "2"])
    text = capsys.readouterr().out
    assert f"{arch}-smoke" in text and "final loss" in text
    if arch == WH:
        assert "legacy dense: 6 tokens" in text
    else:
        assert "engine: 6 tokens" in text


# --------------------------------------------------------------------------- #
# The two faults repaired in this slice
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["opt-125m", WH])
def test_decode_step_past_the_position_table_matches_jax(arch):
    """Decode steps at the learned position table's last rows and past
    them: the JAX ``dynamic_slice_in_dim`` clamps to the last row, and so
    must the port (it used to slice an empty row and raise)."""
    jcfg, tcfg = configs(arch)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    n_pos = tcfg.max_target_positions
    assert tp["embed"]["pos"].shape[0] == n_pos
    B, T = 2, n_pos + 8
    jc = JM.init_cache(jcfg, B, T, jnp.float32)
    tc = TM.init_cache(tcfg, B, T, torch.float32, "cpu")
    jenc = tenc = None
    if arch == WH:
        frames = (np.random.RandomState(3).randn(
            B, tcfg.encoder_seq_len, tcfg.d_model) * 0.02).astype(np.float32)
        jenc = JM.encoder_forward(jp, jcfg, jnp.asarray(frames), {})
        with torch.no_grad():
            tenc = TM.encoder_forward(tp, tcfg, t(frames), {})
        jc = JM.warm_cross_cache(jp, jcfg, jc, jenc)
        TM.warm_cross_cache(tp, tcfg, tc, tenc)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab_size, (B, 6))
    for j, i in enumerate(range(n_pos - 2, n_pos + 4)):
        tok = toks[:, j:j + 1]
        jl, jc = _jax_decode(jp, jcfg, jc, jnp.asarray(tok), jnp.int32(i))
        with torch.no_grad():
            tl, tc = TM.decode_step(tp, tcfg, tc, t(tok), i)
        assert np.isfinite(tl.numpy()).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} at index {i}")


def test_split_microbatches_splits_mrope_positions_on_the_batch_axis():
    B, S = 6, 5
    pos = torch.arange(3 * B * S).reshape(3, B, S)
    batch = {"tokens": torch.zeros(B, S), "positions": pos,
             "vision_embeds": torch.zeros(B, 2, 4)}
    parts = TS._split_microbatches(batch, 3)
    assert len(parts) == 3
    for i, mb in enumerate(parts):
        assert mb["positions"].shape == (3, 2, S)
        assert torch.equal(mb["positions"], pos[:, 2 * i:2 * i + 2])
        assert mb["tokens"].shape == (2, S)
    with pytest.raises(ValueError, match="positions"):
        TS._split_microbatches(dict(batch, tokens=torch.zeros(4, S),
                                    vision_embeds=torch.zeros(4, 2, 4),
                                    positions=pos[:, :5]), 2)


def test_mrope_step_with_two_microbatches_matches_jax():
    """One train step of ``qwen2-vl-2b-smoke`` with 2 microbatches and
    distinct M-RoPE streams against the JAX step with 2 microbatches:
    the loss and every updated parameter."""
    jcfg, tcfg = configs(VL)
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    nb = batch_of(VL, tcfg, B=4, S=64)
    # eps 1e-3 keeps Adam's first step a smooth function of the gradient
    # (see test_torch_train.py)
    ocfg = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=4, eps=1e-3)
    jstep = jax.jit(JS.make_train_step(jcfg, JA.OptConfig(**ocfg),
                                       attn_impl="chunked", microbatches=2))
    jp, _, jm = jstep(jp, JA.init_opt_state(jp, JA.OptConfig(**ocfg)),
                      jx(nb))
    step = TS.make_train_step(tcfg, TA.OptConfig(**ocfg), attn_impl="kernel",
                              microbatches=2)
    tp, state, tm = step(tp, TA.init_opt_state(tp, TA.OptConfig(**ocfg)),
                         tx(nb))
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert_tree_close(tp, jp, rtol=1e-5, atol=1e-6)
