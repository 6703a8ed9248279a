"""The dense serving path: ``attn_decode``, ``serve.step`` (prefill,
serve step, ``greedy_generate``) against the JAX package on bridged
weights, the serving launcher's fallback to it, and the serve step on a
2 x 2 ``(data, model)`` mesh of gloo ranks (``distributed.spmd.generate``:
the cache placed by ``sharding.cache_shardings``, sequence-sharded over
``model``, and over ``data`` too at batch 1) against the JAX
``make_serve_step`` on one device."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import step as JS  # noqa: E402
from repro_torch.distributed import runtime, spmd  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import step as TS  # noqa: E402

from test_torch_helpers import bridged, configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-4)
# (arch, patch, id): Mamba2 through ssm_decode; qwen2 (GQA g=2, QKV bias,
# RoPE) and OPT (learned positions, LayerNorm) through attn_decode
GEN_ARCHS = [("mamba2-130m", {}, "mamba2"),
             ("qwen2-7b", dict(num_kv_heads=2), "qwen2-g2"),
             ("opt-125m", {}, "opt-125m")]


@pytest.mark.parametrize("arch,patch,aid", GEN_ARCHS,
                         ids=[a[2] for a in GEN_ARCHS])
def test_greedy_generate_tokens_equal_jax(arch, patch, aid):
    """Prompt teacher-forced through the dense cache (bf16 K/V for
    attention, fp32 state for ssm, the JAX package's defaults), then 6
    greedy tokens: the ids must be equal."""
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
    prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 7))
    want = JS.greedy_generate(jp, jcfg, jnp.asarray(prompt), 6)
    got = TS.greedy_generate(tp, tcfg, t(prompt), 6)
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("index", [0, 5])
def test_attn_decode_matches_jax(index):
    jcfg, tcfg = configs("qwen2-7b", num_kv_heads=2)
    jp, tp = bridged(jcfg, tcfg)
    jattn = jax.tree.map(lambda a: a[0], jp["decoder"]["g0"]["s0_attn"])
    tattn = TM.P.tree_map(lambda a: a[0], tp["decoder"]["g0"]["s0_attn"])
    rs = np.random.RandomState(8)
    K, hd = jcfg.num_kv_heads, jcfg.resolved_head_dim
    ck = rs.randn(2, 8, K, hd).astype(np.float32)
    cv = rs.randn(2, 8, K, hd).astype(np.float32)
    x = rs.randn(2, 1, jcfg.d_model).astype(np.float32)
    pos = np.full((2, 1), index, np.int32)
    jy, jk, jv = JL.attn_decode(jattn, jnp.asarray(x), jcfg,
                                cache_k=jnp.asarray(ck),
                                cache_v=jnp.asarray(cv),
                                index=jnp.int32(index),
                                positions=jnp.asarray(pos))
    tk, tv = t(ck), t(cv)
    ty, tk2, tv2 = TL.attn_decode(tattn, t(x), tcfg, cache_k=tk, cache_v=tv,
                                  index=index, positions=t(pos))
    assert tk2 is tk and tv2 is tv              # written in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_prefill_and_serve_step_match_the_model_functions():
    _, tcfg = configs("mamba2-130m")
    tp = TM.P.init_params(tcfg, device="cpu", seed=2)
    toks = torch.from_numpy(np.random.RandomState(9).randint(
        0, tcfg.vocab_size, (2, 10)))
    logits = TS.make_prefill(tcfg)(tp, {"tokens": toks})
    assert logits.is_inference()
    with torch.no_grad():
        want = TM.forward_logits(tp, tcfg, {"tokens": toks},
                                 use_kernel=False)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)
    serve = TS.make_serve_step(tcfg)
    cache = TM.init_cache(tcfg, 2, 10, device="cpu")
    for i in range(10):
        lg, cache = serve(tp, cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(lg.numpy(), logits[:, -1].numpy(),
                               rtol=2e-3, atol=2e-4)
    assert TS.jitted_decode_step(tcfg) is TS.jitted_decode_step(tcfg)
    # an encoder-decoder's serve step takes ``enc`` (the legacy path that
    # re-projects the encoder K/V), and warm_cross_cache fills the cache
    # the steps without ``enc`` read: both give the same logits
    _, wcfg = configs("whisper-medium")
    wp = TM.P.init_params(wcfg, device="cpu", seed=3)
    frames = torch.from_numpy(np.random.RandomState(4).randn(
        2, wcfg.encoder_seq_len, wcfg.d_model).astype(np.float32))
    with torch.no_grad():
        enc = TM.encoder_forward(wp, wcfg, frames, {})
    wserve = TS.make_serve_step(wcfg)
    legacy = TM.init_cache(wcfg, 2, 4, torch.float32, "cpu")
    warmed = TM.warm_cross_cache(
        wp, wcfg, TM.init_cache(wcfg, 2, 4, torch.float32, "cpu"), enc)
    assert float(warmed["g0"]["s1_xattn"]["k"].abs().max()) > 0
    for i in range(4):
        a, legacy = wserve(wp, legacy, toks[:, i:i + 1], i, enc=enc)
        b, warmed = wserve(wp, warmed, toks[:, i:i + 1], i)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_dense_decode_refuses_unported_sublayers():
    """The dense decode runs cross-attention now (an encoder-length K/V
    cache, the warmed or the legacy path); the paged path still refuses
    it in both packages, as the engine refuses an encoder-decoder."""
    _, tcfg = configs("qwen2-7b", num_kv_heads=2)
    from repro.models import blocks as JB
    from repro_torch.bridge import flatten
    from repro_torch.models import blocks
    encdec = dataclasses.replace(tcfg, is_encoder_decoder=True,
                                 encoder_layers=1, encoder_seq_len=6)
    c = blocks.init_sublayer_cache("xattn", encdec, 1, 4, device="cpu")
    assert c["k"].shape == c["v"].shape == (
        1, 6, encdec.num_kv_heads, encdec.resolved_head_dim)
    p = TM.P.tree_map(lambda a: a[0], TM.P.init_params(
        encdec, device="cpu")["decoder"]["g0"]["s1_xattn"])
    x = torch.randn(1, 1, encdec.d_model)
    y, same = blocks._sublayer_decode("xattn", p, x, c, encdec, {})
    assert same is c and y.shape == x.shape
    enc = torch.randn(1, 6, encdec.d_model)
    y2, _ = blocks._sublayer_decode("xattn", p, x, c, encdec, {"enc": enc})
    assert y2.shape == x.shape and not torch.equal(y, y2)
    assert "['encoder']['final_norm']['scale']" in dict(
        flatten(TM.P.model_spec(encdec)))
    with pytest.raises(NotImplementedError, match="xattn"):
        JB.init_paged_sublayer_cache("xattn", encdec, 4, 4)
    with pytest.raises(NotImplementedError, match="xattn"):
        blocks.init_paged_sublayer_cache("xattn", encdec, 4, 4,
                                         device="cpu")
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    _, wcfg = configs("whisper-medium")
    wp = TM.P.init_params(wcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServeEngine(wp, wcfg, EngineConfig(), torch_device="cpu")


@pytest.mark.parametrize("argv,expect", [
    (["--arch", "mamba2-130m"], "mamba2-130m-smoke"),
    (["--legacy", "--batch", "3"], "qwen2-7b-smoke"),
], ids=["mamba2-fallback", "qwen2-legacy"])
def test_serve_launcher_legacy_path_on_the_cpu(argv, expect, tmp_path,
                                               capsys):
    from repro_torch.launch import serve
    out = tmp_path / "m.jsonl"
    serve.main(["--torch-device", "cpu", "--max-new", "4", "--prompt-len",
                "6", "--metrics-out", str(out), *argv])
    text = capsys.readouterr().out
    n = 3 if "--batch" in argv else 8
    assert expect in text and "cloud-h100" in text
    assert f"legacy dense: {4 * n} tokens" in text
    assert '"path": "legacy"' in out.read_text()


# --------------------------------------------------------------------------- #
# Decode on the mesh
# --------------------------------------------------------------------------- #

# (id, arch, patch, batch): batch 2 shards the cache's batch over data and
# its sequence over model; batch 1 its sequence over both.  deepseek-v3
# decodes through the absorbed MLA cache, mixtral through a sliding
# window shorter than the decoded sequence, whisper through the
# cross-attention caches warmed from an encoder output (its 64 rows
# sequence-sharded as the self-attention caches are)
MESH_CASES = [("qwen2-b2", "qwen2-7b", dict(num_kv_heads=2), 2),
              ("qwen2-b1", "qwen2-7b", dict(num_kv_heads=2), 1),
              ("mamba2-b2", "mamba2-130m", {}, 2),
              ("deepseek-b2", "deepseek-v3-671b", {}, 2),
              ("mixtral-window-b1", "mixtral-8x7b", dict(sliding_window=4), 1),
              ("whisper-b2", "whisper-medium", {}, 2)]
MESH_PROMPT, MESH_NEW, MESH_CACHE = 5, 4, 12


def mesh_prompt(cfg, batch):
    return np.random.RandomState(11).randint(
        0, cfg.vocab_size, (batch, MESH_PROMPT)).astype(np.int32)


def mesh_enc(cfg, batch):
    """An encoder output (B, encoder_seq_len, d) for encoder-decoders."""
    if not cfg.is_encoder_decoder:
        return None
    return np.random.RandomState(12).standard_normal(
        (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh_decoded():
    """One spawn of 2 x 2 CPU gloo ranks running every case's greedy
    decode (fp32 configs, so fp32 K/V caches)."""
    calls = []
    for _, arch, patch, batch in MESH_CASES:
        jcfg, tcfg = configs(arch, **patch)
        _, tp = bridged(jcfg, tcfg)
        calls.append(functools.partial(
            spmd.generate, cfg=tcfg, prompt=mesh_prompt(tcfg, batch),
            max_new=MESH_NEW, params=tp, cache_len=MESH_CACHE,
            enc=mesh_enc(tcfg, batch)))
    res = runtime.spawn(calls, shape=(2, 2), names=("data", "model"),
                        transport="gloo", device="cpu")
    return dict(zip([c[0] for c in MESH_CASES], res.values))


@pytest.mark.parametrize("cid", [c[0] for c in MESH_CASES])
def test_mesh_decode_matches_jax_serve_step(mesh_decoded, cid):
    """Every step's logits (the teacher-forced prompt, then the greedy
    tokens) against the JAX ``make_serve_step`` on one device at the
    dense path's bar, and the greedy ids equal.  The K/V caches are fp32
    in both: the model ranks sum the projections in another order, and a
    bf16 cache turns that last-bit difference into a rounding step of
    1e-3 relative in some K/V entries."""
    _, arch, patch, batch = next(c for c in MESH_CASES if c[0] == cid)
    jcfg, tcfg = configs(arch, **patch)
    jp, _ = bridged(jcfg, tcfg)
    prompt = mesh_prompt(tcfg, batch)
    step = jax.jit(JS.make_serve_step(jcfg))
    cache = JM.init_cache(jcfg, batch, MESH_CACHE, jnp.float32)
    enc = mesh_enc(tcfg, batch)
    if enc is not None:
        cache = JM.warm_cross_cache(jp, jcfg, cache, jnp.asarray(enc))
    want, ids = [], [prompt]
    tok = jnp.asarray(prompt[:, :1])
    for i in range(MESH_PROMPT + MESH_NEW - 1):
        logits, cache = step(jp, cache, tok, jnp.int32(i))
        want.append(np.asarray(logits))
        if i + 1 < MESH_PROMPT:
            tok = jnp.asarray(prompt[:, i + 1:i + 2])
        else:
            tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            ids.append(np.asarray(tok))
    values = mesh_decoded[cid]
    for v in values[1:]:                  # every rank decodes the same
        np.testing.assert_array_equal(v["ids"], values[0]["ids"])
    got = values[0]
    assert len(got["logits"]) == len(want)
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(got["ids"], np.concatenate(ids, axis=1))

