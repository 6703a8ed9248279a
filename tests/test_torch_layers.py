"""The port's layers against the JAX package's, on the same numpy inputs
and bridged weights: norms, RoPE, paged attention decode (scatter into
pages, int8 append, num_feed rows), the MLP, and the int8 KV codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant8 import ops as jq  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.kernels.quant8 import ops as tq  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from test_torch_helpers import ARCH_IDS, PARITY_ARCHS, bridged, configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _unit(tree, key):
    """First stacked layer's sublayer params."""
    return jax.tree.map(lambda a: a[0], tree["decoder"]["g0"][key])


def _tunit(tree, key):
    return {k: (v[0] if not isinstance(v, dict) else
                {kk: vv[0] for kk, vv in v.items()})
            for k, v in tree["decoder"]["g0"][key].items()}


@pytest.mark.parametrize("arch,patch", PARITY_ARCHS, ids=ARCH_IDS)
def test_norm_and_mlp_match_jax(arch, patch):
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
    x = np.random.RandomState(0).randn(2, 3, jcfg.d_model).astype(np.float32)
    jm, tm = _unit(jp, "s1_mlp"), _tunit(tp, "s1_mlp")
    np.testing.assert_allclose(
        TL.norm(tm["norm"], t(x), tcfg).numpy(),
        np.asarray(JL.norm(jm["norm"], jnp.asarray(x), jcfg)), **TOL)
    np.testing.assert_allclose(
        TL.mlp_forward(tm, t(x), tcfg).numpy(),
        np.asarray(JL.mlp_forward(jm, jnp.asarray(x), jcfg)), **TOL)


def test_norm_in_bf16_multiplies_in_input_dtype():
    jcfg, tcfg = configs("qwen2-7b", num_kv_heads=2)
    x = np.random.RandomState(1).randn(4, jcfg.d_model).astype(np.float32)
    scale = np.random.RandomState(2).rand(jcfg.d_model).astype(np.float32)
    out = TL.norm({"scale": t(scale, torch.bfloat16)},
                  t(x, torch.bfloat16), tcfg)
    ref = JL.norm({"scale": jnp.asarray(scale, jnp.bfloat16)},
                  jnp.asarray(x, jnp.bfloat16), jcfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 3, 64).astype(np.float32)
    pos = rs.randint(0, 4096, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(t(x), t(pos), theta).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        **TOL)


@pytest.mark.parametrize("arch,patch", PARITY_ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_attn_decode_paged_matches_jax(arch, patch, cache_dtype):
    """One chunked step (C=3, ragged num_feed, an idle slot) against a
    partly filled paged cache: same output, same pages."""
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
    ja, ta = _unit(jp, "s0_attn"), _tunit(tp, "s0_attn")
    rs = np.random.RandomState(4)
    B, C, bs, nb, P = 3, 3, 4, 4, 13
    K, hd = jcfg.num_kv_heads, jcfg.resolved_head_dim
    pages = rs.randn(2, P, bs, K, hd).astype(np.float32)
    jcache = {"k_pages": jnp.asarray(pages[0]),
              "v_pages": jnp.asarray(pages[1])}
    if cache_dtype == "int8":
        kq, ks = jq.quantize_kv(jcache["k_pages"])
        vq, vs = jq.quantize_kv(jcache["v_pages"])
        jcache = {"k_pages": kq, "v_pages": vq, "k_scale": ks, "v_scale": vs}
    tcache = {k: t(v) for k, v in jcache.items()}
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    sl = np.array([7, 2, 0], np.int32)
    nf = np.array([3, 1, 0], np.int32)
    x = rs.randn(B, C, jcfg.d_model).astype(np.float32)
    pos = sl[:, None] + np.arange(C)[None, :]
    jy, jc = JL.attn_decode_paged(
        ja, jnp.asarray(x), jcfg, cache=jcache, block_tables=jnp.asarray(bt),
        seq_lens=jnp.asarray(sl), positions=jnp.asarray(pos),
        num_feed=jnp.asarray(nf), impl="gather")
    ty, tc = TL.attn_decode_paged(
        ta, t(x), tcfg, cache=tcache, block_tables=t(bt), seq_lens=t(sl),
        positions=t(pos), num_feed=t(nf), impl="kernel")
    fed = np.arange(C)[None, :] < nf[:, None]
    np.testing.assert_allclose(ty.numpy()[fed], np.asarray(jy)[fed], **TOL)
    for key in jc:                        # real pages (the null page 0
        a, b = tc[key].numpy()[1:], np.asarray(jc[key])[1:]   # takes any)
        if key.endswith("pages") and cache_dtype == "int8":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


def test_quantize_kv_codes_and_scales_equal_jax():
    rs = np.random.RandomState(5)
    x = (rs.randn(7, 16, 2, 64) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # all-zero vector
    x[1, 0, 0] = 0.0                                  # scale 1: exact .5
    x[1, 0, 0, :5] = [127.0, 0.5, -0.5, 1.5, 2.5]     # ties, to even
    q, s = tq.quantize_kv(t(x))
    jqv, jsv = jq.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))
    np.testing.assert_array_equal(
        tq.dequantize_kv(q, s).numpy(),
        np.asarray(jq.dequantize_kv(jqv, jsv, jnp.float32)))


@pytest.mark.parametrize("arch,patch", PARITY_ARCHS, ids=ARCH_IDS)
def test_embedding_and_lm_head_match_jax(arch, patch):
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
    tok = np.random.RandomState(6).randint(0, jcfg.vocab_size, (2, 3))
    np.testing.assert_array_equal(
        TM.embed_tokens(tp, tcfg, t(tok)).numpy(),
        np.asarray(JM.embed_tokens(jp, jcfg, jnp.asarray(tok))))
    h = np.random.RandomState(7).randn(2, 3, jcfg.d_model).astype(
        np.float32)
    out = TM.lm_logits(tp, tcfg, t(h)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(JM.lm_logits(jp, jcfg, jnp.asarray(h))), **TOL)
    if jcfg.padded_vocab_size != jcfg.vocab_size:
        assert (out[..., jcfg.vocab_size:] == np.float32(-1e30)).all()
