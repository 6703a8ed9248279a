"""Whole-model paged decode: the port's ``decode_step_paged`` against the
JAX package's over an 11-token teacher-forced prompt, token by token and
in chunks, for the JAX gather path and its Pallas kernel (interpret)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as JM  # noqa: E402
from repro.serve.paged_cache import PagedKVCache  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from test_torch_helpers import ARCH_IDS, PARITY_ARCHS, bridged, configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

# fp32 throughout; the two packages sum in different orders
TOL = dict(rtol=1e-4, atol=1e-4)

_jax_step = jax.jit(JM.decode_step_paged, static_argnums=(1,),
                    static_argnames=("attn_impl",))


@pytest.mark.parametrize("arch,patch", PARITY_ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("jax_impl", ["gather", "pallas"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_decode_step_paged_logits_match_jax(arch, patch, jax_impl, chunk):
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
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
        nf = np.full((B,), n, np.int32) if chunk > 1 else None
        for s in range(B):
            assert kv.ensure_capacity(s, n)
        bt, sl = kv.device_tables(), kv.seq_lens()
        jl, jpages = _jax_step(
            jp, jcfg, jpages, jnp.asarray(toks), jnp.asarray(bt),
            jnp.asarray(sl), attn_impl=jax_impl,
            num_feed=None if nf is None else jnp.asarray(nf))
        tl, tpages = TM.decode_step_paged(
            tp, tcfg, tpages, t(toks), t(bt), t(sl), attn_impl="kernel",
            num_feed=None if nf is None else t(nf))
        for s in range(B):
            for _ in range(n):
                kv.commit_token(s)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} step at token {i}")


def test_paged_cache_layout_matches_jax():
    jcfg, tcfg = configs("qwen2-7b", num_kv_heads=2)
    for jdt, tdt in [(jnp.bfloat16, torch.bfloat16), (jnp.int8, torch.int8)]:
        jc = JM.init_paged_cache(jcfg, 8, 16, jdt)
        tc = TM.init_paged_cache(tcfg, 8, 16, tdt, "cpu")
        jl = {k: v for k, v in jc["g0"]["s0_attn"].items()}
        tl = tc["g0"]["s0_attn"]
        assert set(jl) == set(tl)
        for k in jl:
            assert tuple(jl[k].shape) == tuple(tl[k].shape)
            np.testing.assert_array_equal(np.asarray(jl[k], np.float32),
                                          tl[k].float().numpy())
        assert tc["g0"]["s1_mlp"] == {}
    assert TM.paged_decode_supported(tcfg) == JM.paged_decode_supported(jcfg)
