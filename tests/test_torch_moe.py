"""The port's mixture-of-experts layer against the JAX package's, on
bridged ``mixtral-8x7b-smoke`` weights (4 experts, top-2, d 256, expert
d_ff 512, here with a 6-token window and 2 KV heads): ``moe_forward``
per row (S > 1, with and without dropped tokens) and over the flat batch
(S == 1), with a shared expert and with GELU experts; then the whole
model's train loss with its aux loss, its logits and 11 teacher-forced
dense and paged decode steps; and the param counts of the full config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serve.paged_cache import PagedKVCache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

from test_torch_helpers import bridged, configs, t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

ARCH = "mixtral-8x7b"
PATCH = dict(sliding_window=6, num_kv_heads=2)
# model-level bars of tests/test_serve_engine.py::test_paged_vs_dense_decode_logits
TOL = dict(rtol=2e-4, atol=2e-4)


def moe_configs(**patch):
    jcfg, tcfg = configs(ARCH, **PATCH)
    if patch:
        moe_patch = {k: v for k, v in patch.items()
                     if k in ("num_shared_experts", "capacity_factor")}
        top = {k: v for k, v in patch.items() if k not in moe_patch}
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_patch), **top)
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_patch), **top)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def layer0(jp, tp):
    """The first layer's moe sublayer of both trees."""
    jl = jax.tree.map(lambda a: a[0], jp["decoder"]["g0"]["s1_moe"])
    tl = tree_map(lambda a: a[0], tp["decoder"]["g0"]["s1_moe"])
    return jl, tl


# (id, config patch, B, S, router bias): per-row dispatch without drops;
# per-row and flat with expert 0 preferred by every token, so it overflows
# its capacity; flat S == 1; a shared expert; GELU experts
MOE_CASES = [
    ("per-row", dict(capacity_factor=4.0), 2, 24, False),
    ("per-row-drops", {}, 2, 32, True),
    ("flat", {}, 6, 1, False),
    ("flat-drops", {}, 20, 1, True),
    ("shared-expert", dict(num_shared_experts=1), 2, 16, False),
    ("gelu", dict(mlp_activation="gelu"), 2, 16, False),
]


def _capture(monkeypatch, module, store):
    """Record the dispatch buffer ``module._expert_ffn`` is given."""
    ffn = module._expert_ffn

    def spy(p, buf, cfg):
        store.append(np.array(buf.detach() if hasattr(buf, "detach")
                              else buf))
        return ffn(p, buf, cfg)
    monkeypatch.setattr(module, "_expert_ffn", spy)


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_forward_matches_jax(case, monkeypatch):
    _, patch, B, S, biased = case
    jcfg, tcfg = moe_configs(**patch)
    jp, tp = bridged(jcfg, tcfg)
    jl, tl = layer0(jp, tp)
    x = np.random.RandomState(3).randn(B, S, jcfg.d_model).astype(np.float32)
    if biased:
        # a large first feature, read only by expert 0's router column
        x[..., 0] += 10.0
        router = np.array(jl["router"])
        router[0] = 0.0
        router[0, 0] = 1.0
        jl = dict(jl, router=jnp.asarray(router))
        tl = dict(tl, router=t(router))
    jbufs, tbufs = [], []
    _capture(monkeypatch, JMOE, jbufs)
    _capture(monkeypatch, TMOE, tbufs)
    jy, jaux = JMOE.moe_forward(jl, jnp.asarray(x), jcfg)
    ty, taux = TMOE.moe_forward(tl, t(x), tcfg)

    # the same assignments kept, in the same slots: the JAX buffer is
    # (B', E, C, d), the port's (E, B'·C, d); each filled slot holds its
    # token's normed h (the two norms differ in the last bits only, while
    # two tokens' rows differ by O(1)), empty ones zeros
    (jb,), (tb,) = jbufs, tbufs
    Bd, E, C, d = jb.shape
    tb = tb.reshape(E, Bd, C, d).transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(np.abs(tb).sum(-1) > 0,
                                  np.abs(jb).sum(-1) > 0)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-6)
    h = TMOE.norm(tl["norm"], t(x), tcfg)
    _, _, top_i = TMOE.router_probs(tl, h, tcfg)
    if S == 1:
        top_i = top_i.reshape(1, B, -1)
    _, keep, _, _ = TMOE.dispatch_plan(top_i, C, E)
    kept = int(keep.sum())
    assert kept == int((np.abs(jb).sum(-1) > 0).sum())
    k = jcfg.moe.experts_per_token
    if biased:
        assert kept < B * S * k                    # some were dropped
    else:
        assert kept == B * S * k

    jy = np.asarray(jy) - x
    ty = ty.numpy() - x
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_capacity_keeps_the_jax_rounding():
    _, tcfg = moe_configs()
    jcfg, _ = moe_configs()
    for n in (1, 2, 7, 8, 16, 33, 100, 8192):
        assert TMOE.capacity(n, tcfg) == JMOE.capacity(n, jcfg)
    assert TMOE.capacity(1, tcfg) == 8 and TMOE.capacity(33, tcfg) == 24


def test_bridge_carries_the_moe_leaves():
    jcfg, tcfg = moe_configs(num_shared_experts=1)
    jp, tp = bridged(jcfg, tcfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    jkeys = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in flat}
    tkeys = {k: tuple(v.shape) for k, v in bridge.flatten(tp)}
    assert tkeys == jkeys
    moe_keys = [k for k in tkeys if "s1_moe" in k]
    for leaf in ("router", "wi", "wg", "wo", "shared_wi", "shared_wg",
                 "shared_wo"):
        assert any(k.endswith(f"['{leaf}']") for k in moe_keys), leaf
    back = bridge.params_to_numpy(tp)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("arch,layers", [("mixtral-8x7b", None),
                                         ("mixtral-8x7b", 16),
                                         ("mixtral-8x7b-smoke", None)])
def test_param_counts_total_and_active_equal_jax(arch, layers):
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    want = {None: (46_702_792_704, 12_879_138_816),
            16: (23_482_470_400, 6_570_643_456)}
    if arch == "mixtral-8x7b":
        assert (tcfg.param_count(), tcfg.active_param_count()) == want[layers]


def _batch(cfg, B=2, S=12, seed=5):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def test_forward_train_loss_and_aux_match_jax():
    jcfg, tcfg = moe_configs()
    jp, tp = bridged(jcfg, tcfg)
    toks, labels = _batch(jcfg)
    jloss, jm = JM.forward_train(jp, jcfg, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)})
    tloss, tm = TM.forward_train(tp, tcfg, {"tokens": t(toks),
                                            "labels": t(labels)})
    assert float(jm["aux_loss"]) > 0
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


def test_forward_logits_match_jax():
    jcfg, tcfg = moe_configs()
    jp, tp = bridged(jcfg, tcfg)
    toks, _ = _batch(jcfg, S=16)
    jl = JM.forward_logits(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl = TM.forward_logits(tp, tcfg, {"tokens": t(toks)},
                               attn_impl="kernel")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_steps_match_jax(paged):
    """11 teacher-forced tokens, one a step (S == 1: the flat dispatch),
    through the dense cache or the paged one; the window of 6 cuts in
    from the seventh."""
    jcfg, tcfg = moe_configs()
    jp, tp = bridged(jcfg, tcfg)
    B, S, bs, nblocks = 2, 11, 4, 12
    prompt = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, S)
                                              ).astype(np.int32)
    if paged:
        kv = PagedKVCache(num_blocks=nblocks, block_size=bs, max_slots=B,
                          max_blocks_per_seq=4)
        jc = JM.init_paged_cache(jcfg, nblocks, bs, jnp.float32)
        tc = TM.init_paged_cache(tcfg, nblocks, bs, torch.float32, "cpu")
        for s in range(B):
            kv.open_slot(s)
    else:
        jc = JM.init_cache(jcfg, B, 16, jnp.float32)
        tc = TM.init_cache(tcfg, B, 16, torch.float32, "cpu")
    for i in range(S):
        toks = prompt[:, i:i + 1]
        if paged:
            for s in range(B):
                assert kv.ensure_capacity(s)
            bt, sl = kv.device_tables(), kv.seq_lens()
            jl, jc = JM.decode_step_paged(jp, jcfg, jc, jnp.asarray(toks),
                                          jnp.asarray(bt), jnp.asarray(sl))
            with torch.no_grad():
                tl, tc = TM.decode_step_paged(tp, tcfg, tc, t(toks), t(bt),
                                              t(sl))
            for s in range(B):
                kv.commit_token(s)
        else:
            jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(toks),
                                    jnp.int32(i))
            with torch.no_grad():
                tl, tc = TM.decode_step(tp, tcfg, tc, t(toks), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")


def test_paged_chunk_steps_match_jax_with_padding_rows():
    """Chunks of 4 (the per-row dispatch) with a ragged last chunk, whose
    rows past ``num_feed`` are routed and take capacity, as in JAX."""
    jcfg, tcfg = moe_configs()
    jp, tp = bridged(jcfg, tcfg)
    B, S, chunk, bs, nblocks = 2, 11, 4, 4, 12
    prompt = np.random.RandomState(2).randint(0, jcfg.vocab_size, (B, S))
    kv = PagedKVCache(num_blocks=nblocks, block_size=bs, max_slots=B,
                      max_blocks_per_seq=4)
    jc = JM.init_paged_cache(jcfg, nblocks, bs, jnp.float32)
    tc = TM.init_paged_cache(tcfg, nblocks, bs, torch.float32, "cpu")
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
        jl, jc = JM.decode_step_paged(jp, jcfg, jc, jnp.asarray(toks),
                                      jnp.asarray(bt), jnp.asarray(sl),
                                      num_feed=jnp.asarray(nf))
        with torch.no_grad():
            tl, tc = TM.decode_step_paged(tp, tcfg, tc, t(toks), t(bt),
                                          t(sl), num_feed=t(nf))
        for s in range(B):
            for _ in range(n):
                kv.commit_token(s)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"chunk at token {i}")


def test_mixtral_takes_the_paged_engine_path():
    jcfg, tcfg = moe_configs()
    assert TM.paged_decode_supported(tcfg) and \
        JM.paged_decode_supported(jcfg)
    assert TM.paged_decode_supported(torch_config(ARCH))

