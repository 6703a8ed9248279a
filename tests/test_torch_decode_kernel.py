"""Flash-decode over paged KV: the port's plain version and the plain twin
of its kernels' split-and-merge arithmetic against the JAX package's
Pallas kernel (interpret mode) and its gather oracle, and the split
planner's independence of ``seq_lens``.  The CUDA kernels are held
against the plain version in ``test_torch_cuda.py``."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import decode as jdecode  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    decode_splits, flash_decode_paged, flash_decode_split_plain)

from test_torch_cuda import CASES, IDS, inputs  # noqa: E402
from test_torch_helpers import t  # noqa: E402


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_paged_attention_matches_jax(case):
    H, K, D, bs, lens, window, C, quant = case
    q, kp, vp, bt, sl, sc = inputs(H, K, D, bs, lens, C, quant)
    out = flash_decode_paged(t(q), t(kp), t(vp), t(bt), t(sl),
                             window=window,
                             **{k: t(v) for k, v in sc.items()}).numpy()
    assert np.isfinite(out).all()
    jsc = {k: jnp.asarray(v) for k, v in sc.items()}
    jk = np.asarray(jdecode.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(sl), window=window, pages_per_split=3, interpret=True,
        **jsc))
    jr = np.asarray(jdecode.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(sl), window=window, **jsc))
    # rows with no valid position (a seq_len=0 slot's first row) are left
    # undefined by both JAX versions; the port gives them zeros
    valid = np.asarray(lens)[:, None] + np.arange(C)[None, :]   # (B, C)
    o4, k4, r4 = (x.reshape(len(lens), C, H, -1) for x in (out, jk, jr))
    live = valid > 0
    np.testing.assert_allclose(o4[live], k4[live], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o4[live], r4[live], rtol=2e-5, atol=2e-5)
    assert not o4[~live].any()


def test_wrapper_rejects_devices_without_a_kernel():
    q = torch.zeros((1, 2, 8), device="meta")
    pages = torch.zeros((2, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="not CUDA/CPU"):
        flash_decode_paged(q, pages, pages,
                           torch.zeros((1, 1), dtype=torch.int32,
                                       device="meta"),
                           torch.ones((1,), dtype=torch.int32,
                                      device="meta"))


def test_launch_counter_counts_only_kernel_launches():
    before = flash_decode_paged.launches
    q, kp, vp, bt, sl, _ = inputs(4, 2, 32, 4, (5, 9), 1, False)
    flash_decode_paged(t(q), t(kp), t(vp), t(bt), t(sl))
    assert flash_decode_paged.launches == before   # CPU: plain version


@pytest.mark.parametrize("pps", [None, 3], ids=["planned", "pps3"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_twin_matches_jax(case, pps):
    """The kernels' split-and-merge arithmetic (a partial per split, then
    the merge kernel's logsumexp rescale), in plain PyTorch, against the
    JAX Pallas kernel in interpret mode and its gather oracle."""
    H, K, D, bs, lens, window, C, quant = case
    q, kp, vp, bt, sl, sc = inputs(H, K, D, bs, lens, C, quant)
    out = flash_decode_split_plain(
        t(q), t(kp), t(vp), t(bt), t(sl), window=window,
        pages_per_split=pps, **{k: t(v) for k, v in sc.items()}).numpy()
    jsc = {k: jnp.asarray(v) for k, v in sc.items()}
    jk = np.asarray(jdecode.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(sl), window=window, pages_per_split=3, interpret=True,
        **jsc))
    valid = np.asarray(lens)[:, None] + np.arange(C)[None, :]
    o4, k4 = (x.reshape(len(lens), C, H, -1) for x in (out, jk))
    live = valid > 0
    np.testing.assert_allclose(o4[live], k4[live], rtol=2e-5, atol=2e-5)
    assert not o4[~live].any()


def test_split_count_depends_on_shapes_only():
    """The split count comes from (B, K, table width, SM count) and
    nothing else, so the kernels' grid is the same for any seq_lens; at
    the engine's shape (B 8, K 4) it puts at least two blocks on each of
    132 SMs."""
    assert list(inspect.signature(decode_splits).parameters) == [
        "B", "K", "nb", "sm_count", "pages_per_split"]
    for nb in (9, 16, 128, 129, 2048):
        pps, splits = decode_splits(8, 4, nb, 132)
        assert splits == -(-nb // pps) and pps * splits >= nb
        assert 8 * 4 * splits >= 2 * 132 or splits == nb
    assert decode_splits(8, 4, 128, 132, pages_per_split=3) == (3, 43)
