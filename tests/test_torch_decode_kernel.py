"""Flash-decode over paged KV: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and its gather oracle.  The CUDA
kernel is held against the plain version in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import decode as jdecode  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode_paged)

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
