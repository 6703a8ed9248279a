"""The SSD scan: the port's plain oracle (``segsum``, ``ssd_reference``,
``ssd_step``) and its kernel wrapper's plain version (``ops.ssd``, which is
what a CPU tensor runs) against the JAX package's, on inputs made from a
seed with numpy.  The JAX kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan import ref as JR  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as TK  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as TR  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

# b, s, h, g, p, n, chunk — the JAX package's SSD_CASES
# (tests/test_kernels.py): one group, g=2, g=4 with a ragged s=100, and a
# 128-chunk
SSD_CASES = [
    (2, 256, 4, 1, 64, 32, 64),
    (1, 128, 8, 2, 32, 128, 32),
    (2, 100, 4, 4, 64, 16, 32),
    (1, 512, 2, 1, 128, 64, 128),
]
SSD_IDS = ["g1-c64", "g2-n128", "g4-ragged100", "p128-c128"]
# fp32 oracle parity: the same algorithm in two frameworks, summed in
# another order
TOL = dict(rtol=1e-5, atol=1e-5)


def assert_scaled_close(got, want, tol=1e-5):
    """|got - want| <= tol x the largest |want| (at least 1).  The scan's
    outputs reach ~100 while its decays exp(cs_i - cs_j) carry the
    rounding of cumsums of up to a chunk of terms, whose order differs
    between the frameworks; measured 2-3e-6 of the largest |y| on
    SSD_CASES."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def ssd_inputs(b, s, h, g, p, n, seed=0):
    """numpy fp32 x, dt = softplus(normal), A = -exp(normal), B, C with
    the JAX package's test distributions."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, p).astype(np.float32)
    dt = np.logaddexp(rs.randn(b, s, h), 0).astype(np.float32)
    A = -np.exp(rs.randn(h)).astype(np.float32)
    B = rs.randn(b, s, g, n).astype(np.float32)
    C = rs.randn(b, s, g, n).astype(np.float32)
    return x, dt, A, B, C


def t(*arrays):
    out = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


def test_segsum_matches_jax():
    x = np.random.RandomState(0).randn(3, 2, 17).astype(np.float32)
    np.testing.assert_allclose(TR.segsum(t(x)).numpy(),
                               np.asarray(JR.segsum(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_reference_matches_jax(case):
    b, s, h, g, p, n, chunk = case
    arrs = ssd_inputs(b, s, h, g, p, n)
    want = JR.ssd_reference(*map(jnp.asarray, arrs), chunk)
    got = TR.ssd_reference(*t(*arrs), chunk)
    assert_scaled_close(got.numpy(), want)


def test_ssd_reference_initial_and_final_state_match_jax():
    b, s, h, g, p, n, chunk = 2, 70, 4, 2, 16, 8, 32
    arrs = ssd_inputs(b, s, h, g, p, n, seed=1)
    init = np.random.RandomState(2).randn(b, h, p, n).astype(np.float32)
    wy, wf = JR.ssd_reference(*map(jnp.asarray, arrs), chunk,
                              initial_state=jnp.asarray(init),
                              return_final_state=True)
    gy, gf = TR.ssd_reference(*t(*arrs), chunk, initial_state=t(init),
                              return_final_state=True)
    assert_scaled_close(gy.numpy(), wy)
    assert_scaled_close(gf.numpy(), wf)


def test_ssd_step_matches_jax():
    b, h, g, p, n = 2, 4, 2, 16, 8
    rs = np.random.RandomState(3)
    state = rs.randn(b, h, p, n).astype(np.float32)
    x = rs.randn(b, h, p).astype(np.float32)
    dt = np.logaddexp(rs.randn(b, h), 0).astype(np.float32)
    A = -np.exp(rs.randn(h)).astype(np.float32)
    B = rs.randn(b, g, n).astype(np.float32)
    C = rs.randn(b, g, n).astype(np.float32)
    arrs = (state, x, dt, A, B, C)
    wy, ws = JR.ssd_step(*map(jnp.asarray, arrs))
    gy, gs = TR.ssd_step(*t(*arrs))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_wrapper_matches_jax_kernel(case, dtype):
    """ops.ssd on CPU tensors (the kernel's plain version) against the
    JAX Pallas kernel in interpret mode, with tests/test_kernels.py's
    bar: relative to the largest |y|, 1e-4 in fp32 and 5e-2 in bf16."""
    b, s, h, g, p, n, chunk = case
    x, dt, A, B, C = ssd_inputs(b, s, h, g, p, n, seed=4)
    jdt = getattr(jnp, dtype)
    want = jax_ssd(jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
                   jnp.asarray(B, jdt), jnp.asarray(C, jdt), chunk,
                   interpret=True)
    tdt = getattr(torch, dtype)
    xt, dtt, At, Bt, Ct = t(x, dt, A, B, C)
    got = ssd(xt.to(tdt), dtt, At, Bt.to(tdt), Ct.to(tdt), chunk)
    assert got.dtype == tdt and got.shape == (b, s, h, p)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-6
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_plain_version_matches_reference_in_fp32(case):
    """The kernel's plain version (loop over chunks, ragged tail shorter)
    and the block-decomposed oracle compute the same scan."""
    b, s, h, g, p, n, chunk = case
    x, dt, A, B, C = t(*ssd_inputs(b, s, h, g, p, n, seed=5))
    got = ssd(x, dt, A, B, C, chunk)
    assert_scaled_close(got.numpy(), TR.ssd_reference(x, dt, A, B, C,
                                                      chunk).numpy())


def test_recurrence_equals_full_scan():
    """ssd_step over every position == the chunked scan (and its final
    state), in the port alone."""
    b, s, h, g, p, n = 1, 37, 4, 2, 16, 8
    x, dt, A, B, C = t(*ssd_inputs(b, s, h, g, p, n, seed=6))
    full, final = TR.ssd_reference(x, dt, A, B, C, chunk_size=8,
                                   return_final_state=True)
    state = torch.zeros(b, h, p, n)
    ys = []
    for i in range(s):
        y, state = TR.ssd_step(state, x[:, i], dt[:, i], A, B[:, i], C[:, i])
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), final.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_wrapper_reads_strided_views_and_writes_a_transposed_view():
    b, s, h, g, p, n, chunk = 2, 40, 4, 2, 8, 8, 16
    x, dt, A, B, C = t(*ssd_inputs(b, s, h, g, p, n, seed=7))
    before = TK.ssd_bhcq.launches
    y = TK.ssd_bhcq(x.transpose(1, 2), dt.transpose(1, 2), A,
                    B.transpose(1, 2), C.transpose(1, 2), chunk=chunk)
    assert TK.ssd_bhcq.launches == before       # CPU: the plain version
    assert y.shape == (b, h, s, p) and y.transpose(1, 2).is_contiguous()
    assert_scaled_close(y.transpose(1, 2).numpy(),
                        TR.ssd_reference(x, dt, A, B, C, chunk).numpy())


def test_wrapper_refuses_autograd_and_other_devices():
    x, dt, A, B, C = t(*ssd_inputs(1, 16, 2, 1, 8, 8, seed=8))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd(x.requires_grad_(True), dt, A, B, C, 8)
    with torch.no_grad():
        assert ssd(x, dt, A, B, C, 8).shape == x.shape
    meta = [a.detach().to("meta") for a in (x, dt, A, B, C)]
    with pytest.raises(ValueError, match="not CUDA/CPU"):
        ssd(*meta, 8)
    with pytest.raises(ValueError, match="groups"):
        ssd(x.detach(), dt, A[:1].expand(2), B.expand(1, 16, 3, 8), C.expand(
            1, 16, 3, 8), 8)
