"""Blockwise int8 quantization: the port's kernel wrappers (their plain
versions on the CPU) against the JAX package's Pallas kernels (interpret
mode) and its jnp oracle, and the any-shape ``quantize`` / ``dequantize``
against the JAX wrappers.  The codes and scales must be equal, not close,
to the JAX functions as XLA compiles them: under ``jit`` XLA turns
``amax / 127.0`` into ``amax * (1/127)``, and the port computes that
product (the eager oracle's true division differs in the last bit of a
few percent of the scales; one test pins that down).  The CUDA kernels
are held against the plain versions in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant8 import kernel as jk  # noqa: E402
from repro.kernels.quant8 import ops as jops  # noqa: E402
from repro.kernels.quant8 import ref as jref  # noqa: E402
from repro_torch.kernels.quant8 import kernel as tk  # noqa: E402
from repro_torch.kernels.quant8 import ops as tops  # noqa: E402
from repro_torch.kernels.quant8 import ref as tref  # noqa: E402

from test_torch_cuda import (QUANT_CASES, QUANT_IDS,  # noqa: E402
                             SHAPES, quant_input)
from test_torch_helpers import t  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401


def _jax_padded(x, block):
    flat = x.reshape(-1)
    return jnp.asarray(np.pad(flat, (0, (-flat.shape[0]) % block)))


@pytest.mark.parametrize("n,block", QUANT_CASES, ids=QUANT_IDS)
def test_quantize_blocks_codes_and_scales_equal_jax(n, block):
    x = quant_input(n)
    before = (tk.quantize_blocks.launches, tk.dequantize_blocks.launches)
    q, s = tk.quantize_blocks(t(x), block=block)
    rows = -(-n // block)
    assert q.dtype == torch.int8 and q.shape == (rows * block,)
    assert s.dtype == torch.float32 and s.shape == (rows,)
    xp = _jax_padded(x, block)
    rq, rs = jax.jit(jref.quantize_reference, static_argnums=1)(xp, block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    out = tk.dequantize_blocks(q, s, block=block)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jref.dequantize_reference(rq, rs, block)))
    if rows % min(256, rows) == 0:        # a row count the TPU tile takes
        kq, ks = jk.quantize_blocks(xp, block=block, interpret=True)
        np.testing.assert_array_equal(q.numpy(), np.asarray(kq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ks))
        kd = jk.dequantize_blocks(kq, ks, block=block, interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(kd))
    # on the CPU the wrappers run their plain versions: nothing launched
    assert (tk.quantize_blocks.launches,
            tk.dequantize_blocks.launches) == before


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_any_shape_equals_jax(shape):
    x = quant_input(int(np.prod(shape)), seed=5).reshape(shape) * 2 / 3
    q, s, sh = tops.quantize(t(x))
    jq, js = jax.jit(lambda a: jops.quantize(a)[:2])(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    out = tops.dequantize(q, s, sh)
    assert sh == shape and out.shape == shape
    jd = jax.jit(lambda a, b: jops.dequantize(a, b, shape))(jq, js)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jd))


def test_scales_differ_from_the_eager_oracle_by_at_most_one_ulp():
    x = quant_input(65536)
    q, s = tk.quantize_blocks(t(x))
    eq, es = jref.quantize_reference(jnp.asarray(x))   # true division
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(es), maxulp=1)
    assert 0 < int((s.numpy() != np.asarray(es)).sum()) < 256 // 10
    np.testing.assert_array_equal(q.numpy(), np.asarray(eq))


def test_bf16_input_and_bf16_output_equal_jax():
    x = quant_input(3 * 256 + 17, seed=7)
    xb = x.astype(ml_dtypes.bfloat16)
    q, s = tk.quantize_blocks(t(xb.view(np.int16)).view(torch.bfloat16))
    rq, rs = jax.jit(jref.quantize_reference)(_jax_padded(xb, 256))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    out = tk.dequantize_blocks(q, s, dtype=torch.bfloat16)
    ref = np.asarray(jref.dequantize_reference(rq, rs, 256, jnp.bfloat16))
    np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                  ref.view(np.int16))


def test_all_zero_block_scales_to_one_and_codes_zero():
    x = quant_input(4 * 128, seed=8)
    x[128:256] = 0.0
    q, s = tk.quantize_blocks(t(x), block=128)
    assert float(s[1]) == 1.0 and int(q[128:256].abs().max()) == 0
    rq, rs = jax.jit(jref.quantize_reference, static_argnums=1)(
        jnp.asarray(x), 128)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


def test_round_half_to_even_and_symmetric_clamp():
    # x / scale lands on .5 exactly: codes round to even, and -amax maps
    # to -127, never -128
    x = np.zeros(128, np.float32)
    x[:5] = [127.0, 0.5, 1.5, 2.5, -127.0]
    q, s = tk.quantize_blocks(t(x), block=128)
    assert float(s[0]) == 1.0
    assert q[:5].tolist() == [127, 0, 2, 2, -127]
    rq, _ = tref.quantize_reference(t(x), 128)
    assert torch.equal(q, rq)


def test_wrappers_raise_on_a_device_they_do_not_take():
    x = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="not CUDA/CPU"):
        tk.quantize_blocks(x)
    with pytest.raises(ValueError, match="not CUDA/CPU"):
        tk.dequantize_blocks(torch.zeros(256, dtype=torch.int8,
                                         device="meta"),
                             torch.ones(1, device="meta"))
