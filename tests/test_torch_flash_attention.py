"""FA-2 attention: the port's plain kernel versions against the JAX
package's Pallas kernels (interpret mode), the autograd wiring against
``jax.grad`` through the Pallas custom VJP, and the chunked twin against
the JAX chunked twin.  The CUDA kernels are held against the plain
versions in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import kernel as JK  # noqa: E402
from repro.kernels.flash_attention.chunked import (  # noqa: E402
    chunked_attention as j_chunked)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as j_flash)
from repro_torch.kernels.flash_attention import kernel as TK  # noqa: E402
from repro_torch.kernels.flash_attention.chunked import (  # noqa: E402
    chunked_attention)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference)

from test_torch_cuda import FA_CASES, FA_IDS, fa_inputs  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

# the JAX package's own bars (tests/test_kernels.py): forward 2e-6 in
# fp32 and 2e-2 in bf16, gradients 1e-3
FWD_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
GRAD_TOL = 1e-3
# bf16 gradients: both sides compute in fp32 from the same bf16 inputs and
# round once at the end, so they differ by at most one bf16 step, which is
# 2**-7 of the value
BF16_STEP = 2.0 ** -7
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bhsd(case, dtype, seed=0):
    """numpy (B,H,S,D) q, (B,K,T,D) k/v, do, in both frameworks."""
    q, k, v, do = fa_inputs(case, seed)
    tr = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    arrs = [tr(x) for x in (q, k, v, do)]
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_plain_forward_matches_pallas(case, dtype):
    B, S, H, K, D, causal, window = case[:7]
    (jq, jk, jv, _), (tq, tk, tv, _) = _bhsd(case, dtype)
    jo, jl = JK._fwd_bhsd(jq, jk, jv, causal, window, 1.0 / D ** 0.5,
                          128, 128, True)
    to, tl = TK.flash_attention_fwd(tq, tk, tv, causal=causal,
                                    window=window)
    assert to.dtype == TDT[dtype] and tl.dtype == torch.float32
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=tol, atol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_plain_backward_matches_pallas(case, dtype):
    B, S, H, K, D, causal, window = case[:7]
    T = case[7] if len(case) > 7 else S
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _bhsd(case, dtype)
    scale = 1.0 / D ** 0.5
    jo, jl = JK._fwd_bhsd(jq, jk, jv, causal, window, scale, 128, 128, True)
    jdq, jdk, jdv = JK._bwd_bhsd(jq, jk, jv, jo, jl, jdo, causal, window,
                                 scale, 128, 128, True)
    # the same residuals on both sides: the JAX forward's out and lse
    to = torch.from_numpy(_f32(jo).copy()).to(TDT[dtype])
    tl = torch.from_numpy(np.asarray(jl))
    delta = (tdo.float() * to.float()).sum(-1)
    kw = dict(causal=causal, window=window)
    dq = TK.flash_attention_bwd_dq(tq, tk, tv, tdo, tl, delta, **kw)
    dk, dv = TK.flash_attention_bwd_dkdv(tq, tk, tv, tdo, tl, delta, **kw)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    assert dk.shape == (B, K, T, D) and dv.shape == (B, K, T, D)
    for name, mine, ref in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        if dtype == "float32":
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(_f32(mine.to(torch.bfloat16)),
                                       _f32(ref), rtol=BF16_STEP,
                                       atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_autograd_function_matches_pallas_vjp(case):
    causal, window = case[5], case[6]
    q, k, v, w = fa_inputs(case, seed=7)

    def jfwd(*a):
        return j_flash(*a, causal=causal, window=window, interpret=True)
    jo, vjp = jax.vjp(jfwd, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(w))
    tx = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*tx, causal=causal, window=window)
    out.backward(torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               rtol=FWD_TOL["float32"],
                               atol=FWD_TOL["float32"])
    for name, t, j in zip(("dq", "dk", "dv"), tx, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_autograd_bf16_primals_get_bf16_grads():
    q, k, v, _ = fa_inputs((1, 128, 4, 2, 64, True, 0), seed=8)
    tx = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
          for x in (q, k, v)]
    flash_attention(*tx, causal=True).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in tx)
    assert all(torch.isfinite(t.grad.float()).all() for t in tx)


@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_chunked_matches_jax_chunked_with_grads(case):
    causal, window = case[5], case[6]
    q, k, v, w = fa_inputs(case, seed=1)

    def jloss(*a):
        return (j_chunked(*a, causal=causal, window=window, chunk=64)
                * jnp.asarray(w)).sum()
    jo = j_chunked(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                   window=window, chunk=64)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tx = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = chunked_attention(*tx, causal=causal, window=window, chunk=64)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               rtol=2e-5, atol=2e-5)
    ref = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(),
                               rtol=2e-5, atol=2e-5)
    for name, t, j in zip(("dq", "dk", "dv"), tx, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_chunked_bf16_keeps_dtypes():
    q, k, v, _ = fa_inputs((1, 130, 2, 2, 96, True, 0), seed=2)
    tx = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
          for x in (q, k, v)]
    out = chunked_attention(*tx, causal=True, chunk=64)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in tx)


def test_wrappers_reject_devices_without_a_kernel():
    q = torch.zeros((1, 2, 8, 32), device="meta")
    for fn in (lambda: TK.flash_attention_fwd(q, q, q),
               lambda: TK.flash_attention_bwd_dq(q, q, q, q, q[..., 0],
                                                 q[..., 0]),
               lambda: TK.flash_attention_bwd_dkdv(q, q, q, q, q[..., 0],
                                                   q[..., 0])):
        with pytest.raises(ValueError, match="not CUDA/CPU"):
            fn()


def test_launch_counters_count_only_kernel_launches():
    fns = (TK.flash_attention_fwd, TK.flash_attention_bwd_dq,
           TK.flash_attention_bwd_dkdv)
    before = [f.launches for f in fns]
    q, k, v, _ = fa_inputs((1, 64, 2, 1, 32, True, 0), seed=3)
    tx = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    flash_attention(*tx).sum().backward()              # CPU: plain versions
    assert [f.launches for f in fns] == before


def test_bf16_params_need_rows_on_16_bytes():
    """The bf16 tensor-core kernels copy and read every row 16 bytes at a
    time: the parameter block refuses a bf16 view that starts one element
    on or whose row stride is not a multiple of 8, takes the (B, S, H, D)
    projections seen through transpose(1, 2), and leaves fp32 (the CUDA-core
    kernels) free."""
    B, S, H, D = 2, 64, 4, 64
    n = B * S * H * D
    flat = torch.zeros(n + 8 * B * S, dtype=torch.bfloat16)
    good = flat[:n].view(B, S, H, D).transpose(1, 2)
    off = flat[1:n + 1].view(B, S, H, D).transpose(1, 2)
    padded = flat[:B * S * (H * D + 4)].view(B, S, H * D + 4)[..., :H * D] \
        .unflatten(-1, (H, D)).transpose(1, 2)
    TK._params(good, good, good, True, 0, None, dout=good)
    for kw in ({"q": off}, {"k": off}, {"v": padded}, {"dout": off}):
        args = {"q": good, "k": good, "v": good, "dout": good, **kw}
        with pytest.raises(ValueError, match="16 bytes"):
            TK._params(args["q"], args["k"], args["v"], True, 0, None,
                       dout=args["dout"])
    f32 = [t.float() for t in (off, padded)]
    TK._params(f32[0], f32[1], f32[1], True, 0, None)


# MLA's head widths (qk D, v Dv): deepseek-v3-671b-smoke's 96 / 64, here
# with GQA and S not a multiple of the 128-row Pallas blocks, and the full
# model's 192 / 128
MLA_CASES = [(1, 130, 4, 2, 96, True, 0, None, 64),
             (1, 100, 2, 1, 192, True, 0, None, 128)]
MLA_IDS = ["qk96-v64", "qk192-v128"]


@pytest.mark.parametrize("case", MLA_CASES, ids=MLA_IDS)
def test_dv_unlike_d_matches_pallas_flash_core_and_vjp(case):
    """Forward and VJP of :class:`FlashAttention` on the CPU against the
    JAX ``_flash_core`` (Pallas in interpret mode) with Dv != D.  Both
    compute in fp32 from the same inputs and differ in summation order
    only: each output within 1e-5 of its largest magnitude."""
    B, S, H, K, D, causal, window = case[:7]
    Dv = case[8]
    q, k, v, w = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                  for x in fa_inputs(case, seed=9))
    scale = 1.0 / D ** 0.5

    def jfwd(*a):
        return JK._flash_core(*a, causal, window, scale, 128, 128, True)
    jo, vjp = jax.vjp(jfwd, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(w))
    tx = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = TK.flash_attention_bhsd(*tx, causal=causal, window=window)
    out.backward(torch.from_numpy(w))
    assert out.shape == (B, H, S, Dv)
    assert tx[2].grad.shape == (B, K, S, Dv)
    for name, mine, ref in (("out", out.detach(), jo),
                            *zip(("dq", "dk", "dv"),
                                 (t.grad for t in tx), jg)):
        ref = np.asarray(ref)
        err = float(np.abs(mine.numpy() - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()), (name, err)


def test_params_take_dv_unlike_d():
    """The parameter block carries the value width beside the head width;
    v must share k's (B, K, T) and do q's (B, H, S) with Dv columns."""
    q = torch.zeros((2, 4, 50, 96))
    k = torch.zeros((2, 2, 70, 96))
    v = torch.zeros((2, 2, 70, 64))
    do = torch.zeros((2, 4, 50, 64))
    p = TK._params(q, k, v, True, 0, None, dout=do)
    assert (p.D, p.Dv, p.group, p.S, p.T) == (96, 64, 2, 50, 70)
    assert p.scale == pytest.approx(1.0 / 96 ** 0.5)
    with pytest.raises(ValueError, match="k/v shapes"):
        TK._params(q, k, v[:, :, :60], True, 0, None)
    with pytest.raises(ValueError, match="do "):
        TK._kernel_inputs(q, k, v, torch.zeros((2, 4, 50, 96)))
    with pytest.raises(ValueError, match="not in"):
        TK._params(q, k, torch.zeros((2, 2, 70, 80)), True, 0, None)


@pytest.mark.parametrize("D,Dv", [(200, 128), (192, 136), (256, 256)])
def test_widths_past_the_limit_raise_naming_it(D, Dv):
    q, k = torch.zeros((1, 2, 8, D)), torch.zeros((1, 1, 8, D))
    v = torch.zeros((1, 1, 8, Dv))
    with pytest.raises(ValueError, match="limit D <= 192, Dv <= 128"):
        TK.padded_dims(D, Dv)
    with pytest.raises(ValueError, match="limit D <= 192, Dv <= 128"):
        TK._kernel_inputs(q, k, v)


# (case, the instantiated pair the wrapper pads it to)
PAD_CASES = [((1, 70, 4, 2, 80, True, 0), (96, 96)),
             ((2, 50, 2, 1, 48, False, 0, 90, 40), (64, 64)),
             ((1, 66, 4, 2, 160, True, 0, None, 100), (192, 128)),
             ((1, 40, 2, 2, 24, True, 16), (32, 32))]
PAD_IDS = ["80-to-96", "cross-48-40-to-64", "160-100-to-192-128",
           "window-24-to-32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,pair", PAD_CASES, ids=PAD_IDS)
def test_zero_padding_leaves_every_output_exact(case, pair, dtype):
    """The wrapper's zero-padded q, k, v and do (the kernels' inputs at a
    width with no instantiation) through the plain versions, sliced back,
    equal the unpadded outputs exactly: the zero columns add exact zeros
    to every score and produce zero columns of out, dq, dk and dv."""
    q, k, v, do = (torch.from_numpy(x).to(TDT[dtype]).transpose(1, 2)
                   for x in fa_inputs(case, seed=3))
    qp, kp, vp, dop, D, Dv, padded = TK._kernel_inputs(q, k, v, do)
    assert padded and (qp.shape[-1], vp.shape[-1]) == pair
    assert kp.shape[-1] == pair[0] and dop.shape[-1] == pair[1]
    assert TK.padded_dims(D, Dv) == pair
    kw = dict(causal=case[5], window=case[6], scale=1.0 / D ** 0.5)
    out, lse = TK.attention_fwd_plain(q, k, v, **kw)
    outp, lsep = TK.attention_fwd_plain(qp, kp, vp, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = TK.attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dqp = TK.attention_bwd_dq_plain(qp, kp, vp, dop, lsep, delta, **kw)
    dk, dv = TK.attention_bwd_dkdv_plain(q, k, v, do, lse, delta, **kw)
    dkp, dvp = TK.attention_bwd_dkdv_plain(qp, kp, vp, dop, lsep, delta,
                                           **kw)
    assert torch.equal(lse, lsep)
    for name, a, b in (("out", out, outp), ("dq", dq, dqp), ("dk", dk, dkp),
                       ("dv", dv, dvp)):
        w = a.shape[-1]
        assert torch.equal(a, b[..., :w]), name
        assert not bool(b[..., w:].any()), name
