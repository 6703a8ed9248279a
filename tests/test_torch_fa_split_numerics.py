"""The numerical design of the bf16 FA-2 forward, dq and dk/dv kernels
(``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``), checked on the
CPU by emulating their rounding in plain PyTorch.

The kernels run every product on the tensor cores, whose operands are
bf16 and whose sums are fp32.  q, k, v and do are bf16 already, so
q·kᵀ and do·vᵀ are exact products summed in fp32, as in the plain
versions.  P (forward and dV) and dS (dQ and dK) are fp32 values; each is
split into hi = bf16(x) and lo = bf16(x - hi) and both halves are
multiplied, which leaves a residual of at most 2**-18 of x.  The
emulation below holds that design to the bars the card test
``test_cuda_fa2_kernels_match_plain_versions`` applies to the kernels,
and records that a single bf16 rounding of P and dS, as FA-2 does it,
breaks them.  For dq on ``FA_CASES`` the hi + lo split stays within
2.6–4.5e-6 of dq's largest magnitude, while one rounding of dS puts dq
1.7–2.6e-3 of it off, past the 1e-4 bar in every case.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, visible)

from test_torch_cuda import FA_CASES, FA_IDS, fa_inputs  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

# the card test's bars: out after both sides round to bf16; dk and dv fp32
OUT_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _bf16_operand(x, split):
    """What the tensor cores multiply in place of the fp32 ``x``: the sum
    of a bf16 hi and lo pair, or x rounded once to bf16."""
    hi = x.to(torch.bfloat16).float()
    if split == "single":
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


def _emulated(q, k, v, do, lse, delta, causal, window, split):
    """(out, dq, dk, dv) with the kernels' roundings: fp32 scores and
    softmax, P and dS through ``_bf16_operand``, products summed in
    fp32."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    g, scale = H // K, 1.0 / D ** 0.5
    qf = q.float().reshape(B, K, g, S, D)
    dof = do.float().reshape(B, K, g, S, D)
    kf, vf = k.float(), v.float()
    ok = visible(S, T, causal=causal, window=window)
    s = (torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale).masked_fill(
        ~ok, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,bktd->bkgsd", _bf16_operand(p, split), vf) / l
    # the backward recomputes P from lse (masked entries are exactly 0)
    pb = torch.exp(s - lse.reshape(B, K, g, S, 1))
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = pb * (dp - delta.reshape(B, K, g, S, 1)) * scale
    dv = torch.einsum("bkgst,bkgsd->bktd", _bf16_operand(pb, split), dof)
    dsb = _bf16_operand(ds, split)
    dq = torch.einsum("bkgst,bktd->bkgsd", dsb, kf).reshape(B, H, S, D)
    dk = torch.einsum("bkgst,bkgsd->bktd", dsb, qf)
    return out.reshape(B, H, S, D).to(q.dtype), dq, dk, dv


def _within(a, b, rtol, atol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


@pytest.mark.parametrize("split", ["hi_lo", "single"])
@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_split_products_meet_the_card_bars(case, split):
    causal, window = case[5], case[6]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
                   for x in fa_inputs(case, seed=5))
    kw = dict(causal=causal, window=window)
    ref_out, lse = FK.attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ref_out.float()).sum(-1)
    ref_dq = FK.attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    ref_dk, ref_dv = FK.attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                 **kw)
    out, dq, dk, dv = _emulated(q, k, v, do, lse, delta, causal, window,
                                split)
    ok = {"out": _within(out.float(), ref_out.float(), **OUT_TOL),
          "dq": _within(dq, ref_dq, **GRAD_TOL),
          "dk": _within(dk, ref_dk, **GRAD_TOL),
          "dv": _within(dv, ref_dv, **GRAD_TOL)}
    if split == "hi_lo":
        assert all(ok.values()), ok
        # P and dS kept to fp32 within the split's residual: dq's and
        # dv's errors are a few millionths of their largest magnitudes
        for mine, ref in ((dq, ref_dq), (dv, ref_dv)):
            assert float((mine - ref).abs().max()) \
                <= 1e-5 * float(ref.abs().max())
    else:
        # one bf16 rounding of P and dS is why the kernels split: the
        # gradients leave their bars in every case, dq among them
        assert not (ok["dk"] and ok["dv"]), ok
        assert not ok["dq"], ok
