"""The numerical design of the bf16 SSD-scan kernels
(``csrc/ssd_scan.cu``), checked on the CPU by emulating their rounding in
plain PyTorch, and the chunk-parallel state pass against the sequential
recurrence.

With bf16 inputs the kernels run every product on the tensor cores,
whose operands are bf16 and whose sums are fp32.  x, B and C are exact
bf16; the other operand of each product is fp32: x o w in the chunk's
state increment (x o w)^T B, the masked and scaled score tile
G = (C B^T) o L o dt_j in G x, and the state S in C S^T.  Each is split
into hi = bf16(v) and lo = bf16(v - hi) and both halves are multiplied.
The emulation holds that design within 1e-4 of the largest magnitude of
y and of the states on the JAX package's SSD_CASES (the card test's bar
for a bf16 y is one bf16 rounding, 2**-7 of it), and records that a
single bf16 rounding of those operands, as a plain bf16 GEMM would do,
misses that 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import kernel as K  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as R  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import exp_fp64  # noqa: E402

from test_torch_ssd_scan import SSD_CASES, SSD_IDS, ssd_inputs  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401


def _bf16_operand(v, split):
    """What the tensor cores multiply in place of the fp32 ``v``: the sum
    of a bf16 hi and lo pair, or v rounded once to bf16."""
    hi = v.to(torch.bfloat16).float()
    if split == "single":
        return hi
    return hi + (v - hi).to(torch.bfloat16).float()


def _bhcq(case, seed):
    """bf16-valued x, B, C (fp32 tensors) and fp32 dt, A in the kernel's
    (b, h, s, .) layout."""
    b, s, h, g, p, n, chunk = case
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      ssd_inputs(b, s, h, g, p, n, seed=seed))
    x, B, C = (t.to(torch.bfloat16).float() for t in (x, B, C))
    return (x.transpose(1, 2), dt.transpose(1, 2), A, B.transpose(1, 2),
            C.transpose(1, 2))


def _emulated(x, dt, A, B, C, chunk, split):
    """(y, states) with the bf16 kernels' roundings: the plain version's
    arithmetic, each fp32 operand through ``_bf16_operand``."""
    b, h, s, p = x.shape
    rep = h // B.shape[1]
    xc, dtc = K._chunked(x, chunk), K._chunked(dt, chunk)
    Bc, Cc = K._chunked(B, chunk, rep), K._chunked(C, chunk, rep)
    a = A[None, :, None, None]
    cs = torch.cumsum((dtc * a).double(), dim=-1).float()
    last = cs[..., -1:]
    w = dtc * exp_fp64(last - cs)
    dS = torch.matmul(_bf16_operand(xc * w[..., None], split).transpose(
        -1, -2), Bc)
    states = K.ssd_state_pass(dS, exp_fp64(last[..., 0]))
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(~causal,
                                                            float("-inf"))
    G = torch.matmul(Cc, Bc.transpose(-1, -2)) * (exp_fp64(seg)
                                                  * dtc[..., None, :])
    y = torch.matmul(_bf16_operand(G, split), xc)
    y = y + torch.matmul(Cc, _bf16_operand(states, split).transpose(
        -1, -2)) * exp_fp64(cs)[..., None]
    return y.reshape(b, h, -1, p)[:, :, :s], states


@pytest.mark.parametrize("split", ["hi_lo", "single"])
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_split_products_keep_fp32_accuracy(case, split):
    chunk = case[-1]
    x, dt, A, B, C = _bhcq(case, seed=11)
    want = K.ssd_bhcq_plain(x, dt, A, B, C, chunk=chunk)   # fp32 plain
    _, dS, decay = K.ssd_chunk_states_plain(x, dt, A, B, chunk=chunk)
    want_states = K.ssd_state_pass(dS, decay)
    got, states = _emulated(x, dt, A, B, C, chunk, split)
    y_err = float((got - want).abs().max()) / float(want.abs().max())
    s_err = float((states - want_states).abs().max()) / max(
        1.0, float(want_states.abs().max()))
    if split == "hi_lo":
        assert y_err <= 1e-4 and s_err <= 1e-4, (y_err, s_err)
    else:
        # one bf16 rounding of x o w, G and S is why the kernels split
        assert y_err > 1e-4, y_err


@pytest.mark.parametrize("case", SSD_CASES + [(1, 200, 3, 1, 8, 4, 16)],
                         ids=SSD_IDS + ["ragged200-c16"])
def test_state_pass_equals_the_sequential_recurrence(case):
    """The chunk-parallel form (each chunk's increment from its own
    inputs, then the short pass in chunk order) leaves, at every chunk
    boundary, the state the token-by-token recurrence (ssd_step) reaches
    there, and its last state is ssd_reference's final state."""
    b, s, h, g, p, n, chunk = case
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      ssd_inputs(b, s, h, g, p, n, seed=12))
    _, dS, decay = K.ssd_chunk_states_plain(
        x.transpose(1, 2), dt.transpose(1, 2), A, B.transpose(1, 2),
        chunk=chunk)
    entering = K.ssd_state_pass(dS, decay)          # (b, h, nc, p, n)
    final = entering[:, :, -1] * decay[:, :, -1, None, None] + dS[:, :, -1]
    state = torch.zeros(b, h, p, n)
    seq = []
    for i in range(s):
        if i % chunk == 0:
            seq.append(state)
        _, state = R.ssd_step(state, x[:, i], dt[:, i], A, B[:, i], C[:, i])
    seq = torch.stack(seq, dim=2)
    scale = max(1.0, float(seq.abs().max()))
    np.testing.assert_allclose(entering.numpy() / scale, seq.numpy() / scale,
                               rtol=0, atol=1e-5)
    _, ref_final = R.ssd_reference(x, dt, A, B, C, chunk,
                                   return_final_state=True)
    np.testing.assert_allclose(final.numpy() / scale,
                               ref_final.numpy() / scale, rtol=0, atol=1e-5)
    np.testing.assert_allclose(final.numpy() / scale, state.numpy() / scale,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_plain_version_matches_reference_with_bf16_inputs(case):
    """The rewritten plain version against the block-decomposed oracle on
    bf16-valued inputs (both fp32 arithmetic, the reference's cumsum not
    rounded once): 1e-5 of the largest |y|."""
    chunk = case[-1]
    x, dt, A, B, C = _bhcq(case, seed=13)
    got = K.ssd_bhcq_plain(x, dt, A, B, C, chunk=chunk)
    want = R.ssd_reference(*(t.transpose(1, 2) for t in (x, dt)), A,
                           *(t.transpose(1, 2) for t in (B, C)), chunk)
    err = float((got.transpose(1, 2) - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max()))
