"""Plain-PyTorch oracle for the Mamba2 SSD (state-space dual) scan (port
of ``repro.kernels.ssd_scan.ref``).

The chunked block decomposition of the Mamba2 paper (arXiv:2405.21060,
Listing 1 "ssd_minimal_discrete"), generalized to grouped B/C
(n_groups <= n_heads).  The model's non-kernel path (``use_kernel=False``)
and the decode recurrence (:func:`ssd_step`) use it.  The JAX package's
multi-operand einsums are written here as explicit pairwise contractions:
on the card ``torch.einsum`` has no ``opt_einsum`` to choose an order,
and at 8 x 4096 tokens the (b, c, h, Q, Q) fp32 intermediate is already
~0.4 GB, so a bad order would cost far more.

Shapes
------
x  : (b, s, h, p)   per-head input
dt : (b, s, h)      positive step sizes (softplus already applied)
A  : (h,)           negative per-head decay rates (A = -exp(A_log))
B  : (b, s, g, n)   input projection  (g groups, h % g == 0)
C  : (b, s, g, n)   output projection
-> y : (b, s, h, p)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def exp_fp64(x: torch.Tensor) -> torch.Tensor:
    """exp evaluated in fp64 and rounded once to x's dtype: each value is
    the correctly rounded exp of its argument, whatever the backend's own
    fp32 exp does (on some CPU builds PyTorch's vectorized fp32 exp has
    returned values 1e-4 off on the first call of a process).  The scan's
    decays feed sums over whole chunks, so they use it."""
    return torch.exp(x.double()).to(x.dtype)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) with out[i, j] = sum_{k=j+1..i} x[k] (i >= j),
    NEG_INF above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, NEG_INF))


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk_size: int,
                  initial_state: Optional[torch.Tensor] = None,
                  return_final_state: bool = False):
    """Chunked SSD in fp32.  See the module docstring for shapes; with
    ``return_final_state`` also returns the (b, h, p, n) fp32 state after
    the last position."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    orig_s = s
    if s % chunk_size:
        # pad with dt=0 tokens: decay exp(0)=1, zero input — state-neutral
        pad = chunk_size - s % chunk_size
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    rep = h // g
    c = s // chunk_size
    Q = chunk_size

    f32 = torch.float32
    xd = x.to(f32) * dt[..., None].to(f32)                   # (b,s,h,p)
    dA = dt.to(f32) * A.to(f32)                              # (b,s,h)
    Bh = B.to(f32).repeat_interleave(rep, dim=2)             # (b,s,h,n)
    Ch = C.to(f32).repeat_interleave(rep, dim=2)

    # chunked, heads before positions: (b, c, h, Q, .)
    xd = xd.reshape(b, c, Q, h, p).transpose(2, 3)
    Bh = Bh.reshape(b, c, Q, h, n).transpose(2, 3)
    Ch = Ch.reshape(b, c, Q, h, n).transpose(2, 3)
    dA = dA.reshape(b, c, Q, h).permute(0, 3, 1, 2)          # (b,h,c,Q)
    dA_cs = torch.cumsum(dA, dim=-1)                         # (b,h,c,Q)

    # 1. intra-chunk (block-diagonal): ((C Bᵀ) ∘ L) xd
    L = exp_fp64(segsum(dA)).transpose(1, 2)                 # (b,c,h,Q,Q)
    y = torch.matmul(torch.matmul(Ch, Bh.transpose(-1, -2)) * L, xd)
    del L

    # 2. per-chunk end states: xdᵀ (B ∘ decay to the chunk's end)
    decay_states = exp_fp64(dA_cs[..., -1:] - dA_cs)         # (b,h,c,Q)
    states = torch.matmul(
        (xd * decay_states.transpose(1, 2)[..., None]).transpose(-1, -2),
        Bh)                                                  # (b,c,h,p,n)

    # 3. inter-chunk recurrence, emitting the state entering each chunk
    if initial_state is None:
        carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    else:
        carry = initial_state.to(f32)
    chunk_decay = exp_fp64(dA_cs[..., -1])                   # (b,h,c)
    prev = []
    for ci in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                   # (b,c,h,p,n)

    # 4. off-diagonal (cross-chunk) contribution: (C ∘ exp(cs)) Sᵀ
    decay_out = exp_fp64(dA_cs).transpose(1, 2)[..., None]   # (b,c,h,Q,1)
    y = y + torch.matmul(Ch, prev_states.transpose(-1, -2)) * decay_out

    y = y.transpose(2, 3).reshape(b, s, h, p)[:, :orig_s].to(x.dtype)
    if return_final_state:
        return y, carry
    return y


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor):
    """Single decode step.

    state: (b,h,p,n); x_t: (b,h,p); dt_t: (b,h); B_t/C_t: (b,g,n).
    Returns (y_t (b,h,p) in x_t's dtype, new fp32 state).
    """
    h = state.shape[1]
    rep = h // B_t.shape[1]
    f32 = torch.float32
    Bh = B_t.to(f32).repeat_interleave(rep, dim=1)           # (b,h,n)
    Ch = C_t.to(f32).repeat_interleave(rep, dim=1)
    dA = exp_fp64(dt_t.to(f32) * A.to(f32))                  # (b,h)
    xd = x_t.to(f32) * dt_t[..., None].to(f32)               # (b,h,p)
    new_state = state.to(f32) * dA[..., None, None] \
        + xd[..., :, None] * Bh[..., None, :]
    y = torch.matmul(new_state, Ch[..., None])[..., 0]       # (b,h,p)
    return y.to(x_t.dtype), new_state
