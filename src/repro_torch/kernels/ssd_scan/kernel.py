"""Mamba2 SSD chunked scan: the CUDA kernels' wrapper and their plain
PyTorch version (port of ``repro.kernels.ssd_scan.kernel``).

The Pallas TPU kernel ``_ssd_kernel`` becomes the hand-written sm_90a
kernels in ``csrc/ssd_scan.cu`` (see the note at its top), wrapped by
:func:`ssd_bhcq`: the chunk recurrence split in SSD's three parts
(chunk-local state increments, a short state pass in chunk order, the
output), three launches a call, bf16 products on the tensor cores.
Layout is the JAX function's: x (b, h, s, p), dt
(b, h, s) fp32 (the JAX kernel took (b, h, s, 1)), A (h,) fp32, B/C
(b, g, s, n), head h reading group h // (h / g); y (b, h, s, p) in x's
dtype.  Any strides work as long as the last dimension is dense, so the
model's (b, s, h, ·) activations go in as transposed views, and y comes
back as a transposed view of a (b, s, h, p) tensor.  Unlike the TPU
function, s need not be a multiple of the chunk: positions past s count
as dt = x = B = C = 0 inside the kernel, so the caller makes no padded
copy.

The wrapper launches the kernels for CUDA tensors (and counts the call in
``ssd_bhcq.launches``), runs :func:`ssd_bhcq_plain` for CPU tensors, and
raises for anything else.  The JAX kernel had no VJP, so the wrapper
raises when autograd would need a gradient through it rather than detach
its inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library, refuse_abstract
from repro_torch.kernels.ssd_scan.ref import exp_fp64

MAX_DIM = 128                 # p, n and the chunk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _chunked(t: torch.Tensor, chunk: int, rep: int = 1) -> torch.Tensor:
    """(b, h', s, ...) -> fp32 (b, h' * rep, nc, chunk, ...), the last
    chunk padded with zeros."""
    nc = -(-t.shape[2] // chunk)
    t = t.to(torch.float32)
    pad = [0, 0] * (t.dim() - 3) + [0, nc * chunk - t.shape[2]]
    t = torch.nn.functional.pad(t, pad).repeat_interleave(rep, dim=1)
    return t.reshape(*t.shape[:2], nc, chunk, *t.shape[3:])


def ssd_chunk_states_plain(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, *, chunk: int):
    """Step 1 of the kernels, chunk-local: per (b, h, chunk) the cumsum cs
    of dt * A (products in fp32, summed in fp64 and rounded once, as the
    kernels do, so both get the same cs bit for bit), the state increment
    dS = (x o w)^T B with w_j = dt_j exp(cs_last - cs_j), and the decay
    exp(cs_last).  Returns (cs (b,h,nc,Q), dS (b,h,nc,p,n), decay
    (b,h,nc)), fp32; a ragged last chunk is padded with dt = x = B = 0."""
    rep = x.shape[1] // B.shape[1]
    xc, dtc = _chunked(x, chunk), _chunked(dt, chunk)
    Bc = _chunked(B, chunk, rep)
    a = A.to(torch.float32)[None, :, None, None]
    cs = torch.cumsum((dtc * a).double(), dim=-1).to(torch.float32)
    last = cs[..., -1:]
    w = dtc * exp_fp64(last - cs)
    dS = torch.matmul((xc * w[..., None]).transpose(-1, -2), Bc)
    return cs, dS, exp_fp64(last[..., 0])


def ssd_state_pass(dS: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Step 2: the short pass in chunk order.  dS (..., nc, p, n), decay
    (..., nc) -> the state entering each chunk (..., nc, p, n):
    S_0 = 0, S_c+1 = decay_c S_c + dS_c."""
    out = torch.empty_like(dS)
    S = torch.zeros_like(dS[..., 0, :, :])
    for c in range(dS.shape[-3]):
        out[..., c, :, :] = S
        S = S * decay[..., c, None, None] + dS[..., c, :, :]
    return out


def ssd_bhcq_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int
                   ) -> torch.Tensor:
    """The kernels' arithmetic, all (b, h, chunk) at once, in fp32: step
    1 (:func:`ssd_chunk_states_plain`), step 2 (:func:`ssd_state_pass`),
    then step 3, y = ((C B^T) o L o dt_j) x + exp(cs_i) (C S_c^T) with
    L[i, j] = exp(cs_i - cs_j) for j <= i, each decay the correctly
    rounded exp of its fp32 argument.  A ragged last chunk is padded with
    dt = x = B = C = 0, which leaves the state unchanged, and its padded
    rows are dropped."""
    b, h, s, p = x.shape
    rep = h // B.shape[1]
    cs, dS, decay = ssd_chunk_states_plain(x, dt, A, B, chunk=chunk)
    states = ssd_state_pass(dS, decay)                   # (b,h,nc,p,n)
    xc, dtc = _chunked(x, chunk), _chunked(dt, chunk)
    Bc, Cc = _chunked(B, chunk, rep), _chunked(C, chunk, rep)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(~causal,
                                                            float("-inf"))
    L = exp_fp64(seg) * dtc[..., None, :]
    y = torch.matmul(torch.matmul(Cc, Bc.transpose(-1, -2)) * L, xc)
    y = y + torch.matmul(Cc, states.transpose(-1, -2)) * \
        exp_fp64(cs)[..., None]
    out = torch.empty((b, s, h, p), dtype=x.dtype,
                      device=x.device).transpose(1, 2)
    out.copy_(y.reshape(b, h, -1, p)[:, :, :s])
    return out


class _Params(ctypes.Structure):
    """Mirror of ``Params`` in ``csrc/ssd_scan.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "dt", "A", "B", "C",
                                                "y", "states", "decay")]
                + [(n, ctypes.c_longlong) for n in (
                    "seqlen", "xb", "xh", "xs", "db", "dh", "ds", "bb", "bg",
                    "bs", "cb", "cg", "cs", "yb", "yh", "ys")]
                + [(n, ctypes.c_int) for n in ("batch", "heads", "groups",
                                               "p", "n", "chunk",
                                               "nchunks")])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_bhcq: {msg}")


def _check_shapes(x, dt, A, B, C, chunk) -> None:
    _check(x.dim() == 4 and dt.dim() == 3 and A.dim() == 1
           and B.dim() == 4 and C.shape == B.shape,
           f"x (b,h,s,p), dt (b,h,s), A (h,), B/C (b,g,s,n); got "
           f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
           f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, h, s, _ = x.shape
    g = B.shape[1]
    _check(dt.shape == (b, h, s) and A.shape == (h,)
           and B.shape[0] == b and B.shape[2] == s,
           f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
           f"A {tuple(A.shape)}, B {tuple(B.shape)}")
    _check(g > 0 and h % g == 0, f"{h} heads over {g} groups")
    _check(chunk > 0, f"chunk {chunk}")


def _check_cuda(x, dt, A, B, C, chunk) -> None:
    ts = (x, dt, A, B, C)
    _check(all(t.device == x.device for t in ts),
           "all tensors must be on one device")
    _check(x.dtype in _DTYPES and B.dtype == x.dtype and C.dtype == x.dtype,
           f"x/B/C dtypes {x.dtype}/{B.dtype}/{C.dtype}; float32 or "
           "bfloat16, all one")
    _check(dt.dtype == torch.float32 and A.dtype == torch.float32,
           f"dt and A must be float32, got {dt.dtype}/{A.dtype}")
    p, n = x.shape[3], B.shape[3]
    _check(p % 8 == 0 and n % 8 == 0 and p <= MAX_DIM and n <= MAX_DIM
           and chunk <= MAX_DIM,
           f"head_dim {p} and d_state {n} must be multiples of 8 and, with "
           f"the chunk {chunk}, at most {MAX_DIM}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        _check(t.stride(-1) == 1 and all(st % 8 == 0
                                         for st in t.stride()[:3])
               and t.data_ptr() % 16 == 0,
               f"{name} needs a dense last dimension, strides that are "
               "multiples of 8 and 16-byte aligned data")


def ssd_bhcq(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int
             ) -> torch.Tensor:
    """SSD scan, head-major layout (see the module docstring); returns y
    (b, h, s, p) in x's dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError(
            "ssd_bhcq has no backward (the JAX kernel has no VJP): call it "
            "under torch.no_grad()/inference_mode(), or use ssd_reference "
            "to differentiate")
    _check_shapes(x, dt, A, B, C, chunk)
    refuse_abstract(x, "the SSD-scan kernel",
                    "use_kernel=False (the plain ssd_reference)")
    _check(x.device.type in ("cpu", "cuda"),
           f"tensors on {x.device}, not CUDA/CPU")
    if x.device.type == "cpu":
        return ssd_bhcq_plain(x, dt, A, B, C, chunk=chunk)
    _check_cuda(x, dt, A, B, C, chunk)
    b, h, s, p = x.shape
    n, nc = B.shape[3], -(-s // chunk)
    y = torch.empty((b, s, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    P = _Params()
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C), ("y", y)):
        setattr(P, name, t.data_ptr())
    if nc > 1:   # fp32 scratch: each chunk's state increment, then the
        # state entering the next chunk; each chunk's decay
        states = torch.empty((b, h, nc - 1, p, n), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((b, h, nc), dtype=torch.float32,
                            device=x.device)
        P.states, P.decay = states.data_ptr(), decay.data_ptr()
    (P.xb, P.xh, P.xs), (P.db, P.dh, P.ds) = x.stride()[:3], dt.stride()
    (P.bb, P.bg, P.bs), (P.cb, P.cg, P.cs) = B.stride()[:3], C.stride()[:3]
    P.yb, P.yh, P.ys = y.stride()[:3]
    P.seqlen, P.batch, P.heads, P.groups = s, b, h, B.shape[1]
    P.p, P.n, P.chunk, P.nchunks = p, n, chunk, nc
    A = A.contiguous()
    P.A = A.data_ptr()
    err = _launcher()(ctypes.byref(P), _DTYPES[x.dtype],
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_bhcq: CUDA launch failed with error {err}")
    ssd_bhcq.launches += 1
    return y


ssd_bhcq.launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/ssd_scan.cu``, built on first use."""
    fn = load_library("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
