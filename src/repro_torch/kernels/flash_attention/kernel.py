"""FA-2 flash attention (causal / sliding-window / GQA): the CUDA kernels'
wrappers, their plain PyTorch versions, and the autograd wiring.

Port of ``repro.kernels.flash_attention.kernel``.  Its three Pallas TPU
kernels become hand-written sm_90a kernels (see the notes at the top of
``csrc/flash_attn.cuh``; bf16 inputs run on the tensor cores, fp32 inputs
on the CUDA cores):

* ``_fa_fwd_kernel``      -> ``csrc/flash_attn_fwd.cu``, wrapped by
  :func:`flash_attention_fwd` -> (out, lse);
* ``_fa_bwd_dq_kernel``   -> ``csrc/flash_attn_bwd.cu``, wrapped by
  :func:`flash_attention_bwd_dq` -> dq;
* ``_fa_bwd_dkdv_kernel`` -> ``csrc/flash_attn_bwd.cu``, wrapped by
  :func:`flash_attention_bwd_dkdv` -> (dk, dv), summed over each kv head's
  query group inside the kernel.

Each wrapper launches its kernel for CUDA tensors (and counts the launch
in its ``.launches``, and in ``.kernels`` under the instantiation the
library reports it launched, named as the profiler names it), runs its
plain version for CPU tensors, and raises for anything else.  Layout is
(B, H, S, D) for q, (B, K, T, D) for k and
(B, K, T, Dv) for v, as in the JAX package; any strides work as long as
the last dimension is dense, so (B, S, H, D) activations go in through
transposed views without a copy.  The kernels are instantiated for the
(D, Dv) pairs in :data:`HEAD_DIMS`; any other D <= 192, Dv <= 128 is
zero-padded to the first pair that holds it (zero columns of q and k
leave the scores as they are, zero columns of v and do give zero columns
of out, dq, dk and dv, which the wrapper slices off; the scale stays
1/sqrt(D)) and counted in ``.padded``; wider heads raise.  bf16 q, k, v
and do must also start every row on 16 bytes (``data_ptr`` and the
batch, head and row strides multiples of 8 elements); the wrappers raise
otherwise.  :class:`FlashAttention` replaces the ``_flash_core`` custom
VJP: the forward saves (q, k, v, out, lse), the backward computes
Δ = rowsum(do ⊙ out) outside the kernels (as ``kernel.py:293`` did) and
returns gradients in the primal dtypes.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import types
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load_library, refuse_abstract
from repro_torch.kernels.flash_attention.ref import NEG_INF, visible

# (D, Dv) pairs the kernels are instantiated for (by_head_dims in
# csrc/flash_attn.cuh), cheapest first: the dense models' widths and MLA's
# (96, 64) (smoke) and (192, 128); the last pair is the widths' limit
HEAD_DIMS = ((32, 32), (64, 64), (96, 64), (96, 96), (128, 128), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# Plain versions (the kernels' arithmetic, dense over S x T)
# --------------------------------------------------------------------------- #

def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            scale: float) -> torch.Tensor:
    """Masked fp32 scores (B, K, g, S, T); masked entries are -1e30."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, K, H // K, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) * scale
    ok = visible(S, T, causal=causal, window=window, device=q.device)
    return s.masked_fill(~ok, NEG_INF)


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,H,S,Dv) in q's dtype, lse (B,H,S) fp32), as the forward
    kernel's ``acc / l`` and ``m + log l``."""
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    s = _scores(q, k, causal, window, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return (out.reshape(B, H, S, -1).to(q.dtype), lse.reshape(B, H, S))


def _probs_and_ds(q, k, v, do, lse, delta, causal, window, scale):
    B, H, S, D = q.shape
    K = k.shape[1]
    s = _scores(q, k, causal, window, scale)
    p = torch.exp(s - lse.reshape(B, K, H // K, S, 1))
    dof = do.float().reshape(B, K, H // K, S, -1)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, v.float())
    ds = p * (dp - delta.reshape(B, K, H // K, S, 1)) * scale
    return p, ds, dof


def attention_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0, scale: Optional[float] = None
                           ) -> torch.Tensor:
    """dq (B,H,S,D) fp32 = Σ_j ds_ij k_j, p = exp(s - lse) recomputed."""
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    _, ds, _ = _probs_and_ds(q, k, v, do, lse, delta, causal, window, scale)
    return torch.einsum("bkgst,bktd->bkgsd", ds, k.float()).reshape(
        B, H, S, D)


def attention_bwd_dkdv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (B,K,T,D) fp32, summed over each kv head's query group:
    dk_j = Σ_i ds_ijᵀ q_i, dv_j = Σ_i p_ijᵀ do_i."""
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    p, ds, dof = _probs_and_ds(q, k, v, do, lse, delta, causal, window, scale)
    qf = q.float().reshape(B, k.shape[1], H // k.shape[1], S, D)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dof)
    return dk, dv


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

class _Strides(ctypes.Structure):
    _fields_ = [("b", ctypes.c_longlong), ("h", ctypes.c_longlong),
                ("s", ctypes.c_longlong)]


class _Params(ctypes.Structure):
    """Mirror of ``fa::Params`` in ``csrc/flash_attn.cuh``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "dout", "out", "lse", "delta", "dq", "dk",
                  "dv")]
                + [(n, _Strides) for n in
                   ("sq", "sk", "sv", "sdo", "so", "sdq", "sdk", "sdv")]
                + [(n, ctypes.c_int) for n in
                   ("B", "H", "K", "S", "T", "D", "Dv", "group", "causal",
                    "window")]
                + [("scale", ctypes.c_float)])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention: {msg}")


def _dense_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every (b, h, row) of a bf16 tensor starts on 16 bytes: the bf16
    tensor-core kernels copy rows with cp.async and read them with
    ldmatrix, 16 bytes at a time."""
    return t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


# tensor argument -> its field of strides in _Params
_STRIDE_FIELDS = {"q": "sq", "k": "sk", "v": "sv", "dout": "sdo",
                  "out": "so", "dq": "sdq", "dk": "sdk", "dv": "sdv"}


def padded_dims(D: int, Dv: int) -> Tuple[int, int]:
    """The (D, Dv) pair of :data:`HEAD_DIMS` the kernels run widths
    (D, Dv) at: the first that holds both.  Raises past the limit."""
    for pair in HEAD_DIMS:
        if D <= pair[0] and Dv <= pair[1]:
            return pair
    raise ValueError(
        f"flash attention: head widths D={D}, Dv={Dv} are past the "
        f"kernels' limit D <= {HEAD_DIMS[-1][0]}, Dv <= {HEAD_DIMS[-1][1]}")


def _scale(scale: Optional[float], D: int) -> float:
    return scale if scale is not None else 1.0 / D ** 0.5


def _check_shapes(q, k, v) -> None:
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           f"q (B,H,S,D), k (B,K,T,D), v (B,K,T,Dv); got "
           f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    _, K, T, _ = k.shape
    _check(k.shape == (B, K, T, D) and v.shape[:3] == k.shape[:3],
           f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q "
           f"{tuple(q.shape)}")
    _check(K > 0 and H % K == 0, f"{H} query heads over {K} kv heads")
    _check(S > 0 and T > 0 and B > 0, "empty attention")


def _params(q, k, v, causal, window, scale, **tensors) -> _Params:
    """Validate (q, k, v) and fill the kernels' parameter block."""
    _check_shapes(q, k, v)
    B, H, S, D = q.shape
    K, T, Dv = k.shape[1], k.shape[2], v.shape[-1]
    _check((D, Dv) in HEAD_DIMS,
           f"(head_dim, v_head_dim) ({D}, {Dv}) not in {HEAD_DIMS}")
    _check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; float32 or bfloat16")
    ts = {"q": q, "k": k, "v": v, **tensors}
    _check(all(t.device == q.device for t in ts.values()),
           "all tensors must be on one device")
    if q.dtype == torch.bfloat16:
        for name in ("q", "k", "v", "dout"):
            t = ts.get(name)
            if t is not None and not _rows_aligned(t):
                raise ValueError(
                    f"flash attention: bf16 {name} rows must start on 16 "
                    f"bytes (data_ptr {t.data_ptr()}, strides "
                    f"{t.stride()[:3]}: multiples of 8 elements)")
    p = _Params()
    for name, t in ts.items():
        setattr(p, name, t.data_ptr())
        if name in _STRIDE_FIELDS:
            setattr(p, _STRIDE_FIELDS[name], _Strides(*t.stride()[:3]))
    p.B, p.H, p.K, p.S, p.T, p.group = B, H, K, S, T, H // K
    p.D, p.Dv = D, Dv
    p.causal, p.window = int(causal), int(window)
    p.scale = float(_scale(scale, D))
    return p


def _launch(fn, p: _Params, q: torch.Tensor, name: str) -> None:
    err = fn(ctypes.byref(p), _DTYPES[q.dtype], p.D, p.Dv,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _count(fn, last_kernel) -> None:
    """One launch of ``fn``'s kernel, counted in ``fn.launches`` and, under
    the instantiation ``last_kernel()`` reports, in ``fn.kernels``."""
    fn.launches += 1
    fn.kernels[last_kernel().decode()] += 1


def _pad(t: Optional[torch.Tensor], width: int) -> Optional[torch.Tensor]:
    """t with a dense last dimension zero-padded to ``width``."""
    if t is None:
        return None
    if t.shape[-1] != width:
        return torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    return _dense_last(t)


def _kernel_inputs(q, k, v, do=None):
    """(q, k, v, do, D, Dv, padded): shapes checked, q and k zero-padded to
    the kernels' D and v and do to their Dv (:func:`padded_dims`); D and
    Dv are the real widths."""
    _check_shapes(q, k, v)
    D, Dv = q.shape[-1], v.shape[-1]
    if do is not None:
        _check(do.shape == q.shape[:3] + (Dv,),
               f"do {tuple(do.shape)} vs q {tuple(q.shape)}, Dv {Dv}")
    Dp, Dvp = padded_dims(D, Dv)
    return (_pad(q, Dp), _pad(k, Dp), _pad(v, Dvp), _pad(do, Dvp), D, Dv,
            (Dp, Dvp) != (D, Dv))


def _empty_rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """An empty (B, H, S, width) tensor of t's dtype whose first three
    dimensions are laid out in memory as t's are (a transposed (B, S, H,
    D) input gets a transposed (B, S, H, width) output)."""
    order = sorted(range(3), key=lambda i: -t.stride(i))
    buf = torch.empty([t.shape[i] for i in order] + [width],
                      dtype=t.dtype, device=t.device)
    return buf.permute(*[order.index(i) for i in range(3)], 3)


def _device(q: torch.Tensor) -> str:
    refuse_abstract(q, "the FA-2 kernels", 'attn_impl="chunked"')
    _check(q.device.type in ("cpu", "cuda"),
           f"tensors on {q.device}, not CUDA/CPU")
    return q.device.type


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FA-2 forward.  q (B,H,S,D), k (B,K,T,D), v (B,K,T,Dv), fp32 or
    bf16.  Returns (out (B,H,S,Dv) in q's dtype and memory layout, lse
    (B,H,S) fp32)."""
    if _device(q) == "cpu":
        return attention_fwd_plain(q, k, v, causal=causal, window=window,
                                   scale=scale)
    q, k, v, _, D, Dv, padded = _kernel_inputs(q, k, v)
    out = _empty_rows(q, v.shape[-1])
    B, H, S, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    p = _params(q, k, v, causal, window, _scale(scale, D), out=out,
                lse=lse)
    _launch(_lib().fa_fwd_launch, p, q, "flash_attention_fwd")
    _count(flash_attention_fwd, _lib().fa_fwd_last_kernel)
    flash_attention_fwd.padded += padded
    return (out[..., :Dv] if padded else out), lse


def _bwd_inputs(q, k, v, do, lse, delta):
    q, k, v, do, D, Dv, padded = _kernel_inputs(q, k, v, do.to(q.dtype))
    B, H, S, _ = q.shape
    _check(lse.shape == (B, H, S) and delta.shape == (B, H, S)
           and lse.dtype == delta.dtype == torch.float32,
           "lse and delta must be (B,H,S) float32")
    return q, k, v, do, lse.contiguous(), delta.contiguous(), D, Dv, padded


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0, scale: Optional[float] = None
                           ) -> torch.Tensor:
    """dq (B,H,S,D) fp32 from the forward's lse and Δ = rowsum(do ⊙ out)."""
    if _device(q) == "cpu":
        return attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                      window=window, scale=scale)
    q, k, v, do, lse, delta, D, _, padded = _bwd_inputs(q, k, v, do, lse,
                                                        delta)
    dq = torch.empty_like(q, dtype=torch.float32)
    p = _params(q, k, v, causal, window, _scale(scale, D), dout=do, lse=lse,
                delta=delta, dq=dq)
    _launch(_lib().fa_bwd_dq_launch, p, q, "flash_attention_bwd_dq")
    _count(flash_attention_bwd_dq, _lib().fa_bwd_last_kernel)
    flash_attention_bwd_dq.padded += padded
    return dq[..., :D] if padded else dq


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk (B,K,T,D), dv (B,K,T,Dv)) fp32, each kv head's query group
    summed."""
    if _device(q) == "cpu":
        return attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                        causal=causal, window=window,
                                        scale=scale)
    q, k, v, do, lse, delta, D, Dv, padded = _bwd_inputs(q, k, v, do, lse,
                                                         delta)
    dk = torch.empty_like(k, dtype=torch.float32)
    dv = torch.empty_like(v, dtype=torch.float32)
    p = _params(q, k, v, causal, window, _scale(scale, D), dout=do, lse=lse,
                delta=delta, dk=dk, dv=dv)
    _launch(_lib().fa_bwd_dkdv_launch, p, q, "flash_attention_bwd_dkdv")
    _count(flash_attention_bwd_dkdv, _lib().fa_bwd_last_kernel)
    flash_attention_bwd_dkdv.padded += padded
    if padded:
        return dk[..., :D], dv[..., :Dv]
    return dk, dv


for _fn in (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkdv):
    _fn.launches = 0      # kernel launches
    _fn.padded = 0        # of those, launches at zero-padded widths
    _fn.kernels = collections.Counter()   # launches by instantiation
del _fn


@functools.lru_cache(maxsize=None)
def _lib() -> types.SimpleNamespace:
    """The C entry points of ``csrc/flash_attn_{fwd,bwd}.cu``, built on
    first use; one object holding the three launchers and each library's
    report of the instantiation it last launched."""
    fwd = load_library("flash_attn_fwd")
    bwd = load_library("flash_attn_bwd")
    fns = {"fa_fwd_launch": fwd.fa_fwd_launch,
           "fa_bwd_dq_launch": bwd.fa_bwd_dq_launch,
           "fa_bwd_dkdv_launch": bwd.fa_bwd_dkdv_launch}
    for fn in fns.values():
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    last = {"fa_fwd_last_kernel": fwd.fa_fwd_last_kernel,
            "fa_bwd_last_kernel": bwd.fa_bwd_last_kernel}
    for fn in last.values():
        fn.argtypes = []
        fn.restype = ctypes.c_char_p
    return types.SimpleNamespace(**fns, **last)


# --------------------------------------------------------------------------- #
# Autograd
# --------------------------------------------------------------------------- #

class FlashAttention(torch.autograd.Function):
    """The ``_flash_core`` custom VJP: forward kernel, then the dq and
    dk/dv kernels from O(S) residuals (out, lse).  Gradients come back in
    the primal dtypes (bf16 primals get bf16 gradients)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (do.float() * out.float()).sum(dim=-1)        # (B,H,S)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.opts)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                          **ctx.opts)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,S,D); k (B,K,T,D); v (B,K,T,Dv).  Returns (B,H,S,Dv);
    differentiable through the FA-2 backward kernels."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return FlashAttention.apply(q, k, v, causal, int(window), float(scale))
