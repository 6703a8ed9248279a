"""Flash-decoding over a paged KV cache: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``repro.kernels.flash_attention.decode``.  The TPU kernel
(``_flash_decode_kernel``) becomes ``csrc/flash_decode.cu``, a
hand-written sm_90a kernel over the grid (B, K, num_splits) that walks
only the live pages of each split (see the note at the top of the
source).  :func:`flash_decode_paged` launches it for CUDA tensors and
merges the split partials with plain torch ops, as the JAX package merged
them in jnp outside the Pallas call.  For CPU tensors it runs
:func:`paged_attention_reference`, the dense-gather version of the same
function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import c_args, load_library

DEFAULT_PAGES_PER_SPLIT = 8
NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free

_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232_448            # bytes of shared memory a block may use


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              seq_lens: torch.Tensor, *, window: int = 0,
                              scale: Optional[float] = None,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Dense-gather version of the paged attention (fp32 softmax).

    q: (B, H, D) or (B, C, H, D) teacher-forced chunk rows; k/v_pages:
    (P, bs, K, D*); block_tables: (B, NB) int; seq_lens: (B,) valid
    positions incl. the first query row's token (row ``c`` of a chunk
    attends to ``seq_lens + c`` positions).  ``k_scale``/``v_scale``
    ((P, bs, K) fp32) dequantize int8 pages.  Returns q's shape with
    D -> Dv.  A row with no valid position returns 0, as the kernel does
    (the JAX oracle leaves such rows undefined).
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, C, H, D = q.shape
    P, bs, K, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    g = H // K
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    bt = block_tables.long()
    T = bt.shape[1] * bs
    k = k_pages[bt].reshape(B, T, K, D).float()
    v = v_pages[bt].reshape(B, T, K, Dv).float()
    if k_scale is not None:
        k = k * k_scale[bt].reshape(B, T, K)[..., None]
    if v_scale is not None:
        v = v * v_scale[bt].reshape(B, T, K)[..., None]
    qf = q.reshape(B, C, K, g, D).float()
    s = torch.einsum("bckgd,btkd->bckgt", qf, k) * scale
    t = torch.arange(T, device=q.device)[None, None, :]
    valid = (seq_lens.long()[:, None, None]
             + torch.arange(C, device=q.device)[None, :, None])
    ok = t < valid                                       # (B, C, T)
    if window > 0:
        ok &= t > (valid - 1) - window
    s = s.masked_fill(~ok[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bckgt,btkd->bckgd", p, v)
    out = out * ok.any(-1)[:, :, None, None, None]       # no valid key -> 0
    out = out.reshape(B, C, H, Dv).to(q.dtype)
    return out[:, 0] if squeeze else out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode_paged: {msg}")


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       seq_lens: torch.Tensor, *, window: int = 0,
                       scale: Optional[float] = None,
                       pages_per_split: int = DEFAULT_PAGES_PER_SPLIT,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Flash-decoding over paged KV.  q: (B, H, D), or (B, C, H, D) for a
    teacher-forced prefill chunk, fp32; pages: (P, bs, K, D*) fp32, bf16
    or int8 (with (P, bs, K) fp32 ``k_scale``/``v_scale``); block_tables:
    (B, NB) int32 page ids; seq_lens: (B,) int32 valid positions
    including the first query row's token (row ``c`` attends to
    ``seq_lens + c``).  Returns q's shape with D -> Dv.

    CUDA tensors launch ``csrc/flash_decode.cu`` (and count one launch in
    ``flash_decode_paged.launches``); CPU tensors run the plain version;
    anything else raises."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens, window=window,
            scale=scale, k_scale=k_scale, v_scale=v_scale)
    _check(q.device.type == "cuda", f"tensors on {q.device}, not CUDA/CPU")
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    _check(q.dim() == 4, f"q must be (B,H,D) or (B,C,H,D), got {q.shape}")
    B, C, H, D = q.shape
    _check(k_pages.dim() == 4 and v_pages.dim() == 4, "pages are (P,bs,K,D)")
    P, bs, K, Dk = k_pages.shape
    Dv = v_pages.shape[-1]
    _check(Dk == D and v_pages.shape[:3] == k_pages.shape[:3],
           f"page shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
           f"vs q head_dim {D}")
    _check(H % K == 0, f"{H} query heads over {K} KV heads")
    _check(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    _check(k_pages.dtype in _PAGE_DTYPES and v_pages.dtype == k_pages.dtype,
           f"page dtype {k_pages.dtype}/{v_pages.dtype}")
    quantized = k_pages.dtype == torch.int8
    _check(quantized == (k_scale is not None) == (v_scale is not None),
           "int8 pages need k_scale and v_scale, other pages neither")
    tensors = [q, k_pages, v_pages, block_tables, seq_lens]
    if quantized:
        _check(k_scale.shape == (P, bs, K) and v_scale.shape == (P, bs, K)
               and k_scale.dtype == v_scale.dtype == torch.float32,
               "scales must be (P, bs, K) float32")
        tensors += [k_scale, v_scale]
    _check(all(t.device == q.device for t in tensors),
           "all tensors must be on one device")
    _check(k_pages.is_contiguous() and v_pages.is_contiguous()
           and (not quantized or (k_scale.is_contiguous()
                                  and v_scale.is_contiguous())),
           "page pools must be contiguous")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B
           and seq_lens.shape == (B,), "block_tables (B, NB), seq_lens (B,)")
    nb = block_tables.shape[1]
    g = H // K
    CG = C * g
    smem = 4 * (CG * D + CG * Dv + bs * (D + 1) + bs * Dv + CG * bs + 3 * CG)
    _check(smem <= _SMEM_LIMIT,
           f"C*g={CG} rows x head_dim {D} need {smem} B of shared memory")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    pps = max(1, min(pages_per_split, nb))
    num_splits = -(-nb // pps)

    # chunk-major rows: row c*g + gi is chunk index c of group lane gi
    qg = q.reshape(B, C, K, g, D).permute(0, 2, 1, 3, 4).reshape(
        B, K, CG, D).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    m = torch.empty((B, K, num_splits, CG), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, K, num_splits, CG, Dv), dtype=torch.float32,
                      device=q.device)
    err = _launcher()(
        qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        bt.data_ptr(), sl.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), B, K, CG, D, Dv, bs, nb, pps, num_splits, g, C,
        int(window), float(scale), _PAGE_DTYPES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_paged: CUDA launch failed with "
                           f"error {err}")
    flash_decode_paged.launches += 1

    # merge the split partials: standard flash-decoding logsumexp rescale;
    # splits with no live page carry (m=-1e30, l=0, acc=0) and vanish here
    g_m = m.amax(dim=2, keepdim=True)                          # (B,K,1,CG)
    alpha = torch.exp(m - g_m)                                  # (B,K,S,CG)
    l_tot = (l * alpha).sum(dim=2)                              # (B,K,CG)
    acc_tot = (acc * alpha[..., None]).sum(dim=2)               # (B,K,CG,Dv)
    out = acc_tot / l_tot.clamp_min(1e-30)[..., None]
    out = out.reshape(B, K, C, g, Dv).permute(0, 2, 1, 3, 4).reshape(
        B, C, H, Dv)
    return out[:, 0] if squeeze else out


flash_decode_paged.launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point of ``csrc/flash_decode.cu``, built on first use."""
    fn = load_library("flash_decode").flash_decode_paged_launch
    fn.argtypes = c_args("p" * 10 + "i" * 12 + "f" + "i" + "p")
    fn.restype = ctypes.c_int
    return fn
