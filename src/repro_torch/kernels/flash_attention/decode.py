"""Flash-decoding over a paged KV cache: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``repro.kernels.flash_attention.decode``.  The TPU kernel
(``_flash_decode_kernel``) and the jnp merge of its split partials become
``csrc/flash_decode.cu``: a hand-written sm_90a split kernel over the grid
(splits, B*K, row groups) that walks only the live pages of each split,
and a merge kernel that writes the output (see the note at the top of the
source).  :func:`flash_decode_paged` launches them for CUDA tensors, two
launches and no other device operation; the split count comes from the
shapes alone (:func:`decode_splits`), so the grid is static.  For CPU
tensors it runs :func:`paged_attention_reference`, the dense-gather
version of the same function; :func:`flash_decode_split_plain` repeats
the kernels' split-and-merge arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load_library

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
BLOCKS_PER_SM = 2               # the fewest split blocks an SM gets
WAVE_BLOCKS_PER_SM = 3          # tensor-core split blocks one SM holds
H100_SMS = 132                  # SM count the CPU twin plans for
MAX_D, MAX_DV = 256, 128        # head widths the split kernel takes

_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def decode_splits(B: int, K: int, nb: int, sm_count: int,
                  pages_per_split: Optional[int] = None) -> Tuple[int, int]:
    """(pages a split, number of splits) from the shapes alone: B
    sequences, K KV heads, a block table nb pages wide, ``sm_count`` SMs.
    Without ``pages_per_split`` the table is cut into as many splits as
    one wave of ``WAVE_BLOCKS_PER_SM`` blocks an SM holds, and never fewer
    than put ``BLOCKS_PER_SM`` blocks on every SM (as far as nb allows).
    ``seq_lens`` never enters, so the grid is the same in every step of
    one shape, which a captured CUDA graph needs."""
    nb = max(1, nb)
    if pages_per_split is None:
        bk = max(1, B * K)
        fewest = min(nb, -(-BLOCKS_PER_SM * sm_count // bk))
        wave = min(nb, max(fewest, WAVE_BLOCKS_PER_SM * sm_count // bk))
        pps = -(-nb // wave)
        if -(-nb // pps) < fewest:
            pps = max(1, nb // fewest)
    else:
        pps = max(1, min(pages_per_split, nb))
    return pps, -(-nb // pps)


def flash_decode_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor,
                             block_tables: torch.Tensor,
                             seq_lens: torch.Tensor, *, window: int = 0,
                             scale: Optional[float] = None,
                             pages_per_split: Optional[int] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: per split of
    :func:`decode_splits` (planned for an H100's SMs) an fp32
    online-softmax partial (m, l, acc) over its pages (m = -1e30, l = acc
    = 0 where no position is visible), then the merge kernel's logsumexp
    rescale.  Same arguments and result as :func:`flash_decode_paged`."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, C, H, D = q.shape
    P, bs, K, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    g, nb = H // K, block_tables.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    pps, S = decode_splits(B, K, nb, H100_SMS, pages_per_split)
    bt = torch.nn.functional.pad(block_tables.long(), (0, S * pps - nb))
    T = S * pps * bs
    k = k_pages[bt].reshape(B, T, K, D).float()
    v = v_pages[bt].reshape(B, T, K, Dv).float()
    if k_scale is not None:
        k = k * k_scale[bt].reshape(B, T, K)[..., None]
        v = v * v_scale[bt].reshape(B, T, K)[..., None]
    # chunk-major rows: row c*g + gi of KV head h is query head h*g + gi
    qr = q.reshape(B, C, K, g, D).permute(0, 2, 1, 3, 4).reshape(
        B, K, C * g, D).float()
    s = torch.einsum("bkrd,btkd->bkrt", qr, k) * scale
    t = torch.arange(T, device=q.device)
    valid = (seq_lens.long()[:, None]
             + torch.arange(C * g, device=q.device)[None, :] // g)
    ok = (t[None, None, :] < valid[..., None]) & \
        (t < nb * bs)[None, None, :]
    if window > 0:
        ok &= t[None, None, :] > (valid[..., None] - 1) - window
    s = s.masked_fill(~ok[:, None], NEG_INF).reshape(B, K, C * g, S, -1)
    m = s.amax(-1)                                       # (B, K, CG, S)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = torch.einsum("bkrst,bstkd->bkrsd", p,
                       v.reshape(B, S, pps * bs, K, Dv))
    m, l, acc = (x.transpose(2, 3) for x in (m, l, acc))  # (B, K, S, CG..)
    g_m = m.amax(dim=2, keepdim=True)
    alpha = torch.exp(m - g_m)
    out = (acc * alpha[..., None]).sum(2) / \
        (l * alpha).sum(2).clamp_min(1e-30)[..., None]   # (B, K, CG, Dv)
    out = out.reshape(B, K, C, g, Dv).permute(0, 2, 1, 3, 4).reshape(
        B, C, H, Dv)
    return out[:, 0] if squeeze else out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode_paged: {msg}")


class _DecodeParams(ctypes.Structure):
    """Mirror of ``fd::Params`` in ``csrc/flash_decode.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k_pages", "v_pages", "k_scale", "v_scale", "block_tables",
        "seq_lens", "m_part", "l_part", "acc_part", "out")]
        + [(n, ctypes.c_longlong) for n in ("qb", "qc", "qh")]
        + [(n, ctypes.c_int) for n in (
            "B", "K", "C", "group", "D", "Dv", "bs", "nb", "pps",
            "num_splits", "window")]
        + [("scale", ctypes.c_float)])


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       seq_lens: torch.Tensor, *, window: int = 0,
                       scale: Optional[float] = None,
                       pages_per_split: Optional[int] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Flash-decoding over paged KV.  q: (B, H, D), or (B, C, H, D) for a
    teacher-forced prefill chunk, fp32, rows on 16 bytes; pages: (P, bs,
    K, D*) fp32, bf16 or int8 (with (P, bs, K) fp32 ``k_scale``/
    ``v_scale``); block_tables: (B, NB) int32 page ids; seq_lens: (B,)
    int32 valid positions including the first query row's token (row
    ``c`` attends to ``seq_lens + c``).  Returns q's shape with D -> Dv.
    ``pages_per_split`` fixes the split size; by default
    :func:`decode_splits` plans it from the shapes.

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
    _check(D % 16 == 0 and Dv % 16 == 0 and D <= MAX_D and Dv <= MAX_DV,
           f"head widths {D}/{Dv} must be multiples of 16, D <= {MAX_D}, "
           f"Dv <= {MAX_DV}")
    _check(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    _check(q.stride(-1) == 1 and all(st % 4 == 0 for st in q.stride()[:3])
           and q.data_ptr() % 16 == 0,
           "q needs a dense last dimension and rows on 16 bytes")
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
    _check(all(t.is_contiguous() for t in tensors[1:]),
           "page pools, scales, block tables and lengths must be contiguous")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B
           and seq_lens.shape == (B,)
           and block_tables.dtype == seq_lens.dtype == torch.int32,
           "block_tables (B, NB) and seq_lens (B,), int32")
    nb = block_tables.shape[1]
    g = H // K
    CG = C * g
    pps, num_splits = decode_splits(B, K, nb, _sm_count(q.device),
                                    pages_per_split)
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    dev = q.device
    out = torch.empty((B, C, H, Dv), dtype=torch.float32, device=dev)
    prm = _DecodeParams()
    prm.q, prm.k_pages, prm.v_pages = (q.data_ptr(), k_pages.data_ptr(),
                                       v_pages.data_ptr())
    if quantized:
        prm.k_scale, prm.v_scale = k_scale.data_ptr(), v_scale.data_ptr()
    prm.block_tables, prm.seq_lens = (block_tables.data_ptr(),
                                      seq_lens.data_ptr())
    if num_splits > 1:   # the splits' (m, l, acc) partials, one scratch
        rows = B * K * num_splits * CG
        part = torch.empty(rows * (Dv + 2), dtype=torch.float32,
                           device=dev)
        base = part.data_ptr()
        prm.m_part, prm.l_part, prm.acc_part = (base, base + 4 * rows,
                                                base + 8 * rows)
    prm.out = out.data_ptr()
    prm.qb, prm.qc, prm.qh = q.stride()[:3]
    (prm.B, prm.K, prm.C, prm.group, prm.D, prm.Dv, prm.bs, prm.nb,
     prm.pps, prm.num_splits, prm.window) = (
        B, K, C, g, D, Dv, bs, nb, pps, num_splits, int(window))
    prm.scale = float(scale)
    err = _library().flash_decode_paged_launch(
        ctypes.byref(prm), _PAGE_DTYPES[k_pages.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:   # 1: even a one-page stage exceeds a block's smem
        raise RuntimeError(f"flash_decode_paged: CUDA launch failed with "
                           f"error {err} (C*g={CG} rows, head widths "
                           f"{D}/{Dv}, {bs}-token pages)")
    flash_decode_paged.launches += 1
    return out[:, 0] if squeeze else out


flash_decode_paged.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library():
    """``csrc/flash_decode.cu``'s C entry points, built on first use."""
    lib = load_library("flash_decode")
    lib.flash_decode_paged_launch.argtypes = [
        ctypes.POINTER(_DecodeParams), ctypes.c_int, ctypes.c_void_p]
    lib.flash_decode_paged_launch.restype = ctypes.c_int
    return lib
