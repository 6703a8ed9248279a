"""Core layers: norms (and Mamba2's gated RMSNorm), rotary embeddings,
full-sequence attention (train / prefill), attention against the paged
KV cache (the engine) and against a dense per-batch cache (the dense
decode path), and the MLP.

Port of ``repro.models.layers`` for attn + mlp decoders, whisper's
cross-attention and Qwen2-VL's multimodal RoPE: plain functions
on tensors over a parameter dict, with the JAX package's conventions kept
exactly — norm statistics in fp32 with the multiply in the input dtype,
RoPE over split halves, softmax in fp32.  Large projections are plain
``torch.matmul``, as the JAX package left them to XLA; attention itself
is the FA-2 kernels (train) or the flash-decode kernel (serve).  Under an
ambient ``(data, model)`` mesh the parameters and activations are
DTensors: q, k and v are pinned to (batch, heads) as in the JAX package
(``distributed.act_sharding.constrain``), and the attention runs on each
rank's own rows and heads.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import (BATCH, constrain,
                                                  is_sharded, merge_softmax,
                                                  rows_like, seq_block,
                                                  write_row)
from repro_torch.kernels.flash_attention.chunked import (chunked_attention,
                                                         sharded_heads)
from repro_torch.kernels.flash_attention.decode import (
    flash_decode_paged, paged_attention_reference)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, visible
from repro_torch.kernels.quant8.ops import quantize_kv
from repro_torch.models.config import ModelConfig

ATTN_IMPLS = ("kernel", "gather")                  # paged decode
TRAIN_ATTN_IMPLS = ("naive", "chunked", "kernel")  # full-sequence


def norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm / LayerNorm: statistics in fp32, normalize-multiply in the
    input dtype."""
    dtype = x.dtype
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + cfg.norm_eps).to(dtype)
        return x * inv * p["scale"].to(dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + cfg.norm_eps).to(dtype)
    out = (x - mean.to(dtype)) * inv
    return out * p["scale"].to(dtype) + p["bias"].to(dtype)


def rms_gate_norm(scale: torch.Tensor, x: torch.Tensor, gate: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba2 gated RMSNorm: norm(x * silu(z)); the gate multiplies in the
    input dtype, the statistics and the scaling run in fp32."""
    dtype = x.dtype
    xf = (x * F.silu(gate)).float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dtype)


@functools.lru_cache(maxsize=None)
def _host_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        return (1.0 / (theta ** exps)).to(device)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """The (head_dim / 2,) fp32 rotary frequencies, computed on the host
    and kept on ``device`` (once per width, theta and device), so that
    every device rotates by the same frequencies: the card's fp32 ``pow``
    can differ from the CPU's in the last bit, and a position of a few
    thousand turns that into about 1e-5 of the rotated output.  Do not
    write into the result."""
    return _host_freqs(head_dim, float(theta), torch.device(device or "cpu"))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S).  Rotates
    split halves (x[:D/2], x[D/2:]), not interleaved pairs."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    angles = positions[..., None].float() * freqs           # (..., S, d/2)
    angles = angles[..., None, :]                           # (..., S, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal rotary embedding.  x: (..., S, H, D);
    positions: (3, ..., S), the (temporal, height, width) position ids.
    ``sections`` split the d/2 frequencies among the three streams in
    order; frequency f rotates by its stream's position.  The JAX package
    selects each frequency's stream with a one-hot einsum (the angle times
    1.0 plus two times 0.0, exact in fp32); the index gather here gives
    the same fp32 angles."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    # each frequency's stream: the number of section ends at or below it
    f = torch.arange(d // 2, device=x.device)
    sec_id = sum(((f >= end).long()
                  for end in itertools.accumulate(sections[:-1])),
                 torch.zeros_like(f))                       # (d/2,)
    pos = positions.float()[sec_id]                         # (d/2, ..., S)
    angles = pos.movedim(0, -1) * freqs                     # (..., S, d/2)
    angles = angles[..., None, :]                           # (..., S, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positional(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.pos_embedding == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_embedding == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x     # learned / sinusoidal: at the embedding layer; none: none


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                 kv_x: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q from ``x``; k and v from ``kv_x`` (the encoder output, for
    cross-attention) or from ``x``."""
    kv_in = x if kv_x is None else kv_x
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(kv_in, p["wk"])
    v = _proj_heads(kv_in, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * k, d)


def _mask_bias(q_len: int, kv_len: int, *, causal: bool, window: int,
               q_offset: int = 0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(q_len, kv_len) additive mask bias in fp32."""
    ok = visible(q_len, kv_len, causal=causal, window=window,
                 q_offset=q_offset, device=device)
    return torch.where(ok, 0.0, NEG_INF).float()


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0, q_offset: int = 0,
                   kv_valid_len: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Reference attention.  q: (B,S,H,D), k/v: (B,T,K,D) with H % K == 0.
    ``kv_valid_len`` masks cache positions >= valid length.  Softmax in
    fp32; output in q's dtype."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    qf = q.reshape(B, S, K, H // K, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) \
        / torch.sqrt(torch.tensor(float(D)))
    logits = logits + _mask_bias(S, T, causal=causal, window=window,
                                 q_offset=q_offset, device=q.device)
    if kv_valid_len is not None:
        valid = torch.arange(T, device=q.device)[None, :] \
            < kv_valid_len.reshape(-1, 1)
        logits = logits + torch.where(valid, 0.0, NEG_INF)[
            :, None, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def run_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int = 0, impl: str = "kernel",
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch: "naive" oracle, "chunked" online softmax (plain torch,
    the JAX package's default), or "kernel" (the FA-2 CUDA kernels; their
    plain versions on CPU tensors).  All three are differentiable, and
    each takes DTensors too, running on each rank's local heads and
    rows."""
    if impl == "naive":
        return sharded_heads(attention_core)(q, k, v, causal=causal,
                                             window=window)
    if impl == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if impl != "chunked":
        raise ValueError(f"unknown attn_impl {impl!r}; expected one of "
                         f"{TRAIN_ATTN_IMPLS}")
    return chunked_attention(q, k, v, causal=causal, window=window,
                             scale=scale)


def attn_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, causal: bool = True,
                 impl: str = "kernel") -> torch.Tensor:
    """Full-sequence self-attention sublayer (train / prefill)."""
    h = norm(p["norm"], x, cfg)
    q, k, v = _project_qkv(p, h, cfg)
    q = positional(q, positions, cfg)
    k = positional(k, positions, cfg)
    q = constrain(q, BATCH, None, "model", None)
    k = constrain(k, BATCH, None, "model", None)
    v = constrain(v, BATCH, None, "model", None)
    out = run_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                        impl=impl)
    return x + constrain(_out_proj(out, p["wo"]), BATCH, None, None)


def xattn_forward(p: Dict[str, Any], x: torch.Tensor, enc: torch.Tensor,
                  cfg: ModelConfig, impl: str = "kernel") -> torch.Tensor:
    """Cross-attention sublayer (the whisper decoder): queries from the
    normed decoder stream, keys and values from the encoder output ``enc``
    (B, T, d), non-causal, through ``run_attention`` (the FA-2 kernels with
    S != T for "kernel")."""
    h = norm(p["norm"], x, cfg)
    q, k, v = _project_qkv(p, h, cfg, kv_x=enc)
    out = run_attention(q, k, v, causal=False, impl=impl)
    return x + _out_proj(out, p["wo"])


def project_cross_kv(p: Dict[str, Any], enc: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, v), each (B, T, K, D), of one xattn sublayer from the encoder
    output (B, T, d), in ``enc``'s dtype."""
    k = _proj_heads(enc, p["wk"])
    v = _proj_heads(enc, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(enc.dtype)
        v = v + p["bv"].to(enc.dtype)
    return k, v


def decode_attention_sharded(q: torch.Tensor, cache_k, cache_v, *,
                             index: Optional[int] = None,
                             window: int = 0) -> Any:
    """One query token (B, 1, H, D) against DTensor caches (B, T, K, D)
    sharded on T (and on B where the batch takes it): each rank scores
    its own block in fp32, positions ``<= index`` (and inside
    ``window``) when ``index`` is given, all of them otherwise, and the
    ranks' partial softmax sums are merged (``act_sharding.
    merge_softmax``).  The cache is never gathered.  Returns (B, 1, H,
    Dv) in q's dtype, a DTensor over the cache's rows."""
    qf = rows_like(q, cache_k).float()
    k, start = seq_block(cache_k)
    v, _ = seq_block(cache_v)
    B, _, H, D = qf.shape
    T, K = k.shape[1], k.shape[2]
    s = torch.einsum("bkgd,btkd->bkgt", qf.reshape(B, K, H // K, D),
                     k.float()) / math.sqrt(D)
    if index is not None:
        ok = visible(1, T, causal=False, window=window,
                     q_offset=index - start, device=s.device)[0]
        ok &= torch.arange(start, start + T, device=s.device) <= index
        s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1)
    w = torch.exp(s - m[..., None])
    o = torch.einsum("bkgt,btkd->bkgd", w, v.float())
    out = merge_softmax(m.reshape(B, H), w.sum(dim=-1).reshape(B, H),
                        o.reshape(B, H, -1), cache_k)
    return out[:, None].to(q.dtype)


def xattn_decode(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                 cache_k: torch.Tensor, cache_v: torch.Tensor
                 ) -> torch.Tensor:
    """Cross-attention decode against the encoder K/V projected once at
    cache-warm time (``model.warm_cross_cache``): the plain fp32
    ``attention_core``, as in the JAX package, which runs no kernel
    here (on DTensor caches, :func:`decode_attention_sharded`)."""
    h = norm(p["norm"], x, cfg)
    q = _proj_heads(h, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if is_sharded(cache_k):
        out = decode_attention_sharded(q, cache_k, cache_v)
    else:
        out = attention_core(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                             causal=False)
    return x + _out_proj(out, p["wo"])


def attn_decode(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                cache_k: torch.Tensor, cache_v: torch.Tensor, index: int,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a dense cache.  x: (B,1,d); cache_k/v:
    (B,T,K,D).  The new K/V row is written at ``index`` IN PLACE (the JAX
    package's ``dynamic_update_slice`` returned a new cache); the
    attention is the plain fp32 ``attention_core`` over positions
    ``<= index``, as in the JAX package.  DTensor caches sharded on T
    take :func:`decode_attention_sharded`.  Returns (y, cache_k,
    cache_v)."""
    h = norm(p["norm"], x, cfg)
    q, k, v = _project_qkv(p, h, cfg)
    q = positional(q, positions, cfg)
    k = positional(k, positions, cfg)
    write_row(cache_k, k, index)
    write_row(cache_v, v, index)
    if is_sharded(cache_k):
        out = decode_attention_sharded(q, cache_k, cache_v, index=index,
                                       window=cfg.sliding_window)
        return x + _out_proj(out, p["wo"]), cache_k, cache_v
    valid = torch.full((x.shape[0],), index + 1, device=x.device)
    out = attention_core(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                         causal=False, window=cfg.sliding_window,
                         q_offset=index, kv_valid_len=valid)
    return x + _out_proj(out, p["wo"]), cache_k, cache_v


def attn_decode_paged(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                      *, cache: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, seq_lens: torch.Tensor,
                      positions: torch.Tensor, impl: str = "kernel",
                      num_feed: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode / chunked-prefill step against a PAGED KV cache.  x: (B,C,d)
    — C teacher-forced rows per sequence (C == 1 is plain decode).

    ``cache`` holds this layer's block pools: ``k_pages``/``v_pages``
    (P, bs, K, D), plus ``k_scale``/``v_scale`` ((P, bs, K) fp32) when the
    pools are int8 (quantized here at append, dequantized inside the
    attention).  The new K/V rows are written into the pools IN PLACE
    (``index_put_``), which takes the place of JAX's buffer donation: the
    pools are never copied.  block_tables: (B, NB) int32 page ids;
    seq_lens: (B,) cache positions already written (row ``c`` lands at
    ``seq_lens[b] + c``).  ``num_feed``: (B,) rows actually fed; rows past
    it scatter into the null page 0.  ``impl`` is "kernel" (flash-decode)
    or "gather" (the plain dense-gather version, for comparison).

    Returns (y, cache) — the same pool tensors, updated.
    """
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; expected one of "
                         f"{ATTN_IMPLS}")
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    k_scale = cache.get("k_scale")
    v_scale = cache.get("v_scale")
    B, C, _ = x.shape
    bs = k_pages.shape[1]
    nb = block_tables.shape[1]
    h = norm(p["norm"], x, cfg)
    q, k, v = _project_qkv(p, h, cfg)
    q = positional(q, positions, cfg)
    k = positional(k, positions, cfg)
    # row c's K/V go to position seq_len + c: block (seq_len + c) // bs,
    # offset (seq_len + c) % bs.  Active slots own disjoint pages, so
    # indices collide only on the null page, where any value is fine.
    rows = torch.arange(C, device=x.device)
    pos_idx = seq_lens.long()[:, None] + rows[None, :]
    page_ids = torch.gather(block_tables.long(), 1,
                            (pos_idx // bs).clamp(0, nb - 1))   # (B, C)
    if num_feed is not None:
        fed = rows[None, :] < num_feed.long()[:, None]
        page_ids = torch.where(fed, page_ids, torch.zeros_like(page_ids))
    offs = pos_idx % bs
    if k_scale is not None:                    # int8 pools: quantize at append
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k_pages.index_put_((page_ids, offs), kq)
        v_pages.index_put_((page_ids, offs), vq)
        k_scale.index_put_((page_ids, offs), ks)
        v_scale.index_put_((page_ids, offs), vs)
    else:
        k_pages.index_put_((page_ids, offs), k.to(k_pages.dtype))
        v_pages.index_put_((page_ids, offs), v.to(v_pages.dtype))
    valid = seq_lens + 1                 # incl. the first row just written
    qf = q.float()
    qf = qf[:, 0] if C == 1 else qf            # (B,H,D) | (B,C,H,D)
    attn = flash_decode_paged if impl == "kernel" \
        else paged_attention_reference
    out = attn(qf, k_pages, v_pages, block_tables, valid,
               window=cfg.sliding_window, k_scale=k_scale, v_scale=v_scale)
    if C == 1:
        out = out[:, None]
    out = out.to(x.dtype)                      # (B, C, H, Dv)
    return x + _out_proj(out, p["wo"]), cache


def mlp_forward(p: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Under a mesh the hidden units are pinned column-parallel (rows over
    the batch, units over ``model``) and the output reduced, as Megatron
    lays the MLP out."""
    h = norm(p["norm"], x, cfg)

    def up(w):
        return constrain(h @ w.to(x.dtype), BATCH, None, "model")
    if cfg.mlp_activation == "silu":
        a = F.silu(up(p["wi"])) * up(p["wg"])
    else:
        a = F.gelu(up(p["wi"]), approximate="tanh")  # jax.nn.gelu's default
    return x + constrain(a @ p["wo"].to(x.dtype), BATCH, None, None)
