"""Multi-head latent attention (DeepSeek-V3, arXiv:2412.19437; port of
``repro.models.mla``).

Train and prefill use the expanded form: the latent is projected up to
per-head K/V and attention runs through ``layers.run_attention``, so
``impl="kernel"`` reaches the FA-2 kernels at (qk, v) widths
(qk_nope + qk_rope, v_head_dim), (192, 128) at full width.  Decode uses
the absorbed form: the cache holds only the normed latent
(kv_lora_rank) and the shared rope key, ``W^UK`` is folded into the
query and the scores are taken in latent space in fp32, with the scale
1/sqrt(qk_head_dim).  Cache bytes a token: kv_lora_rank +
qk_rope_head_dim, against 2·H·head_dim for plain multi-head attention.
The absorbed decode is plain ``einsum``s, as the JAX package computes it
outside any Pallas kernel.  Under a ``(data, model)`` mesh q, k and v are
pinned to (batch, heads) before the attention, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.act_sharding import (BATCH, constrain,
                                                  is_sharded, merge_softmax,
                                                  rows_like, seq_block,
                                                  write_row)
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_out_proj, _proj_heads, apply_rope,
                                       norm, run_attention)


def _queries(p: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope, q_rope), each (B, S, H, ·): through the q-LoRA pair
    ``wq_a`` -> ``q_norm`` -> ``wq_b`` when ``q_lora_rank > 0``, else the
    plain ``wq``."""
    m = cfg.mla
    if m.q_lora_rank > 0:
        qa = norm(p["q_norm"], h @ p["wq_a"].to(h.dtype), cfg)
        q = _proj_heads(qa, p["wq_b"])
    else:
        q = _proj_heads(h, p["wq"])
    return q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)


def _latent(p: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normed latent (B, S, rank), rope key before rotation (B, S,
    rope))."""
    m = cfg.mla
    kv_a = h @ p["wkv_a"].to(h.dtype)
    latent, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim],
                                dim=-1)
    return norm(p["kv_norm"], latent, cfg), k_rope


def mla_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, causal: bool = True,
                impl: str = "kernel") -> torch.Tensor:
    """Full-sequence MLA sublayer (expanded form).  x: (B, S, d).  q and k
    are new (B, S, H, qk) tensors and v a slice of the ``wkv_b`` product
    whose rows start at qk_nope_head_dim, so the bf16 kernels' 16-byte
    row check holds at every width the configs use."""
    m = cfg.mla
    h = norm(p["norm"], x, cfg)
    q_nope, q_rope = _queries(p, h, cfg)
    latent, k_rope = _latent(p, h, cfg)
    kv = _proj_heads(latent, p["wkv_b"])
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    H = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(-1, -1, H, -1)], dim=-1)
    q = constrain(q, BATCH, None, "model", None)
    k = constrain(k, BATCH, None, "model", None)
    v = constrain(v, BATCH, None, "model", None)
    out = run_attention(q, k, v, causal=causal, impl=impl)
    return x + constrain(_out_proj(out, p["wo"]), BATCH, None, None)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The latent cache: (B, T, kv_lora_rank) and the rope key (B, T,
    qk_rope_head_dim), on the card unless ``device="cpu"`` is asked
    for."""
    m = cfg.mla
    dev = resolve_device(device)
    return {"latent": torch.zeros((batch, max_len, m.kv_lora_rank),
                                  dtype=dtype, device=dev),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=dev)}


def _absorbed_sharded(q_abs, q_rope, latent_c, k_rope_c, index: int,
                      qk_head_dim: int):
    """The absorbed attention over DTensor caches sharded on T: each rank
    scores its own block of the latent and rope caches, and the partial
    softmax sums of the latent are merged.  Returns (B, H, r) fp32, a
    DTensor over the cache's rows."""
    lat, start = seq_block(latent_c)
    kr, _ = seq_block(k_rope_c)
    lat = lat.float()
    s = (torch.einsum("bhr,btr->bht", rows_like(q_abs, latent_c).float(),
                      lat)
         + torch.einsum("bshk,btk->bht", rows_like(q_rope, latent_c).float(),
                        kr.float())) / math.sqrt(qk_head_dim)
    pos = torch.arange(start, start + lat.shape[1], device=s.device)
    s = torch.where(pos <= index, s, NEG_INF)
    mx = s.amax(dim=-1)
    w = torch.exp(s - mx[..., None])
    return merge_softmax(mx, w.sum(dim=-1),
                         torch.einsum("bht,btr->bhr", w, lat), latent_c)


def mla_decode(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
               cache: Dict[str, torch.Tensor], index: int,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode with the absorbed latent cache.  x: (B, 1, d).
    The token's latent and rope key are written at ``index`` IN PLACE (the
    JAX package's ``dynamic_update_slice`` returned a new cache); scores
    and softmax in fp32 over positions ``<= index``.  On DTensor caches
    sharded on T each rank scores its own block and the partial softmax
    sums are merged (``act_sharding.merge_softmax``).  Returns (y,
    cache)."""
    m = cfg.mla
    h = norm(p["norm"], x, cfg)
    q_nope, q_rope = _queries(p, h, cfg)                 # (B, 1, H, ·)
    latent_t, k_rope_t = _latent(p, h, cfg)              # (B, 1, ·)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope_t = apply_rope(k_rope_t[:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0, :]
    latent_c, k_rope_c = cache["latent"], cache["k_rope"]
    write_row(latent_c, latent_t, index)
    write_row(k_rope_c, k_rope_t, index)

    w_k, w_v = p["wkv_b"].to(x.dtype).split(
        [m.qk_nope_head_dim, m.v_head_dim], dim=-1)     # (r,H,nope),(r,H,v)
    # absorb W^UK into the query: a latent-space query (B, H, r)
    q_abs = torch.einsum("bshk,rhk->bhr", q_nope, w_k)
    if is_sharded(latent_c):
        out_lat = _absorbed_sharded(q_abs, q_rope, latent_c, k_rope_c,
                                    index, m.qk_head_dim)
        out = torch.einsum("bhr,rhv->bhv", out_lat.to(x.dtype), w_v)
        return x + _out_proj(out, p["wo"])[:, None, :], cache
    lat = latent_c.float()
    scores = (torch.einsum("bhr,btr->bht", q_abs.float(), lat)
              + torch.einsum("bshk,btk->bht", q_rope.float(),
                             k_rope_c.float()))
    scores = scores / torch.sqrt(torch.tensor(float(m.qk_head_dim)))
    T = lat.shape[1]
    valid = torch.arange(T, device=x.device)[None, None, :] <= index
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bht,btr->bhr", probs, lat)  # (B, H, r)
    out = torch.einsum("bhr,rhv->bhv", out_lat.to(x.dtype), w_v)
    y = _out_proj(out, p["wo"])                           # (B, d)
    return x + y[:, None, :], cache
