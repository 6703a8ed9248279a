"""Plain fp32 oracle for flash attention (causal / sliding-window / GQA);
port of ``repro.kernels.flash_attention.ref``."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def visible(q_len: int, kv_len: int, *, causal: bool, window: int,
            q_offset: int = 0,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """(q_len, kv_len) bool: query row s (at position s + q_offset) sees
    key t — causal (t <= s) and sliding-window (t > s - window) masks."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return ok


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,T,K,D), H % K == 0.  fp32 softmax; the output
    is in q's dtype."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.reshape(B, S, K, g, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * scale
    ok = visible(S, T, causal=causal, window=window, device=q.device)
    logits = logits + torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)
