"""Chunked online-softmax attention with a recompute backward (port of
``repro.kernels.flash_attention.chunked``, the JAX package's default
training attention).

The algorithm is the kernels' (stream K/V in chunks, fp32 running max and
sum, O(S) residuals out + lse, scores recomputed per chunk in the
backward), written as plain torch ops over chunks.  The precision follows
the JAX twin: inputs keep their dtype, products accumulate in fp32 (here
by upcasting each operand, where JAX asked for fp32 accumulation), and
the probabilities and ``ds`` are rounded to the input dtype before the
products that consume them.  Given DTensors (under a ``(data, model)``
mesh), the attention runs on each rank's own rows and heads
(:func:`sharded_heads`), after the JAX package's tensor-parallel K/V
layout (:func:`tp_kv_layout`).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.distributed.act_sharding import (axis_extent, head_parallel,
                                                  is_sharded)
from repro_torch.kernels.flash_attention.ref import NEG_INF, visible

DEFAULT_CHUNK = 512


def _chunk_scores(qf, k, c0, c1, causal, window, scale):
    """Masked fp32 scores of every query against keys [c0, c1)."""
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k[:, :, c0:c1].float()) * scale
    # row s against key c0 + t is row s + (-c0) against key t
    ok = visible(qf.shape[3], c1 - c0, causal=causal, window=window,
                 q_offset=-c0, device=qf.device)
    return s.masked_fill(~ok, NEG_INF)


def tp_kv_layout(num_heads: int, k: torch.Tensor, v: torch.Tensor):
    """The GQA / tensor-parallel layout: when the merged head count H
    divides the ``model`` extent but neither the K/V head count nor the
    group size does (granite's 32 = 8 x 4 on 16; qwen2-vl-smoke's 4 = 2 x
    2 on 4), K/V are repeated to H heads before the head split, so each
    rank holds its own K/V heads and attention stays head-parallel (each
    query head h reads K/V head h // g, as before).  Otherwise (k, v) as
    they are; where neither K, g nor H divides, the heads stay whole on
    every ``model`` rank (:func:`head_parallel`)."""
    K = k.shape[2]
    g = num_heads // K
    tp = axis_extent("model")
    if tp > 1 and g > 1 and num_heads % tp == 0 and K % tp and g % tp:
        B, T = k.shape[:2]
        k = k[:, :, :, None].expand(B, T, K, g, k.shape[-1]) \
            .reshape(B, T, num_heads, k.shape[-1])
        v = v[:, :, :, None].expand(B, T, K, g, v.shape[-1]) \
            .reshape(B, T, num_heads, v.shape[-1])
    return k, v


def sharded_heads(fn: Callable) -> Callable:
    """``fn(q, k, v, **kw)``, an attention over (B, S, H, D) tensors, that
    also takes DTensors: K/V in :func:`tp_kv_layout`, then ``fn`` on each
    rank's local rows and heads (``act_sharding.head_parallel``)."""
    @functools.wraps(fn)
    def run(q, k, v, **kw):
        if not is_sharded(q):
            return fn(q, k, v, **kw)
        k, v = tp_kv_layout(q.shape[2], k, v)
        return head_parallel(fn, q, k, v, **kw)
    return run


class ChunkedAttention(torch.autograd.Function):
    """q (B,K,g,S,D), k/v (B,K,T,D) in the input dtype.  Returns the fp32
    output (B,K,g,S,Dv); the residuals are (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float,
                chunk: int):
        B, K, g, S, _ = q.shape
        T, Dv = k.shape[2], v.shape[-1]
        qf = q.float()
        m = torch.full((B, K, g, S), NEG_INF, device=q.device)
        l = torch.zeros((B, K, g, S), device=q.device)
        acc = torch.zeros((B, K, g, S, Dv), device=q.device)
        for c0 in range(0, T, chunk):
            c1 = min(T, c0 + chunk)
            s = _chunk_scores(qf, k, c0, c1, causal, window, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,bktd->bkgsd", p.to(v.dtype).float(),
                v[:, :, c0:c1].float())
            m = m_new
        l = l.clamp_min(1e-30)
        out = acc / l[..., None]
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, scale, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, chunk = ctx.opts
        T = k.shape[2]
        dout = dout.float()
        delta = (dout * out).sum(dim=-1)                   # (B,K,g,S)
        qf = q.float()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        for c0 in range(0, T, chunk):
            c1 = min(T, c0 + chunk)
            s = _chunk_scores(qf, k, c0, c1, causal, window, scale)
            p = torch.exp(s - lse[..., None])
            pc = p.to(q.dtype).float()
            dv[:, :, c0:c1] = torch.einsum("bkgst,bkgsd->bktd", pc, dout)
            dp = torch.einsum("bkgsd,bktd->bkgst", dout,
                              v[:, :, c0:c1].float())
            ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
            dq += torch.einsum("bkgst,bktd->bkgsd", ds,
                               k[:, :, c0:c1].float())
            dk[:, :, c0:c1] = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


@sharded_heads
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Flash attention, (B,S,H,D) layout, GQA via K/V head groups."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.reshape(B, S, K, H // K, D).permute(0, 2, 3, 1, 4)
    out = ChunkedAttention.apply(qf, k.transpose(1, 2), v.transpose(1, 2),
                                 causal, int(window), float(scale),
                                 min(chunk, T))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, v.shape[-1])
    return out.to(q.dtype)
