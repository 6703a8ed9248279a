"""Mixture-of-experts FFN with sort-based static-capacity dispatch (port of
``repro.models.moe``).

Dispatch is computed *per batch row*: each row sorts its S·k assignments
by expert id (stable, so an expert's assignments keep token order) and
places them into a fixed capacity of C slots per expert.  Tokens beyond
capacity are dropped (GShard/Switch semantics): their slot is a scratch
row past the buffer, which is cut off before the experts run and reads
as zeros in the combine.  The router runs in fp32; a Switch-style
load-balance auxiliary loss is returned.  Single-token decode (S == 1)
dispatches over the flat batch instead, with the capacity of B tokens.

The buffer is laid out expert-major, (E, B·C, d), so each expert's
weights are read once a call, whatever the batch: the expert products
are one ``bmm`` per weight over all rows.  The gathers, scatters and
expert products are plain PyTorch ops, as the JAX package left them to
XLA.

Under a ``(data, model)`` mesh (DTensors) the dispatch plan, the buffer
fill and the combine run on each rank's own batch rows (``local_map``:
they are per row), and ``MoEConfig.layout`` places the buffer as the
JAX package's does: "auto", experts over ``model`` and rows over
``data``; "ep_full", when the expert count divides model x data, experts
over both and the rows replicated (every rank plans every row, and its
experts' weights never move); "unconstrained", nothing pinned, DTensor
choosing.  The combine gathers the experts' outputs back over the rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import (BATCH, axis_extent,
                                                  constrain,
                                                  constrained_placements,
                                                  is_sharded)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norm


def _act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_activation == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")           # jax.nn.gelu's default


def router_probs(p: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (..., d) -> fp32 probs (..., E), top-k weights (renormalised)
    and expert ids."""
    logits = h.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.moe.experts_per_token, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return probs, top_w, top_i


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss: E * <f_e> . <p_e> (over all tokens)."""
    probs2 = probs.reshape(-1, num_experts)
    ids = top_i.reshape(-1, top_i.shape[-1])
    assign = F.one_hot(ids, num_experts).float()
    frac_tokens = assign.sum(dim=1).mean(dim=0)
    frac_probs = probs2.mean(dim=0)
    return num_experts * (frac_tokens * frac_probs).sum()


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert takes per dispatch row: top-k/E of the tokens
    times the capacity factor, rounded up to a multiple of 8 and at
    least 8 (the JAX package's TPU lane alignment, kept because which
    tokens are dropped depends on it)."""
    m = cfg.moe
    c = math.ceil(num_tokens * m.experts_per_token / m.num_experts
                  * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _expert_ffn(p: Dict[str, Any], buf: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """buf: (E, R, d) -> (E, R, d) through each expert's FFN."""
    wi = p["wi"].to(buf.dtype)
    a = _act(torch.bmm(buf, wi), cfg)
    if cfg.mlp_activation == "silu":
        a = a * torch.bmm(buf, p["wg"].to(buf.dtype))
    return torch.bmm(a, p["wo"].to(buf.dtype))


def _shared_ffn(p: Dict[str, Any], h: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    a = _act(h @ p["shared_wi"].to(h.dtype), cfg)
    if cfg.mlp_activation == "silu":
        a = a * (h @ p["shared_wg"].to(h.dtype))
    return a @ p["shared_wo"].to(h.dtype)


def dispatch_plan(top_i: torch.Tensor, C: int, num_experts: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Where each of a row's N·k assignments goes.  top_i: (B, N, k).

    Returns (sort_idx, keep, slot, token_src), each (B, N·k) in sorted
    order: the stable sort by expert id, whether the assignment is within
    its expert's C slots, its row of the (E·B·C + 1)-row buffer (expert e,
    batch row b, position q at e·B·C + b·C + q; dropped ones at the last,
    scratch row) and the token it carries."""
    B, N, k = top_i.shape
    E = num_experts
    flat_e = top_i.reshape(B, N * k)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    counts = torch.zeros((B, E), dtype=torch.long, device=top_i.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(N * k, device=top_i.device)[None, :] \
        - torch.gather(starts, 1, sorted_e)          # slot within expert
    keep = pos < C
    rows = torch.arange(B, device=top_i.device)[:, None]
    slot = torch.where(keep, sorted_e * (B * C) + rows * C + pos,
                       torch.full_like(pos, E * B * C))
    return sort_idx, keep, slot, sort_idx // k


def _dispatch_combine(h: torch.Tensor, top_w: torch.Tensor,
                      top_i: torch.Tensor, p: Dict[str, Any],
                      cfg: ModelConfig, C: int) -> torch.Tensor:
    """Batched dispatch.  h: (B, N, d); top_w/top_i: (B, N, k) ->
    (B, N, d)."""
    if is_sharded(h):
        return _dispatch_combine_sharded(h, top_w, top_i, p, cfg, C)
    buf, sort_idx, keep, slot, token_src = _fill(h, top_i,
                                                 cfg.moe.num_experts, C)
    out = _expert_ffn(p, buf, cfg)
    return _combine(out, top_w, sort_idx, keep, slot, token_src)


def _fill(h: torch.Tensor, top_i: torch.Tensor, num_experts: int, C: int):
    """Per-row dispatch of local rows: (buf (E, B·C, d), sort_idx, keep,
    slot, token_src)."""
    B, N, d = h.shape
    sort_idx, keep, slot, token_src = dispatch_plan(top_i, C, num_experts)
    src = (torch.arange(B, device=h.device)[:, None] * N + token_src)
    buf = torch.zeros((num_experts * B * C + 1, d), dtype=h.dtype,
                      device=h.device)
    buf.index_put_((slot.reshape(-1),), h.reshape(B * N, d)[src.reshape(-1)])
    return (buf[:-1].view(num_experts, B * C, d), sort_idx, keep, slot,
            token_src)


def _combine(out: torch.Tensor, top_w: torch.Tensor, sort_idx: torch.Tensor,
             keep: torch.Tensor, slot: torch.Tensor,
             token_src: torch.Tensor) -> torch.Tensor:
    """The experts' outputs (E, B·C, d) of local rows back to (B, N, d),
    weighted; dropped assignments read the zero scratch row."""
    B = sort_idx.shape[0]
    N = top_w.shape[1]
    d = out.shape[-1]
    out = torch.cat([out.reshape(-1, d),
                     torch.zeros((1, d), dtype=out.dtype, device=out.device)])
    w = torch.gather(top_w.reshape(B, -1), 1, sort_idx) * keep
    gathered = out[slot.reshape(-1)] * w.reshape(-1, 1).to(out.dtype)
    src = (torch.arange(B, device=out.device)[:, None] * N + token_src)
    y = torch.zeros((B * N, d), dtype=out.dtype, device=out.device)
    y.index_add_(0, src.reshape(-1), gathered)
    return y.view(B, N, d)


def _dispatch_combine_sharded(h, top_w, top_i, p: Dict[str, Any],
                              cfg: ModelConfig, C: int):
    """:func:`_dispatch_combine` for DTensors (see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    E = m.num_experts
    mesh = h.device_mesh
    ep = axis_extent("model") * axis_extent("data")
    ep_full = ep > 1 and E % ep == 0 and m.layout == "ep_full"
    if ep_full:
        rows = [Replicate()] * mesh.ndim
    else:
        rows = [pl if pl == Shard(0) else Replicate()
                for pl in constrained_placements(h, mesh, BATCH)]
    slots = [Shard(1) if pl == Shard(0) else Replicate() for pl in rows]
    h, top_w, top_i = (t.redistribute(mesh, rows) for t in (h, top_w, top_i))
    buf, sort_idx, keep, slot, token_src = local_map(
        lambda a, b: _fill(a, b, E, C),
        out_placements=(slots, rows, rows, rows, rows),
        in_placements=(rows, rows), device_mesh=mesh)(h, top_i)
    if m.layout != "unconstrained":
        e_axes = ("model", "data") if ep_full else "model"
        buf = constrain(buf, e_axes, None if ep_full else BATCH, None)
    out = _expert_ffn(p, buf, cfg)
    if m.layout != "unconstrained":
        out = constrain(out, e_axes, None if ep_full else BATCH, None)
    out = out.redistribute(mesh, slots)
    return local_map(_combine, out_placements=rows,
                     in_placements=(slots, rows, rows, rows, rows, rows),
                     device_mesh=mesh)(out, top_w, sort_idx, keep, slot,
                                       token_src)


def moe_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (residual output, aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    h = norm(p["norm"], x, cfg)
    probs, top_w, top_i = router_probs(p, h, cfg)
    aux = load_balance_loss(probs, top_i, m.num_experts) \
        * m.router_aux_loss_coef
    if S == 1:
        # decode: flat whole-batch dispatch (1 token per sequence)
        y = _dispatch_combine(h.reshape(1, B, d), top_w.reshape(1, B, -1),
                              top_i.reshape(1, B, -1), p, cfg,
                              capacity(B, cfg)).reshape(B, 1, d)
    else:
        y = _dispatch_combine(h, top_w, top_i, p, cfg, capacity(S, cfg))
    if m.num_shared_experts > 0:
        y = y + _shared_ffn(p, h, cfg)
    return x + y, aux
