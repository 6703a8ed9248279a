"""Plain PyTorch decoder for the benchmark's configurations: OPT (learned
positions, LayerNorm, biased q/k/v, tanh-GELU MLP) and Granite-3.0
(RoPE, RMSNorm, grouped-query attention, SwiGLU), pre-norm residual
blocks, a final norm and the tied head over the real vocabulary.

It reads the configuration file's ``model`` block and the weight tree of
``lib/weights.py``, imports nothing of the program, and computes in fp32
(TF32 off, see :func:`fp32_matmul`; attention through PyTorch's
``scaled_dot_product_attention`` on fp32 inputs) unless ``quant`` is
given: then every projection's two inputs, and attention's q, k and v,
are first rounded to float8 e4m3 with one scale a tensor (the
benchmark's lower-precision control).  Rows run one at a
time and each layer is recomputed in the backward, so that a full-size
step fits beside nothing else on the card.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        s = amax / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


@contextlib.contextmanager
def fp32_matmul() -> Iterator[None]:
    """Full fp32 matmuls for the duration (TF32 off), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _mm(a: torch.Tensor, b: torch.Tensor, quant: bool) -> torch.Tensor:
    if quant:
        a, b = fp8(a), fp8(b)
    return a @ b


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
          model: Dict[str, Any]) -> torch.Tensor:
    eps = model["norm_eps"]
    if model["norm_type"] == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D): rotate the two halves of D by position x frequency."""
    S, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32) / D))
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv[None, :]
    ang = ang.to(x.device)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               quant: bool) -> torch.Tensor:
    """Causal softmax attention of one row in fp32, through PyTorch's
    ``scaled_dot_product_attention``.  q (S, H, D); k, v (S, K, D); query
    head h reads kv head h // (H / K).  Under ``quant`` q, k and v are
    rounded to float8 first (the probabilities stay inside the call)."""
    S, H, D = q.shape
    K = k.shape[1]
    if quant:
        q, k, v = fp8(q), fp8(k), fp8(v)
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    out = F.scaled_dot_product_attention(
        q.transpose(0, 1)[None], k.transpose(0, 1)[None],
        v.transpose(0, 1)[None], is_causal=True)
    return out[0].transpose(0, 1)                             # (S, H, D)


def layer(x: torch.Tensor, w: Dict[str, Any], model: Dict[str, Any],
          quant: bool) -> torch.Tensor:
    """One pre-norm block on one row x (S, d); ``w`` holds this layer's
    ``s0_attn`` and ``s1_mlp`` leaves in fp32."""
    S, d = x.shape
    a, m = w["s0_attn"], w["s1_mlp"]
    H, K = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    h = _norm(x, a["norm"]["scale"], a["norm"].get("bias"), model)
    q = _mm(h, a["wq"].reshape(d, H * hd), quant).view(S, H, hd)
    k = _mm(h, a["wk"].reshape(d, K * hd), quant).view(S, K, hd)
    v = _mm(h, a["wv"].reshape(d, K * hd), quant).view(S, K, hd)
    if "bq" in a:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    if model["pos_embedding"] == "rope":
        q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
    o = _attention(q, k, v, quant).reshape(S, H * hd)
    x = x + _mm(o, a["wo"].reshape(H * hd, d), quant)
    h = _norm(x, m["norm"]["scale"], m["norm"].get("bias"), model)
    if model["mlp_activation"] == "silu":
        u = F.silu(_mm(h, m["wi"], quant)) * _mm(h, m["wg"], quant)
    else:
        u = F.gelu(_mm(h, m["wi"], quant), approximate="tanh")
    return x + _mm(u, m["wo"], quant)


def _layer(P: Dict[tuple, list], i: int) -> Dict[str, Any]:
    """Layer i's leaves as the nested ``s0_attn`` / ``s1_mlp`` dict."""
    out: Dict[str, Any] = {}
    for path, pieces in P.items():
        if path[:2] != ("decoder", "g0"):
            continue
        node = out
        for k in path[2:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = pieces[i]
    return out


def row_nll(P: Dict[tuple, list], model: Dict[str, Any],
            tokens: torch.Tensor, labels: torch.Tensor, *,
            quant: bool = False) -> torch.Tensor:
    """Summed next-token cross-entropy of one row (tokens, labels (S,)),
    over labels >= 0.  ``P`` maps each leaf path to its fp32 pieces, one a
    layer for the stacked decoder leaves."""
    emb = P[("embed", "tok")][0]
    V = model["vocab_size"]
    x = emb[tokens.long()]
    if ("embed", "pos") in P:
        x = x + P[("embed", "pos")][0][:tokens.shape[0]]
    for i in range(model["num_layers"]):
        x = checkpoint(layer, x, _layer(P, i), model, quant,
                       use_reentrant=False)
    bias = P.get(("final_norm", "bias"))
    h = _norm(x, P[("final_norm", "scale")][0],
              None if bias is None else bias[0], model)
    head = emb[:V] if model.get("tie_embeddings") else \
        P[("lm_head",)][0][:, :V].T
    logits = _mm(h, head.T, quant)
    ok = labels >= 0
    lab = labels.clamp_min(0).long()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, lab[:, None])[:, 0]
    return (nll * ok).sum()


def loss_and_grads(P: Dict[tuple, list], model: Dict[str, Any],
                   tokens: torch.Tensor, labels: torch.Tensor, *,
                   microbatches: int = 1, rows=None, quant: bool = False
                   ) -> tuple:
    """(loss, gradients shaped as ``P``) of the configuration's loss: the
    mean over microbatches of each microbatch's masked mean cross-entropy.
    ``rows`` (default: all) picks the rows that count (a fault check
    leaves some out; the mean is then over those).  Gradients are summed
    row by row in fp32."""
    B = tokens.shape[0]
    per = B // microbatches
    rows = list(range(B)) if rows is None else list(rows)
    groups: Dict[int, list] = {}
    for r in rows:
        groups.setdefault(r // per, []).append(r)
    flat = [t for pieces in P.values() for t in pieces]
    for t in flat:
        t.grad = None
    total = 0.0
    for rs in groups.values():
        count = float(sum(int((labels[r] >= 0).sum()) for r in rs))
        w = 1.0 / (len(groups) * max(count, 1.0))
        for r in rs:
            nll = row_nll(P, model, tokens[r], labels[r], quant=quant)
            (nll * w).backward()
            total += float(nll.detach()) * w
            del nll
    grads = {path: [t.grad for t in pieces] for path, pieces in P.items()}
    for t in flat:
        t.grad = None
    return total, grads
