"""Work of one call of each FA-2 kernel (forward, dq, dk/dv), a frozen
copy of the port's count: every (query, key) pair a query sees costs
2 D for q.k (and ds.k, ds.q) and 2 Dv for p.v (and do.v, p.do); each
input is read and each output written once (q, k, v, do, out in the
inputs' type; the per-row log-sum-exp and delta in fp32; dq, dk, dv
written in fp32)."""

from __future__ import annotations

from typing import Dict, Tuple


def pairs(S: int) -> int:
    """The (query, key) pairs causal attention over S positions sees."""
    return S * (S + 1) // 2


def work(B: int, S: int, H: int, K: int, D: int, Dv: int, *,
         elem: int = 2) -> Dict[str, Tuple[float, float]]:
    """{"fwd" | "dq" | "dkdv": (FLOPs, bytes)} of one causal
    self-attention call over B rows of S positions, H query and K key /
    value heads of widths D and Dv, inputs of ``elem`` bytes."""
    p = pairs(S) * B * H
    q, kv = B * H * S * D * elem, B * K * S * (D + Dv) * elem
    do = B * H * S * Dv * elem
    rows = B * H * S * 4
    qkv = q + kv
    return {"fwd": (2.0 * (D + Dv) * p, qkv + do + rows),
            "dq": (2.0 * (2 * D + Dv) * p, qkv + do + 2 * rows
                   + B * H * S * D * 4),
            "dkdv": (4.0 * (D + Dv) * p, qkv + do + 2 * rows
                     + B * K * S * (D + Dv) * 4)}


def bound_s(B: int, S: int, H: int, K: int, D: int, Dv: int,
            flop_per_s: float, bytes_per_s: float, **kw) -> float:
    """The least time of one forward and one backward (dq and dk/dv)."""
    return sum(max(f / flop_per_s, b / bytes_per_s)
               for f, b in work(B, S, H, K, D, Dv, **kw).values())
