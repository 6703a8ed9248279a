"""Model FLOPs of a training step, the yardstick of ``mfu`` and
``step_mfu``: forward plus backward (2 + 4 FLOP a token) of every weight
matrix a matmul reads, the tied head once, and causal attention over the
pairs each query sees (q.k and p.v forward, twice that backward).  No
recomputation, no embedding lookup, no norms or biases, no optimizer."""

from __future__ import annotations

from typing import Any, Dict


def matmul_params(model: Dict[str, Any]) -> int:
    """Weights read by matmuls, per token: the layers' projections and the
    head over the real (unpadded) vocabulary."""
    d, L = model["d_model"], model["num_layers"]
    H, K = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    f = model["d_ff"]
    attn = d * H * hd * 2 + d * K * hd * 2          # q, o; k, v
    mlp = d * f * (3 if model["mlp_activation"] == "silu" else 2)
    return L * (attn + mlp) + d * model["vocab_size"]


def attention_flops_fwd(model: Dict[str, Any], batch: int, seq: int) -> float:
    """q.k and p.v over the causal pairs, every layer, forward only."""
    H = model["num_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    pairs = seq * (seq + 1) // 2
    return model["num_layers"] * batch * H * pairs * 2.0 * (hd + hd)


def train_step_flops(model: Dict[str, Any], batch: int, seq: int) -> float:
    """FLOPs of one step over ``batch`` rows of ``seq`` tokens."""
    return (6.0 * matmul_params(model) * batch * seq
            + 3.0 * attention_flops_fwd(model, batch, seq))
