"""Analytic FLOP / byte models (a copy of ``repro.core.flops``): what the
trainer, the serving engine, the planners and the carbon models price with.

train step     : 6·N·D  (+ attention term 12·L·S²·H·hd·(1/2 causal) x3)
decode (1 tok) : 2·N_active·B (+ cache-read attention term)
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig


def _num_attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.num_layers)
               if cfg.layer_kind(i) == "attn")


def _attn_flops_per_seq(cfg: ModelConfig, S: int, causal: bool = True
                        ) -> float:
    """QK^T + PV flops for one sequence, all attention layers."""
    if cfg.attention == "mla":
        qk_dim = cfg.mla.qk_head_dim
        v_dim = cfg.mla.v_head_dim
    else:
        qk_dim = v_dim = cfg.resolved_head_dim
    per_layer = 2.0 * S * S * cfg.num_heads * (qk_dim + v_dim)
    if cfg.sliding_window and S > cfg.sliding_window:
        per_layer *= cfg.sliding_window / S          # SWA cuts the window
    elif causal:
        per_layer *= 0.5
    return _num_attn_layers(cfg) * per_layer


def _ssd_flops_per_seq(cfg: ModelConfig, S: int) -> float:
    """SSD chunked-scan flops for one sequence, all SSM layers."""
    if not cfg.ssm.enabled:
        return 0.0
    ssm = cfg.ssm
    n_ssm = cfg.num_layers - _num_attn_layers(cfg)
    n, Q, p = ssm.d_state, ssm.chunk_size, ssm.head_dim
    per_head_chunk = 2.0 * (Q * Q * n + Q * Q * p + 2 * Q * p * n)
    return n_ssm * ssm.num_heads(cfg.d_model) * (S / Q) * per_head_chunk


def fwd_flops(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    return (2.0 * cfg.active_param_count() * batch * seq_len
            + batch * _attn_flops_per_seq(cfg, seq_len)
            + batch * _ssd_flops_per_seq(cfg, seq_len))


def train_flops(cfg: ModelConfig, batch: int, seq_len: int,
                remat: bool = True) -> float:
    """fwd + bwd (2x fwd) [+ recompute fwd if remat]."""
    return (4.0 if remat else 3.0) * fwd_flops(cfg, batch, seq_len)


def decode_flops(cfg: ModelConfig, batch: int, cache_len: int) -> float:
    n_active = cfg.active_param_count()
    # attention: q·Kᵀ + p·V over the cache (linear in cache_len)
    if cfg.attention == "mla":
        per_tok_attn = 2.0 * cache_len * cfg.num_heads * (
            cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
    else:
        hd = cfg.resolved_head_dim
        w = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        per_tok_attn = 2.0 * w * cfg.num_heads * 2 * hd
    ssm_step = 0.0
    if cfg.ssm.enabled:
        n_ssm = cfg.num_layers - _num_attn_layers(cfg)
        ssm_step = n_ssm * 6.0 * cfg.ssm.num_heads(cfg.d_model) \
            * cfg.ssm.head_dim * cfg.ssm.d_state
    return batch * (2.0 * n_active + _num_attn_layers(cfg) * per_tok_attn
                    + ssm_step)


def param_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    return cfg.param_count() * dtype_bytes


def train_state_bytes(cfg: ModelConfig, param_dtype: int = 2,
                      moment_dtype: int = 4) -> float:
    """weights + grads + two Adam moments."""
    n = cfg.param_count()
    return n * (param_dtype + 4 + 2 * moment_dtype)


def kv_cache_bytes(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype_bytes: int = 2) -> float:
    if cfg.attention == "mla":
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
        if cfg.sliding_window:
            cache_len = min(cache_len, cfg.sliding_window)
    total = _num_attn_layers(cfg) * batch * cache_len * per_tok * dtype_bytes
    if cfg.ssm.enabled:
        ssm = cfg.ssm
        n_ssm = cfg.num_layers - _num_attn_layers(cfg)
        total += n_ssm * batch * 4 * (
            ssm.num_heads(cfg.d_model) * ssm.head_dim * ssm.d_state)
    return total


def activation_bytes(cfg: ModelConfig, batch: int, seq_len: int,
                     dtype_bytes: int = 2) -> float:
    """Layer-boundary activations (what the idealized DAG method transmits)."""
    return cfg.num_layers * batch * seq_len * cfg.d_model * dtype_bytes


def decode_hbm_bytes(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype_bytes: int = 2) -> float:
    """Weights read once + cache read once per decode step."""
    return (cfg.active_param_count() * dtype_bytes
            + kv_cache_bytes(cfg, batch, cache_len, dtype_bytes))


def summary(cfg: ModelConfig, batch: int, seq_len: int) -> Dict[str, float]:
    return {
        "params": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "train_flops": train_flops(cfg, batch, seq_len),
        "fwd_flops": fwd_flops(cfg, batch, seq_len),
        "param_bytes_bf16": param_bytes(cfg),
        "train_state_bytes": train_state_bytes(cfg),
    }
