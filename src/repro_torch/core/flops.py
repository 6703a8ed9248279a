"""Analytic FLOP / byte models for decode (the part of ``repro.core.flops``
the serving engine prices its steps with).

decode (1 tok) : 2·N_active·B (+ cache-read attention term)
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig


def _num_attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.num_layers)
               if cfg.layer_kind(i) == "attn")


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
