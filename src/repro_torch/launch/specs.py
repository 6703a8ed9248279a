"""Stand-ins for every model input, with no storage: tensors on the
``meta`` device, the port's ``jax.ShapeDtypeStruct`` (port of
``repro.launch.specs``).

``input_specs(cfg, shape)`` gives the batch the train/prefill step
consumes, ``decode_specs`` the (tokens, index) pair of a decode step.
The vision and audio frontends are stubs: patch and frame embeddings of
the right shape stand in for their encoders.  ``vlm_split`` is shared
with the data pipeline.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.registry import InputShape
from repro_torch.models.config import ModelConfig


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def vlm_split(seq_len: int) -> Tuple[int, int]:
    """(vision tokens, text tokens) for a VLM sequence budget."""
    v = min(1024, seq_len // 4)
    return v, seq_len - v


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Batch spec for a train/prefill step."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    emb_dt = getattr(torch, cfg.compute_dtype)
    if cfg.is_encoder_decoder:
        # whisper: the geometry is the model's (1500 frames, <= 448 decoder)
        S_dec = cfg.max_target_positions
        return {"frames": _meta((B, cfg.encoder_seq_len, d), emb_dt),
                "tokens": _meta((B, S_dec), torch.int32),
                "labels": _meta((B, S_dec), torch.int32)}
    if cfg.arch_type == "vlm":
        Sv, St = vlm_split(S)
        return {"tokens": _meta((B, St), torch.int32),
                "vision_embeds": _meta((B, Sv, d), emb_dt),
                "labels": _meta((B, S), torch.int32),
                "positions": _meta((3, B, S), torch.int32)}
    return {"tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32)}


def decode_specs(cfg: ModelConfig, shape: InputShape
                 ) -> Dict[str, torch.Tensor]:
    """(tokens, index[, enc]) specs of a decode step; the cache comes
    separately (``models.model.abstract_cache``)."""
    B = shape.global_batch
    out = {"tokens": _meta((B, 1), torch.int32),
           "index": _meta((), torch.int32)}
    if cfg.is_encoder_decoder:
        out["enc"] = _meta((B, cfg.encoder_seq_len, cfg.d_model),
                           getattr(torch, cfg.compute_dtype))
    return out


def cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.is_encoder_decoder:
        return cfg.max_target_positions
    return shape.seq_len
