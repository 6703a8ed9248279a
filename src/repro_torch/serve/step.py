"""Serving steps: full-sequence prefill/scoring and token-by-token dense
decoding (port of ``repro.serve.step``).

The JAX module jitted one decode step per config; PyTorch runs eagerly,
so :func:`jitted_decode_step` keeps the name and returns one cached
callable per config.  The prefill runs ``forward_logits`` through the SSD
scan kernel for ssm layers; :func:`greedy_generate` teacher-forces the
prompt through the dense cache one token at a time, exactly as the JAX
function does, and is what the serving launcher falls back to for
architectures the paged engine cannot hold.  Both run under
``torch.inference_mode()``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

PyTree = Any


@functools.lru_cache(maxsize=64)
def jitted_decode_step(cfg: ModelConfig) -> Callable:
    """One decode-step callable per config (a frozen, hashable dataclass),
    reused across :func:`greedy_generate` calls."""
    def step(params: PyTree, cache: PyTree, tokens: torch.Tensor,
             index: int) -> Tuple[torch.Tensor, PyTree]:
        return M.decode_step(params, cfg, cache, tokens, index)
    return step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params: PyTree, cache: PyTree, tokens: torch.Tensor,
                   index: int, enc: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, PyTree]:
        with torch.inference_mode():
            return M.decode_step(params, cfg, cache, tokens, index, enc=enc)
    return serve_step


def make_prefill(cfg: ModelConfig) -> Callable:
    """Full-sequence logits (B, S, vocab) of ``batch["tokens"]``; ssm
    layers scan through the SSD kernel."""
    def prefill(params: PyTree, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        with torch.inference_mode():
            return M.forward_logits(params, cfg, batch)
    return prefill


def greedy_generate(params: PyTree, cfg: ModelConfig, prompt: torch.Tensor,
                    max_new: int, *, cache_len: Optional[int] = None,
                    enc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-by-token greedy decoding: the prompt (B, S) is teacher-forced
    through the dense cache one token at a time (exactly the serve-step
    path), then ``max_new`` tokens are chosen by argmax.  The cache lives
    on the prompt's device.  With ``enc`` (an encoder-decoder's encoder
    output), the cross-attention caches are warmed once and every step
    reads them.  Returns (B, S + max_new) token ids."""
    B, S = prompt.shape
    T = cache_len or (S + max_new)
    step = jitted_decode_step(cfg)
    with torch.inference_mode():
        cache = M.init_cache(cfg, B, T, device=prompt.device)
        if enc is not None:
            cache = M.warm_cross_cache(params, cfg, cache, enc)
        logits = None
        for i in range(S):
            logits, cache = step(params, cache, prompt[:, i:i + 1], i)
        out = [prompt]
        cur = logits.argmax(dim=-1)[:, None].to(prompt.dtype)
        for j in range(max_new - 1):
            out.append(cur)
            logits, cache = step(params, cache, cur, S + j)
            cur = logits.argmax(dim=-1)[:, None].to(prompt.dtype)
        out.append(cur)
        return torch.cat(out, dim=1)
