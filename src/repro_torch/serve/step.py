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

import contextlib
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.act_sharding import current_mesh, mesh_ops, plain
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


def _no_autograd():
    """``inference_mode``, or on an ambient mesh ``no_grad`` with plain
    tensors counting as replicated: views of a DTensor made outside
    inference mode cannot be taken inside it."""
    if current_mesh() is None:
        return torch.inference_mode()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(mesh_ops())
    return stack


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step, ``serve_step(params, cache, tokens, index[,
    enc])``; under an ambient mesh on DTensors placed by
    ``sharding.param_shardings``, ``cache_shardings`` and ``batch_spec``."""
    def serve_step(params: PyTree, cache: PyTree, tokens: torch.Tensor,
                   index: int, enc: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, PyTree]:
        with _no_autograd():
            return M.decode_step(params, cfg, cache, tokens, index, enc=enc)
    return serve_step


def make_prefill(cfg: ModelConfig, *, attn_impl: str = "naive",
                 use_kernel: bool = True) -> Callable:
    """Full-sequence logits (B, S, vocab) of ``batch["tokens"]``; ssm
    layers scan through the SSD kernel unless ``use_kernel`` is False.
    Under an ambient mesh the batch and parameters are DTensors."""
    def prefill(params: PyTree, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        with _no_autograd():
            return M.forward_logits(params, cfg, batch, attn_impl=attn_impl,
                                    use_kernel=use_kernel)
    return prefill


def greedy_generate(params: PyTree, cfg: ModelConfig, prompt: torch.Tensor,
                    max_new: int, *, cache_len: Optional[int] = None,
                    enc: Optional[torch.Tensor] = None,
                    cache: Optional[PyTree] = None,
                    logits: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Token-by-token greedy decoding: the prompt (B, S) is teacher-forced
    through the dense cache one token at a time (exactly the serve-step
    path), then ``max_new`` tokens are chosen by argmax.  The cache is a
    new ``init_cache`` on the prompt's device, or ``cache`` (at least S +
    max_new long; on an ambient mesh placed by
    ``sharding.cache_shardings``, every fed token then placed on the
    batch's rows and the logits gathered whole).  With ``enc`` (an
    encoder-decoder's encoder output), the cross-attention caches are
    warmed once and every step reads them.  ``logits``, a list, receives
    each step's (B, vocab) logits.  Returns (B, S + max_new) token ids."""
    B, S = prompt.shape
    mesh = current_mesh()
    rows = None if mesh is None else sharding.batch_spec(mesh, B) + (None,)
    step = jitted_decode_step(cfg)

    def feed(tok: torch.Tensor, i: int) -> torch.Tensor:
        if rows is not None:
            tok = sharding.shard_tensor(tok, mesh, rows)
        out = plain(step(params, cache, tok, i)[0])
        if logits is not None:
            logits.append(out)
        return out.argmax(dim=-1)[:, None].to(prompt.dtype)

    with _no_autograd():
        if cache is None:
            cache = M.init_cache(cfg, B, cache_len or (S + max_new),
                                 device=prompt.device)
        if enc is not None:
            cache = M.warm_cross_cache(params, cfg, cache, enc)
        for i in range(S):
            cur = feed(prompt[:, i:i + 1], i)
        out = [prompt]
        for j in range(max_new - 1):
            out.append(cur)
            cur = feed(cur, S + j)
        out.append(cur)
        return torch.cat(out, dim=1)
