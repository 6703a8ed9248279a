"""Public int8 wrappers (port of ``repro.kernels.quant8.ops``).

:func:`quantize` / :func:`dequantize` take tensors of any shape through the
blockwise kernels of ``kernel.py`` (the CUDA kernels on the card, their
plain versions on the CPU).  The JAX wrappers padded the flat tensor and
sent a row count the TPU kernel's 256-row tile does not divide to the
plain oracle; here every row count goes to the kernel, which reads the
tail past N as 0 itself, so there is no padded copy and no fallback.

:func:`quantize_kv` / :func:`dequantize_kv` (per-vector int8 for KV-cache
pages) were plain ``jnp`` in the JAX package, not a Pallas kernel, so they
are plain torch here.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 codes match the JAX package's exactly.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                               quantize_blocks)


def quantize(x: torch.Tensor, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Any-shape tensor -> (int8 flat of ceil(N/block)*block codes, fp32
    scales, original shape)."""
    q, s = quantize_blocks(x.reshape(-1), block=block)
    return q, s, tuple(x.shape)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape: Tuple[int, ...],
               block: int = 256, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    flat = dequantize_blocks(q, scale, block=block, dtype=dtype)
    return flat[:math.prod(shape)].reshape(shape)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 (..., D), fp32 scales (...,)); one amax/127
    scale per trailing ``head_dim`` vector (1 for an all-zero vector)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: (..., D) int8 + (...,) scales."""
    return (q.float() * scale[..., None]).to(dtype)
