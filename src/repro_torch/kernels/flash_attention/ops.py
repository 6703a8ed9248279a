"""Public flash attention in (B, S, H, D) layout (port of
``repro.kernels.flash_attention.ops``).

The layout swaps are views: the kernels read and write through strides,
and they sit outside :class:`~repro_torch.kernels.flash_attention.kernel.
FlashAttention`, so autograd through this wrapper reaches the FA-2
backward kernels.  CUDA tensors launch the kernels, CPU tensors run their
plain versions (the JAX package's interpret mode has no counterpart).
DTensors (under a ``(data, model)`` mesh) go in too: the kernels then run
on each rank's own rows and heads, after the tensor-parallel K/V layout
(``chunked.sharded_heads``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.chunked import sharded_heads
from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


@sharded_heads
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,D); k (B,T,K,D), v (B,T,K,Dv) with H % K == 0.  Returns
    (B,S,H,Dv) in q's dtype."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, scale=scale)
    return out.transpose(1, 2)
