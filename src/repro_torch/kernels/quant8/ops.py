"""Per-vector symmetric int8 for KV-cache pages (port of
``repro.kernels.quant8.ops.quantize_kv`` / ``dequantize_kv``).

These were plain ``jnp`` in the JAX package, not a Pallas kernel, so they
are plain torch here.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 codes match the JAX package's exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
