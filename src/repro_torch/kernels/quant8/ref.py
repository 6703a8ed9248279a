"""Plain PyTorch versions of blockwise symmetric int8 quantization (port of
``repro.kernels.quant8.ref``).

Values are quantized per contiguous block of ``block`` elements with one
fp32 scale, amax / 127 (1 for an all-zero block); codes are
clip(round(x / scale), -127, 127).  ``torch.round`` rounds half to even,
as ``jnp.round`` does.  The scale is amax times the fp32 reciprocal of
127, not a true division: XLA rewrites a division by a constant into that
product when it compiles the JAX kernel (and PyTorch's CUDA division by a
Python scalar does the same), and a true division differs from it in the
last bit of about 4 % of the scales.  Written as the product, the scales
and codes equal the JAX package's compiled ones on the CPU and on the
card alike.  The CPU path of the kernels' wrappers runs these, and
``chip_smoke.py`` holds the CUDA kernels to them.
"""

from __future__ import annotations

from typing import Tuple

import torch

INV_127 = 1.0 / 127.0       # rounds to the fp32 nearest 1/127 when applied


def quantize_reference(x: torch.Tensor, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N,) with N % block == 0 -> (int8 values (N,), fp32 scales
    (N/block,))."""
    xb = x.float().reshape(-1, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def dequantize_reference(q: torch.Tensor, scale: torch.Tensor,
                         block: int = 256,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    qb = q.reshape(-1, block).float()
    return (qb * scale[:, None]).reshape(-1).to(dtype)
