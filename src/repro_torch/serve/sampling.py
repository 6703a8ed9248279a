"""Token sampling for the serving engine: greedy + temperature / top-k.

Port of ``repro.serve.sampling``.  One vectorized sampler covers every
slot of a step: per-slot ``temperature`` and ``top_k`` arrive as tensors;
``temperature <= 0`` means greedy (an exact argmax, first index on ties),
``top_k <= 0`` disables the top-k filter.  Random draws come from the
caller's ``torch.Generator`` (one per engine, seeded from its config); they
cannot match ``jax.random.categorical`` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # <= 0 -> greedy
    top_k: int = 0                    # <= 0 -> no filter


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: torch.Tensor,
                  top_k: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) f32; temperature/top_k: (B,).  Returns (B,) int64."""
    B, V = logits.shape
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    hot = temperature > 0
    if not bool(hot.any()):
        return greedy
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    # per-slot top-k: keep logits >= the k-th largest; k <= 0 keeps all
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    keep = (scaled >= kth) | (top_k[:, None] <= 0)
    probs = torch.softmax(scaled.masked_fill(~keep, NEG_INF), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(hot, sampled, greedy)
