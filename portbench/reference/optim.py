"""Plain PyTorch optimizer arithmetic, as the configuration files state
it: AdamW with global-norm clipping, linear warm-up and cosine decay,
decoupled decay on leaves of two or more dimensions, fp32 moments;
blockwise symmetric int8 with error feedback; DiLoCo's Nesterov outer
step.  Parameters are held as fp32 pieces (one a layer for stacked
leaves) and rounded to the storage type after every update.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

Pieces = Dict[tuple, List[torch.Tensor]]
INV_127 = 1.0 / 127.0


def lr_at(opt: Dict[str, Any], step: int) -> torch.Tensor:
    """Linear warm-up to ``learning_rate``, cosine decay to
    ``min_lr_ratio`` of it by ``decay_steps`` (fp32)."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp(s / max(opt["warmup_steps"], 1), max=1.0)
    frac = torch.clamp((s - opt["warmup_steps"])
                       / max(opt["decay_steps"] - opt["warmup_steps"], 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    scale = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos
    return opt["learning_rate"] * warm * scale


def global_norm(G: Pieces) -> torch.Tensor:
    return torch.stack([g.square().sum() for ps in G.values() for g in ps]
                       ).sum().sqrt()


class AdamW:
    """One replica's AdamW state over ``P``; ``decay`` names the leaves
    (by their whole stacked shape) that take weight decay."""

    def __init__(self, P: Pieces, opt: Dict[str, Any],
                 decay: Dict[tuple, bool]):
        self.opt, self.decay, self.t = opt, decay, 0
        self.m = {k: [torch.zeros_like(p) for p in ps] for k, ps in P.items()}
        self.v = {k: [torch.zeros_like(p) for p in ps] for k, ps in P.items()}

    @torch.no_grad()
    def step(self, P: Pieces, G: Pieces, storage: torch.dtype
             ) -> Dict[tuple, float]:
        """Updates ``P`` in place; returns each leaf's norm of the
        gradient as clipped, the gradient the update read."""
        o = self.opt
        self.t += 1
        lr = lr_at(o, self.t).to(next(iter(P.values()))[0].device)
        gn = global_norm(G)
        clip = torch.clamp(o["clip_norm"] / torch.clamp(gn, min=1e-9),
                           max=1.0) if o["clip_norm"] > 0 else 1.0
        b1, b2 = o["b1"], o["b2"]
        bc1 = 1.0 - b1 ** self.t
        bc2 = 1.0 - b2 ** self.t
        sq = {}
        for k, ps in P.items():
            acc = 0.0
            for p, g, m, v in zip(ps, G[k], self.m[k], self.v[k]):
                g = g * clip
                acc = acc + g.square().sum()
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g.square())
                delta = (m / bc1) / ((v / bc2).sqrt() + o["eps"])
                if self.decay[k]:
                    delta = delta + o["weight_decay"] * p
                p.copy_((p - lr * delta).to(storage).float())
            sq[k] = acc
        return {k: float(torch.as_tensor(a).sqrt()) for k, a in sq.items()}


def int8_round_trip(x: torch.Tensor, block: int) -> torch.Tensor:
    """x (flat fp32) through blockwise int8 and back: one scale a block of
    ``block`` elements, amax x fp32(1/127) (1 for an all-zero block),
    codes clip(round(x / scale), -127, 127), the tail padded with 0."""
    n = x.numel()
    pad = -(-n // block) * block - n
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(-1, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale), -127, 127)
    return (q * scale).reshape(-1)[:n]


def compress(d: torch.Tensor, e: Optional[torch.Tensor], block: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the value sent, the new error) of one flat leaf with error
    feedback."""
    g = d if e is None else d + e
    sent = int8_round_trip(g, block)
    return sent, g - sent


@torch.no_grad()
def outer_step(glob: Dict[tuple, torch.Tensor], mean: Dict[tuple, torch.Tensor],
               mom: Dict[tuple, torch.Tensor], lr: float, mu: float,
               nesterov: bool, storage: torch.dtype) -> None:
    """m <- mu m + d; p <- p - lr (d + mu m) (Nesterov) or p - lr m;
    every leaf flat, ``glob`` in fp32 rounded to ``storage``."""
    for k in glob:
        d = mean[k]
        mom[k].mul_(mu).add_(d)
        upd = d + mu * mom[k] if nesterov else mom[k]
        glob[k] = (glob[k] - lr * upd).to(storage).float()
