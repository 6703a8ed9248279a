"""Plain PyTorch versions of AdamW's clipping norm and of one leaf's
update (the loop body of ``repro.optim.adamw.apply_updates``, in its
order).

Every step is fp32 whatever the storage dtypes: the gradient scaled by
``clip``, the moments' exponential averages, the bias-corrected step,
decoupled decay on >= 2-D leaves only, then the parameter and moments
written back in place, each rounded once to its dtype.  The CPU path of
``optim.adamw.apply_updates`` runs these, and so does any leaf the CUDA
kernels do not take (a ``meta`` tensor of the dry run, a strided view);
the card tests hold the kernels to them.
"""

from __future__ import annotations

import torch


def square_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """Σ x² of one leaf, fp32 (0-d)."""
    return x.float().square().sum()


def adamw_update_reference(p: torch.Tensor, g: torch.Tensor,
                           mu: torch.Tensor, nu: torch.Tensor, *,
                           lr: torch.Tensor, clip: torch.Tensor,
                           bc1: torch.Tensor, bc2: torch.Tensor, b1: float,
                           b2: float, eps: float, weight_decay: float,
                           decay: bool) -> None:
    """One leaf's AdamW step, in place on ``p``, ``mu`` and ``nu``;
    ``decay`` adds ``weight_decay * p`` (the leaf has >= 2 dims)."""
    g = g.float() * clip
    mu_f = mu.float() * b1 + (1 - b1) * g
    nu_f = nu.float() * b2 + (1 - b2) * g.square()
    delta = (mu_f / bc1) / ((nu_f / bc2).sqrt() + eps)
    if decay:
        delta = delta + weight_decay * p.float()
    p.copy_(p.float() - lr * delta)
    mu.copy_(mu_f)
    nu.copy_(nu_f)
