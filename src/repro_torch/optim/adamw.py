"""AdamW (decoupled weight decay) over parameter dicts (port of
``repro.optim.adamw``).

The update math is the JAX package's, in its order: fp32 throughout
whatever the storage dtypes, global-norm clipping, bias correction, decay
inside the step on >= 2-D leaves only, the new parameter cast back to its
dtype and the moments stored in ``moment_dtype``.  Where the JAX update
returned new arrays (and the trainer donated the old ones), this one
writes parameters and moments in place under ``no_grad``: no second copy
of the model or its optimizer state is ever allocated.  On a ``(data,
model)`` mesh the parameters, gradients and moments are DTensors placed
alike: the clipping norm is reduced over the whole model and each leaf's
update runs on the rank's own shards, so no optimizer state is ever
gathered.

The norm's sums of squares and each leaf's update go through the
wrappers of ``kernels/adamw``: on the card their hand-written kernels
(one launch a leaf each, the plain loop's math bit for bit, no host
sync; a card tensor they cannot read raises), on the CPU the plain loop
of ``kernels/adamw/ref.py``.  A ``meta`` or fake leaf (the dry run's
trace) has no data for a kernel to read and takes the plain loop here.
With the tracer on, the counter ``adamw/fused_share`` records each
step's share of elements the update kernel took.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.distributed.act_sharding import is_sharded, zeros_beside
from repro_torch.kernels.adamw import kernel as K
from repro_torch.kernels.adamw import ref as R
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.obs.trace import get_tracer

PyTree = Any


@dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step: Union[int, torch.Tensor]
             ) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio`` (fp32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * scale


def init_opt_state(params: PyTree, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments beside each parameter, and the step count (a 0-d int
    tensor on the parameters' device, so the update never syncs)."""
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p: torch.Tensor) -> torch.Tensor:
        return zeros_beside(p, dt)        # the parameter's placements
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(leaves: Union[PyTree, List[torch.Tensor]]) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in fp32.  For DTensor leaves, the norm
    of the whole model: each rank sums the squares of its own shards, a
    leaf replicated over ``r`` ranks counted 1/r a rank, and one reduction
    over the mesh adds them up; the result is a plain tensor."""
    if not isinstance(leaves, list):
        leaves = tree_leaves(leaves)
    if leaves and is_sharded(leaves[0]):
        return _sharded_norm(leaves)
    return torch.stack(_square_sums(leaves)).sum().sqrt()


def _abstract(t: torch.Tensor) -> bool:
    """A ``meta`` or fake tensor: a trace, with no data to read."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "meta" or is_fake(t)


def _square_sums(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Σ x² of each leaf, fp32 (0-d each)."""
    if _abstract(xs[0]):
        return [R.square_sum_reference(x) for x in xs]
    return list(K.square_sums(xs).unbind())


def _sharded_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = leaves[0].device_mesh
    parts = []
    for x, sq in zip(leaves, _square_sums([x.to_local() for x in leaves])):
        copies = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Partial):
                raise ValueError("global_norm takes leaves placed as the "
                                 "parameters (Shard / Replicate), not "
                                 "partial sums")
            if isinstance(p, Replicate):
                copies *= mesh.size(i)
        parts.append(sq / copies)
    local = torch.stack(parts).sum()
    total = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return total.full_tensor().sqrt()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_sharded(t) else t


@torch.no_grad()
def apply_updates(params: PyTree, grads: Union[PyTree, List[torch.Tensor]],
                  state: Dict[str, Any], cfg: OptConfig, *,
                  grad_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[PyTree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``grads`` is a tree shaped like
    ``params`` or the list of its leaves in ``tree_leaves`` order.
    ``grad_norm`` is the global norm the clipping uses when it was reduced
    outside (a pipeline rank holds one stage's leaves); by default it is
    :func:`global_norm` of ``grads``.  Returns (params, state,
    {"grad_norm", "lr"}) — the same parameter and moment tensors,
    updated."""
    flat_g = grads if isinstance(grads, list) else tree_leaves(grads)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(flat_g) if grad_norm is None else grad_norm
    clip = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
            if cfg.clip_norm > 0 else torch.ones((), device=gnorm.device))
    bc1 = 1.0 - torch.pow(cfg.b1, step.float())
    bc2 = 1.0 - torch.pow(cfg.b2, step.float())
    hyper = dict(lr=lr, clip=clip, bc1=bc1, bc2=bc2, b1=cfg.b1, b2=cfg.b2,
                 eps=cfg.eps, weight_decay=cfg.weight_decay)
    fused = total = 0
    for p, g, mu, nu in zip(tree_leaves(params), flat_g,
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        decay = p.dim() >= 2      # decoupled decay on >= 2-D weights only
        if is_sharded(p):               # elementwise: the local shards
            g = g.redistribute(p.device_mesh, p.placements)
            p, g, mu, nu = (_local(t) for t in (p, g, mu, nu))
        if _abstract(p):
            R.adamw_update_reference(p, g, mu, nu, decay=decay, **hyper)
        else:
            K.adamw_update(p, g, mu, nu, decay=decay, **hyper)
            fused += p.numel() if p.device.type == "cuda" else 0
        total += p.numel()
    tracer = get_tracer()
    if tracer.enabled:
        tracer.counter("adamw/fused_share", fused / max(total, 1))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
