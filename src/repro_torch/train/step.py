"""The train step: forward + backward + AdamW, one closure per config
(port of ``repro.train.step``).

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``.  PyTorch runs it eagerly; the parameters
and moments are updated in place (the JAX step was pure and the trainer
donated its buffers), and every metric stays a device scalar.

Under an ambient ``(data, model)`` mesh (``act_sharding.use_mesh``) the
parameters and moments are DTensors placed by
``sharding.param_shardings`` and the batch by ``batch_shardings``; plain
tensors the model makes on the way (positions, masks, the rotary
frequencies) count as replicated, and each gradient comes back with its
parameter's placements before the update.

Each part of the step is a device phase of the global tracer
(``obs.trace``): ``fwd_bwd`` for each microbatch's forward and backward,
``accumulate`` for the fp32 gradient sums and their division,
``compress`` for the step's compressor and ``adamw`` for the update
(the global-norm clip included).  With the tracer off each is the
tracer's shared no-op span.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.act_sharding import is_sharded, mesh_ops, plain
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves
from repro_torch.obs.trace import get_tracer
from repro_torch.optim import adamw
from repro_torch.optim.compress import CompressConfig, compress_grads

PyTree = Any


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements
    (partial sums reduced, FSDP shards scattered); a plain one as is."""
    if is_sharded(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int
                        ) -> List[Dict[str, torch.Tensor]]:
    """m batches of B/m rows each, microbatch i holding rows [i B/m,
    (i + 1) B/m) of the global batch, as the JAX package's ``reshape(m,
    B/m)`` splits it.  M-RoPE ``positions`` (3, B, S) split on their
    batch axis, dim 1.  A batch-sharded DTensor is gathered whole first
    (one all-gather a leaf), split on every rank alike and each piece
    sharded again as the batch was: splitting each rank's own rows
    instead would mix rows of every microbatch, and the masked mean of
    the loss makes the grouping matter."""
    parts = {}
    for k, v in batch.items():
        dim = 1 if k == "positions" and v.dim() == 3 else 0
        if v.shape[dim] % m:
            raise ValueError(f"batch {k!r} of {v.shape[dim]} rows does not "
                             f"split into {m} microbatches")
        if is_sharded(v):
            from torch.distributed.tensor import Replicate
            mesh, place = v.device_mesh, v.placements
            whole = v.redistribute(mesh, [Replicate()] * mesh.ndim)
            parts[k] = [p.redistribute(mesh, place)
                        for p in whole.chunk(m, dim=dim)]
        else:
            parts[k] = v.chunk(m, dim=dim)
    return [{k: parts[k][i] for k in batch} for i in range(m)]


def _trainable(params: PyTree) -> List[torch.Tensor]:
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    return leaves


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, *,
                    remat: str = "none",
                    compress: Optional[CompressConfig] = None,
                    attn_impl: str = "kernel",
                    microbatches: int = 1) -> Callable:
    """Gradient accumulation over ``microbatches``: activation memory
    scales with B/microbatches while the optimizer update stays per global
    batch; the per-microbatch gradients are summed in fp32.  ``compress``
    passes the gradients through that compressor, without error state,
    before the update."""

    def loss_and_grads(leaves, params, batch):
        with mesh_ops():
            loss, metrics = M.forward_train(params, cfg, batch, remat=remat,
                                            attn_impl=attn_impl)
            grads = torch.autograd.grad(loss, leaves)
            grads = [placed_like(g, p) for g, p in zip(grads, leaves)]
            metrics = {k: plain(v.detach()) for k, v in metrics.items()}
        return plain(loss.detach()), metrics, grads

    def train_step(params: PyTree, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[PyTree, Dict[str, Any], Dict[str, torch.Tensor]]:
        leaves = _trainable(params)
        tr, dev = get_tracer(), leaves[0].device

        def phase(name: str, **attrs):
            return tr.device_phase(name, "train", device=dev,
                                   metric=f"train/{name}_s", **attrs)

        if microbatches > 1:
            gsum: Optional[List[torch.Tensor]] = None
            for i, mb in enumerate(_split_microbatches(batch, microbatches)):
                with phase("fwd_bwd", microbatch=i):
                    loss, _, g = loss_and_grads(leaves, params, mb)
                with phase("accumulate"):
                    if gsum is None:
                        gsum, lsum = [x.float() for x in g], loss
                    else:
                        for a, b in zip(gsum, g):
                            a.add_(b.float())
                        lsum = lsum + loss
                del g
            with phase("accumulate"):
                grads = [g.div_(microbatches) for g in gsum]
                loss = lsum / microbatches
            metrics: Dict[str, torch.Tensor] = {}
        else:
            with phase("fwd_bwd"):
                loss, metrics, grads = loss_and_grads(leaves, params, batch)
        if compress is not None and compress.method != "none":
            with phase("compress"):
                grads, _ = compress_grads(grads, None, compress)
        with phase("adamw"):
            params, opt_state, opt_metrics = adamw.apply_updates(
                params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, remat: str = "none",
                   attn_impl: str = "kernel") -> Callable:
    """The eval step takes the same ``remat``/``attn_impl`` knobs as the
    train step, so evaluation runs the configuration being trained."""

    @torch.no_grad()
    def eval_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        with mesh_ops():
            loss, metrics = M.forward_train(params, cfg, batch, remat=remat,
                                            attn_impl=attn_impl)
            return {k: plain(v) for k, v in dict(metrics, loss=loss).items()}

    return eval_step
