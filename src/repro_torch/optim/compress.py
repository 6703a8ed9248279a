"""Gradient compression with error feedback (port of
``repro.optim.compress``) — the paper's §5 communication-minimization
lever.

Two compressors over gradient trees (or lists of leaves):

* ``int8``: blockwise symmetric int8 through the ``kernels/quant8``
  kernels (the CUDA kernels on the card, their plain versions on the CPU);
* ``topk``: magnitude top-k sparsification (k as a fraction).

Error feedback (EF-SGD): the compression residual is added back to the
next call's gradient.  :func:`compress_leaf` does one leaf, so a caller
that holds a large model (the local-SGD loop) can compress leaf by leaf
and never hold a second fp32 copy of the whole tree.

A leaf may be a DTensor (the local-SGD loop under a ``(data, model)``
mesh), and is then compressed to exactly what the whole tensor would
give:

* ``int8`` quantizes 256-element blocks of the leaf's row-major
  flattening.  Where the placement keeps those blocks whole on every
  rank (:func:`blocks_whole`), each rank runs the kernels on its own
  block (``to_local()``), moving nothing.  Otherwise the leaf is
  gathered whole, quantized on every rank alike and each rank keeps its
  block: at the smoke widths (``d_model`` 128 or 256 split in two or
  four) most leaves take this branch, at opt-1.3b's widths on 2 x 2 and
  1 x 4 none does.
* ``topk`` picks over the whole leaf, so the leaf is always gathered
  whole first: each rank selects what one device would, ties included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

import torch

from repro_torch.distributed.act_sharding import is_sharded, zeros_beside
from repro_torch.kernels.quant8 import ops as q8
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

PyTree = Any


@dataclass(frozen=True)
class CompressConfig:
    method: str = "none"          # none | int8 | topk
    topk_fraction: float = 0.01
    block: int = 256
    error_feedback: bool = True


def init_error(params: PyTree) -> PyTree:
    """fp32 zeros beside each leaf (placed as it, for a DTensor)."""
    return tree_map(lambda p: zeros_beside(p, torch.float32), params)


def blocks_whole(shape, placements, mesh_shape, block: int) -> bool:
    """Whether a rank's block of a tensor of ``shape`` placed by DTensor
    ``placements`` over a mesh of ``mesh_shape``, flattened, is a run of
    whole ``block``-element blocks of the global flattening: with ``d``
    the innermost dim split over more than one rank, its extent on a rank
    times the dims after it must be a multiple of ``block`` (each
    contiguous run of the rank's block then starts at a multiple of its
    own length)."""
    from torch.distributed.tensor import Shard
    ways: dict = {}
    for p, n in zip(placements, mesh_shape):
        if isinstance(p, Shard) and n > 1:
            ways[p.dim] = ways.get(p.dim, 1) * n
    if not ways:
        return True
    d = max(ways)
    if any(shape[k] % n for k, n in ways.items()):
        return False
    return (shape[d] // ways[d]) * math.prod(shape[d + 1:]) % block == 0


def _whole_then_local(g, fn):
    """``fn`` of the DTensor ``g`` gathered whole, each rank keeping its
    block of the result (``fn`` runs alike on every rank)."""
    from repro_torch.distributed.sharding import placed
    return placed(fn(g.full_tensor()), g.device_mesh, g.placements)


def _compress_leaf_int8(g: torch.Tensor, block: int) -> torch.Tensor:
    if is_sharded(g):
        if not blocks_whole(tuple(g.shape), g.placements,
                            tuple(g.device_mesh.shape), block):
            return _whole_then_local(
                g, lambda x: _compress_leaf_int8(x, block))
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            _compress_leaf_int8(g.to_local(), block), g.device_mesh,
            g.placements, run_check=False, shape=g.shape, stride=g.stride())
    q, s, shape = q8.quantize(g, block)
    return q8.dequantize(q, s, shape, block, torch.float32)


def _compress_leaf_topk(g: torch.Tensor, frac: float) -> torch.Tensor:
    if is_sharded(g):
        return _whole_then_local(g, lambda x: _compress_leaf_topk(x, frac))
    flat = g.reshape(-1).float()
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(flat.abs() >= thresh, flat,
                       torch.zeros((), device=flat.device)).reshape(g.shape)


@torch.no_grad()
def compress_leaf(g: torch.Tensor, e: Optional[torch.Tensor],
                  cfg: CompressConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One leaf: (the value as transmitted, in g's dtype; the new error,
    or None without error feedback).  ``cfg.method`` must not be
    ``"none"``."""
    gf = g.float()
    if cfg.error_feedback and e is not None:
        gf = gf + e
    if cfg.method == "int8":
        sent = _compress_leaf_int8(gf, cfg.block)
    elif cfg.method == "topk":
        sent = _compress_leaf_topk(gf, cfg.topk_fraction)
    else:
        raise ValueError(cfg.method)
    new_e = gf - sent if cfg.error_feedback else None
    return sent.to(g.dtype), new_e


def compress_grads(grads: Union[PyTree, List[torch.Tensor]],
                   error: Optional[Union[PyTree, List[torch.Tensor]]],
                   cfg: CompressConfig
                   ) -> Tuple[Any, Any]:
    """Returns (decompressed gradient as transmitted, new error feedback),
    each shaped like ``grads`` (a tree, or a list of leaves in
    ``tree_leaves`` order).  The error is None when ``error_feedback`` is
    off; a None ``error`` with feedback on starts from zero residuals."""
    if cfg.method == "none":
        return grads, error
    as_list = isinstance(grads, list)
    flat_g = grads if as_list else tree_leaves(grads)
    if error is None or not cfg.error_feedback:
        flat_e: List[Optional[torch.Tensor]] = [None] * len(flat_g)
    else:
        flat_e = error if isinstance(error, list) else tree_leaves(error)
    outs = [compress_leaf(g, e, cfg) for g, e in zip(flat_g, flat_e)]
    sent = [o[0] for o in outs]
    new_err = [o[1] for o in outs] if cfg.error_feedback else None
    if as_list:
        return sent, new_err
    return (tree_unflatten(grads, sent),
            None if new_err is None else tree_unflatten(grads, new_err))


def wire_bytes_count(n: int, cfg: Optional[CompressConfig], *,
                     dtype_bytes: int = 4) -> int:
    """Bytes transmitted for ``n`` gradient elements under this
    compressor: what the net layer's collective cost models consume."""
    if cfg is None or cfg.method == "none":
        return n * dtype_bytes
    if cfg.method == "int8":
        return n + 4 * (n // cfg.block + 1)
    if cfg.method == "topk":
        k = max(1, int(n * cfg.topk_fraction))
        return k * 8                # value + index
    raise ValueError(cfg.method)


def wire_bytes(grads: Union[PyTree, List[torch.Tensor]],
               cfg: CompressConfig) -> int:
    """Bytes actually transmitted per all-reduce under this compressor."""
    leaves = grads if isinstance(grads, list) else tree_leaves(grads)
    return sum(wire_bytes_count(g.numel(), cfg, dtype_bytes=g.element_size())
               for g in leaves)
