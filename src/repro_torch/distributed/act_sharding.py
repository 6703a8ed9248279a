"""Ambient-mesh activation sharding constraints (port of
``repro.distributed.act_sharding``).

``use_mesh(mesh)`` makes a ``torch.distributed.DeviceMesh`` the ambient
mesh of the code it wraps (the JAX package's ``compat.set_mesh``).
``constrain(x, part0, part1, ...)`` then redistributes a DTensor ``x`` so
that each listed dim is sharded over the mesh axes its part names, with
the JAX package's rules: axes the mesh lacks, axes already used by an
earlier dim, and axes whose extent does not divide the dim are dropped.
Model code annotates once and runs unchanged on one device (no mesh: the
tensor itself comes back) and on a ``(data, model)`` mesh.

**Difference from GSPMD.**  JAX leaves every dim a spec does not pin
UNCONSTRAINED, free for XLA to shard.  A DTensor has no such placement;
here a mesh dim that no listed part claims keeps the layout the input
already has (``Shard`` of another dim, or ``Replicate``), and
``REPLICATED`` forces a dim whole.  A listed dim takes exactly the axes
that survive: a mesh dim that sharded it and is not among them becomes
``Replicate``.  A pending partial sum (``Partial``, which a JAX array
never exposes) is reduced at a constraint: the residual stream leaves
every sublayer batch-sharded and whole over ``model``, as Megatron's
row-parallel products end in an all-reduce, and no later op has to
choose where to reduce it.

:func:`head_parallel` runs an attention function on each rank's own
heads and rows (``local_map``), with the ambient mesh cleared inside, so
the FA-2 kernels see plain local tensors.
:func:`vocab_parallel_embedding` looks tokens up in a vocab-sharded
table the Megatron way, each rank in its own rows of the vocab.
:func:`gathered` undoes a weight's FSDP sharding for one use (the weights
of a sublayer are gathered as it runs, and their gradients reduce-
scattered back), so that every product contracts whole rows and DTensor
never turns an activation into a partial sum over ``data``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Callable, Iterator, List, Tuple, Union

import torch

Part = Union[None, str, Tuple[str, ...]]

# canonical activation partitions
BATCH = ("pod", "data")
MODEL = ("model",)
# sentinel: force replication on this dim (None leaves it as it is)
REPLICATED = "~replicated~"

_MESH: contextvars.ContextVar = contextvars.ContextVar("ambient_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` (a ``DeviceMesh``, or None) the ambient mesh inside
    the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The ambient ``DeviceMesh``, or None."""
    return _MESH.get()


def axis_extent(name: str) -> int:
    """Extent of a mesh axis in the ambient mesh (1 with no mesh or when
    the axis is absent): model code picks sharding-dependent layouts
    without carrying the mesh around."""
    mesh = _MESH.get()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def is_sharded(x: Any) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *parts: Part) -> torch.Tensor:
    """Pin listed dims to mesh axes (see the module docstring); dims not
    listed, or listed as None, keep their layout, and partial sums are
    reduced.  Returns ``x`` itself with no ambient mesh, for a plain
    tensor, or when nothing changes."""
    mesh = _MESH.get()
    if mesh is None or not is_sharded(x):
        return x
    place = constrained_placements(x, mesh, *parts)
    if x.requires_grad and torch.is_grad_enabled():
        return _Pin.apply(x, tuple(place))
    if place == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, place)


class _Pin(torch.autograd.Function):
    """A constraint on a DTensor and on its gradient, as
    ``with_sharding_constraint`` transposes to a constraint on the
    cotangent: the backward puts the incoming gradient into the pinned
    placements first (so DTensor never picks the gradient's layout), then
    into the input's (a partial-sum input takes a replicated
    gradient)."""

    @staticmethod
    def forward(ctx, x, place):
        from torch.distributed.tensor import Replicate
        ctx.place = list(place)
        ctx.in_place = [Replicate() if p.is_partial() else p
                        for p in x.placements]
        if ctx.place == list(x.placements):
            return x.view_as(x)
        return x.redistribute(x.device_mesh, ctx.place)

    @staticmethod
    def backward(ctx, grad):
        for target in (ctx.place, ctx.in_place):
            if list(grad.placements) != target:
                grad = grad.redistribute(grad.device_mesh, target)
        return grad, None


def constrained_placements(x, mesh, *parts: Part) -> List[Any]:
    """The placements :func:`constrain` gives the DTensor ``x``."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    sizes = {n: mesh.size(i) for i, n in enumerate(names)}
    place: List[Any] = list(x.placements)
    used: set = set()
    for i, part in enumerate(parts):
        if part is None or i >= x.dim():
            continue
        if part == REPLICATED:
            keep: List[str] = []
        else:
            dim = x.shape[i]
            keep = []
            extent = 1
            for n in ((part,) if isinstance(part, str) else part):
                if n not in sizes or n in used:
                    continue
                if dim % (extent * sizes[n]) == 0:
                    keep.append(n)
                    extent *= sizes[n]
            if not keep:            # nothing fits: unconstrained, as JAX
                continue
        used.update(keep)
        for m, n in enumerate(names):
            if n in keep:
                place[m] = Shard(i)
            elif isinstance(place[m], Shard) and place[m].dim == i:
                place[m] = Replicate()
    return [Replicate() if p.is_partial() else p for p in place]


def gathered(w):
    """A weight with its FSDP shards gathered: the batch mesh dims
    (``BATCH``) replicate it, the others keep their placement (tensor
    parallelism).  Plain tensors, and trees of them, come back as they
    are."""
    if isinstance(w, dict):
        return {k: gathered(v) for k, v in w.items()}
    if not is_sharded(w):
        return w
    from torch.distributed.tensor import Replicate
    place = [Replicate() if n in BATCH else p
             for n, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    if place == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, place)


def head_parallel(fn: Callable, q, k, v, **kw: Any):
    """``fn(q, k, v, **kw)`` for (B, S, H, D) / (B, T, K, D) DTensors, run
    on each rank's local tensors: the batch over the mesh dims that shard
    q's rows, the heads over ``model`` where it divides both H and K,
    everything else whole.  Where the heads do not divide (K/V not
    expanded, H % model != 0), every ``model`` rank computes all of them:
    correct and redundant.  Gradients flow back through ``local_map``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    place: List[Any] = []
    for m, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(m)
        if q.placements[m] == Shard(0):
            place.append(Shard(0))
        elif name == "model" and H % size == 0 and K % size == 0:
            place.append(Shard(2))
        else:
            place.append(Replicate())
    q, k, v = (t.redistribute(mesh, place) for t in (q, k, v))
    local = local_map(_unmeshed(fn, kw), out_placements=place,
                      in_placements=(place, place, place),
                      device_mesh=mesh)
    return local(q, k, v)


def _unmeshed(fn: Callable, kw: dict) -> Callable:
    @functools.wraps(fn)
    def run(q, k, v):
        with use_mesh(None):
            return fn(q, k, v, **kw)
    return run



def vocab_parallel_embedding(tokens, table):
    """``table[tokens]`` for a DTensor table (V, d) whose vocab may be
    sharded: the embed dim is gathered, each rank looks up the tokens that
    fall in its rows of the vocab (zeros for the others), and the result
    is a partial sum over the mesh dims that shard the vocab; rows follow
    the tokens' batch sharding.  The table's gradient comes back as
    partial sums over the batch dims and shards of the vocab."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not is_sharded(tokens):               # the same ids on every rank
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = [p == Shard(0) for p in table.placements]
    rows = [tp == Shard(0) and not v
            for tp, v in zip(tokens.placements, vocab)]
    t_place = [Shard(0) if v else Replicate() for v in vocab]
    i_place = [Shard(0) if r else Replicate() for r in rows]
    out = [Partial() if v else Shard(0) if r else Replicate()
           for v, r in zip(vocab, rows)]
    grad = [Shard(0) if v else Partial() if r else Replicate()
            for v, r in zip(vocab, rows)]
    chunk = 0
    for m, v in enumerate(vocab):       # this rank's block, mesh-major
        if v:
            chunk = chunk * mesh.size(m) + mesh.get_local_rank(m)

    def lookup(tok, tab):
        n = tab.shape[0]
        local = tok.long() - chunk * n
        mine = (local >= 0) & (local < n)
        got = tab[local.clamp(0, n - 1)]
        return got * mine[..., None].to(got.dtype)

    table = table.redistribute(mesh, t_place)
    tokens = tokens.redistribute(mesh, i_place)
    return local_map(lookup, out_placements=out,
                     in_placements=(i_place, t_place),
                     in_grad_placements=(i_place, grad),
                     device_mesh=mesh)(tokens, table)
