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

The decode step's caches are sharded on their sequence dim (dim 1) over
``model``, and over ``data`` too when the batch cannot take it
(``sharding.cache_shardings``): :func:`write_row` writes a token's row
into the one block that holds its position, :func:`seq_block` gives a
rank its block and where it starts, and :func:`merge_softmax` joins the
ranks' partial softmax sums (flash-decoding's merge: a max, then two
sums).  Nothing gathers the cache.
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


def mesh_rank() -> Tuple[int, int]:
    """(rank, rank count) of the ambient mesh; (0, 1) with none."""
    mesh = _MESH.get()
    if mesh is None:
        return 0, 1
    return mesh.get_rank(), mesh.size()


def is_sharded(x: Any) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_ops():
    """Under an ambient mesh, plain tensors mixed with DTensors count as
    replicated (DTensor's ``implicit_replication``); else nothing."""
    if current_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def zeros_beside(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dtype`` on its device; placed as ``p``
    for a DTensor (each rank allocates its block only)."""
    if is_sharded(p):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def plain(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole as a plain tensor (a metric, the decode
    step's logits); a plain one as is."""
    return x.full_tensor() if is_sharded(x) else x


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


def scan_parallel(fn: Callable, x, dt, A, B, C):
    """``fn(x, dt, A, B, C)``, an SSD scan over x (b, s, h, p), dt (b, s,
    h), A (h,), B/C (b, s, g, n) DTensors, run on each rank's local
    tensors as :func:`head_parallel` runs attention: the batch over the
    mesh dims that shard x's rows, the heads over ``model`` where it
    divides them and the groups are one or divide too (each rank's heads
    then read their own groups), everything else whole.  The scan's
    chunk loop runs on plain tensors, and moves nothing."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    H, G = x.shape[2], B.shape[2]
    xp, ap, bp = [], [], []
    for m, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(m)
        if x.placements[m] == Shard(0):
            xp.append(Shard(0))
            ap.append(Replicate())
            bp.append(Shard(0))
        elif name == "model" and H % size == 0 and (G == 1
                                                     or G % size == 0):
            xp.append(Shard(2))
            ap.append(Shard(0))
            bp.append(Shard(2) if G > 1 else Replicate())
        else:
            xp.append(Replicate())
            ap.append(Replicate())
            bp.append(Replicate())
    args = [t.redistribute(mesh, p)
            for t, p in ((x, xp), (dt, xp), (A, ap), (B, bp), (C, bp))]
    ins = (xp, xp, ap, bp, bp)
    local = local_map(_unmeshed(fn, {}), out_placements=xp,
                      in_placements=ins,
                      in_grad_placements=_grad_places(ins, xp),
                      device_mesh=mesh)
    return local(*args)


def by_rows(fn: Callable, *xs, whole: Tuple = (), outs: int = 1):
    """``fn(*xs, *whole)`` on each rank's own rows (dim 0) of the
    DTensors ``xs``, the DTensors ``whole`` whole on every rank: the mesh
    dims that shard ``xs[0]``'s rows shard every row input and the
    ``outs`` outputs, the others hold them whole.  For per-row work whose
    DTensor strategy would make a tensor of the global shape (``gather``'s
    backward scatters into zeros of its input's global shape) or search
    long for one (a product over rows sharded on two mesh dims and heads
    on a third)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = xs[0].device_mesh
    place = _rows_place(xs[0])
    full = [Replicate()] * mesh.ndim
    args = tuple(x.redistribute(mesh, place) for x in xs) + tuple(
        w.redistribute(mesh, full) for w in whole)
    ins = (place,) * len(xs) + (full,) * len(whole)
    return local_map(_unmeshed(fn, {}),
                     out_placements=place if outs == 1 else (place,) * outs,
                     in_placements=ins,
                     in_grad_placements=_grad_places(ins, place),
                     device_mesh=mesh)(*args)


def _grad_places(ins: Tuple, split: List[Any]) -> Tuple:
    """The gradient placements of ``local_map`` inputs placed ``ins``
    when the ranks compute different parts on the mesh dims ``split``
    shards: an input whole on such a dim gets each rank's share of its
    gradient, a partial sum (``local_map`` would take it as whole)."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple([Partial() if p == Replicate() and q != Replicate() else p
                  for p, q in zip(place, split)] for place in ins)


def _unmeshed(fn: Callable, kw: dict) -> Callable:
    @functools.wraps(fn)
    def run(*args):
        with use_mesh(None):
            return fn(*args, **kw)
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


# --------------------------------------------------------------------------- #
# Sequence-sharded decode caches
# --------------------------------------------------------------------------- #

def _rows_place(x) -> List[Any]:
    """``x``'s sharding of its rows (dim 0), every other mesh dim
    replicated: how per-row tensors sit beside ``x``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if p == Shard(0) else Replicate()
            for p in x.placements]


def rows_like(x, cache) -> torch.Tensor:
    """``x``'s local rows placed as ``cache``'s batch rows, whole on
    every other mesh dim (a plain ``x`` is taken as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = cache.device_mesh
    if not is_sharded(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, _rows_place(cache)).to_local()


def seq_block(cache) -> Tuple[torch.Tensor, int]:
    """A cache DTensor's local block and the position its dim 1 starts
    at (several mesh dims on the sequence split it in mesh order, the
    first major)."""
    from torch.distributed.tensor import Shard
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    k = 0
    for m, p in enumerate(cache.placements):
        if p == Shard(1):
            k = k * mesh.size(m) + coord[m]
    local = cache.to_local()
    return local, k * local.shape[1]


def write_row(cache, row, index: int) -> None:
    """``cache[:, index] = row[:, 0]`` in place, ``row`` (B, 1, ...): on a
    DTensor cache only the rank whose block holds ``index`` writes, from
    its own rows of ``row`` (which every rank places alike: placing them
    may be a collective)."""
    if not is_sharded(cache):
        cache[:, index:index + 1] = row.to(cache.dtype)
        return
    mine = rows_like(row, cache)[:, 0]
    local, start = seq_block(cache)
    if start <= index < start + local.shape[1]:
        local[:, index - start] = mine.to(local.dtype)


def merge_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                  cache) -> Any:
    """Softmax-weighted sums over a sequence-sharded ``cache`` from each
    rank's partial ones: ``m`` its rows' running max (B, ...), ``l`` the
    sum of ``exp(s - m)``, ``o`` the ``exp(s - m)``-weighted values (B,
    ..., Dv), all local and fp32.  The max is reduced over the mesh dims
    that shard the sequence, each rank rescales, and the sums are
    reduced: returns ``o / l`` as a DTensor over the cache's rows."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = cache.device_mesh
    rows = _rows_place(cache)

    def reduced(t, op):
        place = [Partial(op) if p == Shard(1) else r
                 for p, r in zip(cache.placements, rows)]
        return DTensor.from_local(t, mesh, place, run_check=False) \
            .redistribute(mesh, rows).to_local()
    top = reduced(m, "max")
    scale = torch.exp(m - top)
    total = reduced(l * scale, "sum")
    out = reduced(o * scale[..., None], "sum") / total[..., None]
    return DTensor.from_local(out, mesh, rows, run_check=False)

