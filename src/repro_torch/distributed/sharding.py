"""Logical-axis sharding rules for the production mesh (port of
``repro.distributed.sharding``).

Every parameter carries logical axis names (``models.params.ParamSpec``);
a *rule table* maps each logical axis to candidate mesh axes.  Two rules
hold, as under GSPMD:

* a mesh axis appears at most once per spec (the first dim that takes it
  wins);
* a dim is sharded over a mesh axis only when the extent divides it,
  else it falls back to replication (recorded by
  :func:`sharding_report`).

The default strategy is FSDP over ``data`` (the embed dim of every
weight) with Megatron tensor parallelism over ``model`` (heads, mlp,
vocab, experts); ``pod`` is pure data parallelism.

Each function returns a *placement tuple* per leaf where the JAX package
returns a ``PartitionSpec``: one entry per tensor dim, ``None``, one
mesh-axis name, or a tuple of names, exactly as ``tuple(PartitionSpec)``
reads.  :func:`placements` turns a tuple into DTensor placements over a
``DeviceMesh``.  The functions read only the mesh's axis extents, so
they take a ``torch.distributed.DeviceMesh`` or an :class:`AbstractMesh`
(names and extents, no devices), on which the 16 x 16 and 2 x 16 x 16
production tables are computed on one CPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.bridge import flatten, keystr
from repro_torch.models import params as PM
from repro_torch.models.config import ModelConfig

PyTree = Any
Part = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Part, ...]

# logical axis -> candidate mesh axes (the first that fits wins)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": ("data",),          # FSDP / ZeRO-3 weight sharding
    "heads": ("model",),
    "kv_heads": ("model",),
    "head": (),
    "mlp": ("model",),
    "experts": ("model", "data"),   # expert parallelism; full EP when the
                                    # expert count covers model x data
    "mamba_inner": ("model",),
    "mamba_heads": ("model",),
    "state": (),
    "q_rank": ("model",),
    "kv_rank": ("model",),
    "layers": (),
    "batch": ("pod", "data"),
    "seq": (),
}

# tensor parallelism only (no FSDP): small models, serving
TP_ONLY_RULES = dict(DEFAULT_RULES, embed=())


class AbstractMesh:
    """A mesh's axis names and extents, with no devices (the port's
    ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape: Tuple[int, ...], names: Tuple[str, ...]):
        if len(shape) != len(names):
            raise ValueError(f"{len(shape)} extents for axes {names}")
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.axis_names = tuple(names)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh: Any) -> Mapping[str, int]:
    """Axis name -> extent of a ``DeviceMesh`` or of anything with a
    ``.shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return mesh.shape


def _part(chosen: List[str]) -> Part:
    """``PartitionSpec``'s canonical entry: None, a name, or names."""
    if not chosen:
        return None
    return chosen[0] if len(chosen) == 1 else tuple(chosen)


def spec_for_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  mesh: Any, rules: Dict[str, Tuple[str, ...]]) -> Spec:
    sizes = mesh_shape(mesh)
    used: set = set()
    parts: List[Part] = []
    for dim, name in zip(shape, axes):
        if name is None or name not in rules:
            parts.append(None)
            continue
        chosen: List[str] = []
        extent = 1
        for mx in rules[name]:
            if mx in used or mx not in sizes:
                continue
            if dim % (extent * sizes[mx]) == 0:
                chosen.append(mx)
                extent *= sizes[mx]
        used.update(chosen)
        parts.append(_part(chosen))
    return tuple(parts)


def _param_rules(cfg: ModelConfig, rules: Optional[Dict[str, Tuple[str, ...]]]
                 ) -> Dict[str, Tuple[str, ...]]:
    rules = dict(rules or DEFAULT_RULES)
    # expert weights follow the dispatch layout (models.moe): full EP
    # shards experts over model x data; otherwise experts shard over model
    # only and keep FSDP (embed over data) on the hidden dims
    if cfg.moe.enabled and cfg.moe.layout != "ep_full":
        rules["experts"] = ("model",)
    return rules


def param_shardings(cfg: ModelConfig, mesh: Any,
                    rules: Optional[Dict[str, Tuple[str, ...]]] = None
                    ) -> PyTree:
    """Placement tuples in the shape of ``models.params.model_spec``."""
    rules = _param_rules(cfg, rules)
    return PM.tree_map(lambda s: spec_for_axes(s.axes, s.shape, mesh, rules),
                       PM.model_spec(cfg))


def sharding_report(cfg: ModelConfig, mesh: Any,
                    rules: Optional[Dict[str, Tuple[str, ...]]] = None
                    ) -> Dict[str, Any]:
    """Bytes a device, and which large parameters fell back to
    replication.  Uses the rule table as given (the JAX package applies no
    MoE override here)."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    total = 0
    replicated = 0
    fallbacks: List[str] = []
    for path, s in flatten(PM.model_spec(cfg)):
        shard_factor = 1
        for p_ in spec_for_axes(s.axes, s.shape, mesh, rules):
            if p_ is None:
                continue
            for nm in ((p_,) if isinstance(p_, str) else p_):
                shard_factor *= sizes[nm]
        bytes_ = s.size() * (4 if s.init in PM.FP32_INITS else 2)
        total += bytes_ // shard_factor
        if shard_factor == 1 and s.size() > 1_000_000:
            replicated += bytes_
            fallbacks.append(path)
    return {"param_bytes_per_device": total,
            "replicated_large_param_bytes": replicated,
            "replicated_params": fallbacks}


def batch_spec(mesh: Any, batch_size: int) -> Spec:
    """The global batch over (pod, data) as divisibility allows."""
    sizes = mesh_shape(mesh)
    chosen: List[str] = []
    extent = 1
    for a in ("pod", "data"):
        if a in sizes and batch_size % (extent * sizes[a]) == 0:
            chosen.append(a)
            extent *= sizes[a]
    return (_part(chosen),)


def batch_shardings(mesh: Any, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, Spec]:
    """Placement tuples of a train/prefill batch dict; M-RoPE positions
    (3, B, S) shard their batch dim, dim 1."""
    out = {}
    for k, v in batch.items():
        if k == "positions" and v.dim() == 3:
            out[k] = (None,) + batch_spec(mesh, v.shape[1])
        else:
            out[k] = batch_spec(mesh, v.shape[0]) + (None,) * (v.dim() - 1)
    return out


def cache_shardings(cfg: ModelConfig, mesh: Any, cache: PyTree,
                    batch_size: int) -> PyTree:
    """Decode-cache placement tuples.

    batch >= the data extent: shard the batch dim.  batch == 1 (long
    context): shard the *sequence* dim of attention caches over ``data``
    too (context-parallel decode); SSM states shard over heads on
    ``model``, conv buffers over channels."""
    sizes = mesh_shape(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    dsize = math.prod(sizes[a] for a in daxes)
    shard_batch = batch_size % dsize == 0
    depths = {f"g{gi}": g.depth
              for gi, g in enumerate(PM.decoder_groups(cfg))}
    msize = sizes.get("model", 1)

    def leaf_spec(key: str, shape: Tuple[int, ...]) -> Spec:
        gkey = key.split("'")[1] if "'" in key else "g0"
        off = 1 if depths.get(gkey, 1) > 1 else 0     # stacked layers axis
        parts: List[Part] = [None] * len(shape)
        if shard_batch:
            parts[off] = _part(list(daxes))
        is_seq_cache = ("latent" in key or "k_rope" in key
                        or (len(shape) - off == 4
                            and ("'k'" in key or "'v'" in key)))
        if is_seq_cache:
            # over model always (flash-decoding's partial-softmax merge),
            # and over data too when the batch cannot take it
            T = shape[off + 1]
            seq_axes: List[str] = []
            extent = 1
            if "model" in sizes and T % msize == 0:
                seq_axes.append("model")
                extent = msize
            if not shard_batch and T % (extent * dsize) == 0:
                seq_axes += daxes
            if seq_axes:
                parts[off + 1] = _part(seq_axes)
        elif "state" in key and len(shape) - off == 4:       # SSM state
            if "model" in sizes and shape[off + 1] % msize == 0:
                parts[off + 1] = "model"
        elif "conv" in key and len(shape) - off == 3:
            if "model" in sizes and shape[off + 2] % msize == 0:
                parts[off + 2] = "model"
        return tuple(parts)

    def walk(node: PyTree, path: Tuple[str, ...]) -> PyTree:
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_spec(keystr(path), tuple(node.shape))
    return walk(cache, ())


def replicated(mesh: Any) -> Spec:
    return ()


# --------------------------------------------------------------------------- #
# DTensor placements
# --------------------------------------------------------------------------- #

def placements(spec: Spec, mesh) -> List[Any]:
    """DTensor placements of a placement tuple over a ``DeviceMesh``:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names,
    ``Replicate()`` on the others.  Several mesh dims on one tensor dim
    split it in mesh order, the first mesh dim major (``("pod",
    "data")`` shards pod-major, as JAX does); a tuple that names them
    against mesh order (the MoE rule's ``("model", "data")`` on a
    ``(data, model)`` mesh) gives each rank another block than JAX would,
    and the same values."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis: Dict[str, int] = {}
    for d, part in enumerate(spec):
        for name in ((part,) if isinstance(part, str) else (part or ())):
            by_axis[name] = d
    return [Shard(by_axis[n]) if n in by_axis else Replicate()
            for n in mesh.mesh_dim_names]


def local_index(shape: Tuple[int, ...], mesh, place,
                coord: Optional[Tuple[int, ...]] = None
                ) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` placed by ``place`` (DTensor
    placements) over ``mesh`` that the rank at ``coord`` (this rank's by
    default) holds, as an index: each ``Shard(d)`` cuts dim ``d`` as
    ``torch.chunk`` does, mesh dims in order (the first major)."""
    from torch.distributed.tensor import Shard
    if coord is None:
        coord = mesh.get_coordinate()
    bounds = [[0, n] for n in shape]
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            a, b = bounds[p.dim]
            step = -(-(b - a) // mesh.size(i))
            lo = min(a + coord[i] * step, b)
            bounds[p.dim] = [lo, min(lo + step, b)]
    return tuple(slice(a, b) for a, b in bounds)


def placed(full: torch.Tensor, mesh, place):
    """A DTensor of ``full`` (the same whole tensor on every rank) with
    DTensor placements ``place``: each rank keeps a copy of its own block
    (so that the full tensor's storage is not kept alive), with no
    collective."""
    from torch.distributed.tensor import DTensor
    local = full[local_index(tuple(full.shape), mesh, place)].clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=full.shape, stride=full.stride())


def shard_tensor(full: torch.Tensor, mesh, spec: Spec):
    """A DTensor of ``full`` (the same tensor on every rank) placed by
    ``spec``: each rank keeps its own block, with no collective."""
    return placed(full, mesh, placements(spec, mesh))


def shard_params(params: PyTree, cfg: ModelConfig, mesh,
                 rules: Optional[Dict[str, Tuple[str, ...]]] = None
                 ) -> PyTree:
    """Full parameter tensors (the same on every rank: bridged from the
    JAX package or drawn from one seed) -> DTensors placed by
    :func:`param_shardings`."""
    return shard_tree(params, param_shardings(cfg, mesh, rules), mesh)


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """:func:`shard_tensor` of every leaf of ``tree`` (the same full
    tensors on every rank) by the placement tuple at its path in
    ``specs``."""
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], mesh) for k in tree}
    return shard_tensor(tree.detach(), mesh, specs)


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, Any]:
    """A full batch (the same on every rank) -> DTensors placed by
    :func:`batch_shardings`."""
    specs = batch_shardings(mesh, batch)
    return {k: shard_tensor(v, mesh, specs[k]) for k, v in batch.items()}

