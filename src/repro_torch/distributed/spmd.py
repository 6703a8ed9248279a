"""The production mesh's rank-side calls: FSDP over ``data`` and Megatron
tensor parallelism over ``model`` (``distributed.sharding``'s rule
tables), each rank one process of :func:`repro_torch.distributed.runtime.
spawn`.

The weights are the full tensors every rank holds (bridged from the JAX
package, or ``init_params(seed)``, the same on every rank), each rank
keeping its own block (``sharding.shard_params``); the batch likewise
(``shard_batch``): the trainer's placement under a mesh
(``train.trainer._placed`` and ``_to_device``).  The model code then
runs on DTensors under the ambient mesh (``act_sharding.use_mesh``):
DTensor inserts the weight all-gathers, the reductions of partial sums
and the vocab gather of the loss; the FA-2 kernels run on each rank's own rows and heads.
:func:`evaluate` returns the loss and the full gradient tree;
:func:`step` runs one train step and counts the rank's collectives
(``runtime.Collectives``); :func:`train` runs the trainer
(``train.trainer.train``) and :func:`local_sgd` the local-SGD loop
(``train.local_sgd.train_local_sgd``) under the mesh, the single
process's own loops; :func:`generate` decodes greedily through a cache
sharded by ``sharding.cache_shardings``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import runtime, sharding
from repro_torch.distributed.act_sharding import mesh_ops, plain, use_mesh
from repro_torch.models import model as M
from repro_torch.models import params as PM
from repro_torch.models.config import ModelConfig
from repro_torch.train import step as TS
from repro_torch.train import trainer

PyTree = Any


def _weights(cfg: ModelConfig, params: Optional[PyTree], seed: int,
             dev: torch.device) -> PyTree:
    """The full tree on ``dev``: ``params`` or ``init_params(seed)``."""
    if params is None:
        return PM.init_params(cfg, device=dev, seed=seed)
    return PM.tree_map(lambda t: torch.as_tensor(t).to(dev), params)


def evaluate(mesh, cfg: ModelConfig, batch: Dict[str, Any], *,
             params: Optional[PyTree] = None, seed: int = 0,
             grads: bool = False, device: DeviceLike = None
             ) -> Dict[str, Any]:
    """The loss of ``batch`` (numpy or tensors, the whole batch) under
    ``params`` (the full tree; ``init_params(seed)`` on the rank's device
    by default), as {"loss": float} on every rank; with ``grads`` each
    rank's dict also holds ``shards``, its own blocks of the gradient
    tree on the CPU, placed as the parameters, and its ``coordinate``
    (:func:`join_shards` joins the ranks' blocks with no collective)."""
    dev = resolve_device(device)
    with use_mesh(mesh):
        sp = trainer._placed(cfg, _weights(cfg, params, seed, dev))
        b = trainer._to_device(batch, dev)
    leaves = TS._trainable(sp) if grads else []
    with use_mesh(mesh), mesh_ops():
        with torch.set_grad_enabled(grads):
            loss, _ = M.forward_train(sp, cfg, b)
        out: Dict[str, Any] = {"loss": float(plain(loss.detach()))}
        if grads:
            g = torch.autograd.grad(loss, leaves)
            g = [TS.placed_like(a, p).to_local().cpu()
                 for a, p in zip(g, leaves)]
            out["shards"] = PM.tree_unflatten(sp, g)
            out["coordinate"] = list(mesh.get_coordinate())
    return out


def join_shards(values: List[Dict[str, Any]], cfg: ModelConfig,
                shape, names) -> PyTree:
    """The full gradient tree (CPU tensors) from every rank's
    :func:`evaluate` blocks on a mesh of ``shape`` named ``names``: each
    leaf's blocks put back where ``sharding.param_shardings`` placed them
    (several mesh axes on one dim in mesh order, as
    ``sharding.shard_tensor`` cut them)."""
    mesh = sharding.AbstractMesh(tuple(shape), tuple(names))
    specs = sharding.param_shardings(cfg, mesh)
    sizes = dict(zip(names, shape))

    def join(spec, blocks):
        full_shape = list(blocks[0][1].shape)
        axes = {}
        for d, part in enumerate(spec):
            for n in ((part,) if isinstance(part, str) else (part or ())):
                axes.setdefault(d, []).append(n)
        for d, ns in axes.items():
            for n in ns:
                full_shape[d] *= sizes[n]
        full = torch.empty(full_shape, dtype=blocks[0][1].dtype)
        for coord, block in blocks:
            at = dict(zip(names, coord))
            index = [slice(None)] * len(full_shape)
            for d in axes:
                k = 0
                for n in names:                 # mesh order, major first
                    if n in axes[d]:
                        k = k * sizes[n] + at[n]
                step = block.shape[d]
                index[d] = slice(k * step, (k + 1) * step)
            full[tuple(index)] = block
        return full

    def walk(spec, trees):
        if isinstance(spec, dict):
            return {k: walk(spec[k], [(c, t[k]) for c, t in trees])
                    for k in spec}
        return join(spec, trees)
    return walk(specs, [(v["coordinate"], v["shards"]) for v in values])


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #

def step(mesh, cfg: ModelConfig, opt_cfg, batch: Dict[str, Any], *,
         params: Optional[PyTree] = None, seed: int = 0,
         microbatches: int = 1, remat: str = "none",
         attn_impl: str = "kernel", device: DeviceLike = None
         ) -> Dict[str, Any]:
    """One AdamW step of ``make_train_step`` on ``batch`` (the whole
    batch) from ``params`` (``init_params(seed)`` by default): {"loss",
    "grad_norm", "shards" (the rank's blocks of the updated parameters on
    the CPU, for :func:`join_shards`), "coordinate", "collectives" (the
    step's collectives on this rank inside :func:`runtime.spawn`, the
    record ``runtime.CollectiveCount.totals`` makes, else None)}."""
    from repro_torch.optim import adamw
    dev = resolve_device(device)
    with use_mesh(mesh):
        sp = trainer._placed(cfg, _weights(cfg, params, seed, dev))
        b = trainer._to_device(batch, dev)
    opt = adamw.init_opt_state(sp, opt_cfg)
    step_fn = TS.make_train_step(cfg, opt_cfg, remat=remat,
                                 attn_impl=attn_impl,
                                 microbatches=microbatches)
    coll = runtime.collectives()
    if coll is not None:
        coll.reset()
    with use_mesh(mesh):
        sp, opt, mets = step_fn(sp, opt, b)
    return {"loss": float(mets["loss"]),
            "grad_norm": float(mets["grad_norm"]),
            "shards": PM.tree_map(lambda p: p.to_local().detach().cpu(), sp),
            "coordinate": list(mesh.get_coordinate()),
            "collectives": None if coll is None else coll.totals()}


@dataclass
class MeshRun:
    """One rank's trainer run (:func:`train`): the step losses and
    pre-clip grad norms (the same on every rank), host ms a step (each
    ending in a synchronisation); inside :func:`runtime.spawn` its
    collectives a step by kind (ms, calls, bytes sent in;
    ``runtime.Collectives``) and the rest of the step, ``busy_ms``; its
    peak device memory (bytes, the card only); the trainer's
    ``TrainerResult``."""
    coordinate: List[int]
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    wall_ms: List[float] = field(default_factory=list)
    busy_ms: List[float] = field(default_factory=list)
    collective_ms: List[Dict[str, float]] = field(default_factory=list)
    collective_calls: List[Dict[str, int]] = field(default_factory=list)
    collective_bytes: List[Dict[str, int]] = field(default_factory=list)
    peak_bytes: int = 0
    result: Any = None
    records: Any = None          # what the caller attaches (the launcher's)


def _peak_start(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def train(mesh, cfg: ModelConfig, tc, opt_cfg=None, *, monitor=None,
          metrics=None, health=None, params: Optional[PyTree] = None,
          device: DeviceLike = None) -> MeshRun:
    """``train.trainer.train(cfg, tc, ...)`` on the mesh (its rank-side
    call), from ``params`` or ``init_params(tc.seed)``: the single-process
    trainer's weights and batches for the same seed, every rank drawing
    the same batches and keeping its rows.  Each step is timed and its
    collectives counted (``MeshRun``)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    run = MeshRun(coordinate=list(mesh.get_coordinate()))
    _peak_start(dev)
    coll = runtime.collectives()

    def timed(step_fn):
        def step_timed(params, opt_state, batch):
            if on_card:
                torch.cuda.synchronize(dev)
            if coll is not None:
                coll.reset()
            t0 = time.perf_counter()
            params, opt_state, mets = step_fn(params, opt_state, batch)
            if on_card:
                torch.cuda.synchronize(dev)
            wall = 1e3 * (time.perf_counter() - t0)
            run.wall_ms.append(wall)
            if coll is not None:
                run.collective_ms.append(dict(coll.ms))
                run.collective_calls.append(dict(coll.calls))
                run.collective_bytes.append(dict(coll.bytes))
                run.busy_ms.append(wall - sum(
                    v for k, v in coll.ms.items() if k != "host_copy"))
            run.losses.append(float(mets["loss"]))
            run.grad_norms.append(float(mets["grad_norm"]))
            return params, opt_state, mets
        return step_timed

    with use_mesh(mesh):
        run.result = trainer.train(cfg, tc, opt_cfg, monitor, metrics,
                                   health, params=params, device=dev,
                                   step_hook=timed)
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    return run


@dataclass
class MeshLocalSGD:
    """One rank's local-SGD run (:func:`local_sgd`): the
    ``LocalSGDResult`` (the same losses and counts on every rank; its
    ``outer_state`` moved to ``state``), the rank's blocks of the final
    ``{"params", "outer_m"}`` on the CPU (:func:`join_state` joins them),
    host seconds of the whole loop, its collectives over the run by kind
    (ms, calls, bytes sent in) and its peak device memory (bytes, the
    card only)."""
    coordinate: List[int]
    result: Any
    state: Dict[str, PyTree]
    wall_s: float = 0.0
    collective_ms: Dict[str, float] = field(default_factory=dict)
    collective_calls: Dict[str, int] = field(default_factory=dict)
    collective_bytes: Dict[str, int] = field(default_factory=dict)
    peak_bytes: int = 0
    records: Any = None          # what the caller attaches (the launcher's)


def local_sgd(mesh, cfg: ModelConfig, tc, ls, opt_cfg=None, *,
              params: Optional[PyTree] = None, device: DeviceLike = None,
              **kw: Any) -> MeshLocalSGD:
    """``train.local_sgd.train_local_sgd(cfg, tc, ls, opt_cfg, **kw)`` on
    the mesh (its rank-side call; ``kw`` its topology, placement, monitor,
    metrics, fault plan and health), from ``params`` or
    ``init_params(tc.seed)``."""
    from repro_torch.train.local_sgd import train_local_sgd
    dev = resolve_device(device)
    _peak_start(dev)
    coll = runtime.collectives()
    if coll is not None:
        coll.reset()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        res = train_local_sgd(cfg, tc, ls, opt_cfg, params=params,
                              device=dev, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = MeshLocalSGD(
        coordinate=list(mesh.get_coordinate()), result=res,
        state=PM.tree_map(lambda p: p.to_local().detach().cpu(),
                          res.outer_state),
        wall_s=time.perf_counter() - t0)
    res.outer_state = None
    if coll is not None:
        out.collective_ms = {k: v for k, v in coll.ms.items()}
        out.collective_calls = dict(coll.calls)
        out.collective_bytes = dict(coll.bytes)
    if dev.type == "cuda":
        out.peak_bytes = torch.cuda.max_memory_allocated(dev)
    return out


def join_state(runs: List[MeshLocalSGD], cfg: ModelConfig, shape, names
               ) -> Dict[str, PyTree]:
    """The full final ``{"params", "outer_m"}`` (CPU tensors) from every
    rank's :func:`local_sgd` blocks."""
    return {k: join_shards([{"coordinate": r.coordinate,
                             "shards": r.state[k]} for r in runs],
                           cfg, shape, names)
            for k in ("params", "outer_m")}


def summary(run) -> str:
    """One line of a rank's run.  A trainer run (:class:`MeshRun`):
    medians over the steps after the first of ms a step, busy ms and
    collective ms by kind.  A local-SGD run (:class:`MeshLocalSGD`): ms a
    round by phase (device clock) and collective ms a round by kind.
    Then the peak GB."""
    def med(xs):
        xs = sorted(xs[1:] or xs)
        return xs[len(xs) // 2] if xs else float("nan")
    if isinstance(run, MeshLocalSGD):
        n = max(run.result.outer_updates, 1)
        line = ", ".join(f"{k} {1e3 * v / n:.1f}"
                         for k, v in run.result.phase_s.items())
        line = f"{1e3 * run.wall_s / n:.1f} ms a round ({line})"
        if run.collective_ms:
            line += ", collectives " + ", ".join(
                f"{k} {v / n:.1f}" for k, v in sorted(
                    run.collective_ms.items())) + " ms"
    else:
        line = f"{med(run.wall_ms):.1f} ms a step"
        if run.collective_ms:
            kinds = sorted({k for d in run.collective_ms for k in d})
            line += f", busy {med(run.busy_ms):.1f} ms, " + ", ".join(
                f"{k} {med([d.get(k, 0.0) for d in run.collective_ms]):.1f}"
                for k in kinds) + " ms"
    if run.peak_bytes:
        line += f", peak {run.peak_bytes / 1e9:.2f} GB"
    return line


# --------------------------------------------------------------------------- #
# Decoding
# --------------------------------------------------------------------------- #

def generate(mesh, cfg: ModelConfig, prompt: Any, max_new: int, *,
             params: Optional[PyTree] = None, seed: int = 0,
             cache_len: Optional[int] = None, enc: Any = None,
             device: DeviceLike = None) -> Dict[str, Any]:
    """``serve.step.greedy_generate`` of ``prompt`` (B, S) on the mesh,
    every step ``decode_step`` on DTensors: the dense cache (K/V in the
    config's compute dtype) placed by ``sharding.cache_shardings``,
    batch-sharded and sequence-sharded over ``model``, and over ``data``
    too when the batch does not divide; ``enc`` (B, T, d) warms the
    cross-attention caches.  Returns {"ids": (B, S + max_new) numpy,
    "logits": each step's (B, vocab) logits as numpy}."""
    from repro_torch.serve.step import greedy_generate
    dev = resolve_device(device)
    with use_mesh(mesh):
        sp = trainer._placed(cfg, _weights(cfg, params, seed, dev))
    prompt = torch.as_tensor(np.asarray(prompt)).to(dev)
    B, S = prompt.shape
    full = M.init_cache(cfg, B, cache_len or (S + max_new),
                        getattr(torch, cfg.compute_dtype), device=dev)
    cache = sharding.shard_tree(
        full, sharding.cache_shardings(cfg, mesh, full, B), mesh)
    del full
    if enc is not None:
        enc = torch.as_tensor(np.asarray(enc)).to(dev)
    logits: List[torch.Tensor] = []
    with use_mesh(mesh):
        ids = greedy_generate(sp, cfg, prompt, max_new, enc=enc, cache=cache,
                              logits=logits)
    return {"ids": ids.cpu().numpy(),
            "logits": [x.float().cpu().numpy() for x in logits]}
