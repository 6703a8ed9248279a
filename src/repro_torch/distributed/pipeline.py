"""DT-FM execution path: GPipe pipeline parallelism with a ``data`` axis,
one process per ``(data, stage)`` device, over ``torch.distributed``
(port of ``repro.distributed.pipeline``).

The paper's Table 2 method [98] combines data parallelism with pipeline
parallelism across edge devices.  This module runs it over a
``DeviceMesh`` named ``("data", "stage")``
(:func:`repro_torch.launch.mesh.make_edge_mesh`; the ranks come from
:func:`repro_torch.distributed.runtime.spawn`):

* the decoder layer stack (uniform ``(attn, mlp)`` groups: the OPT family
  the paper trains) is split into S contiguous stages; the rank of stage
  ``s`` holds only its layers ``boundaries[s]:boundaries[s+1]``,
* stage boundaries may be **non-uniform** (a
  :class:`~repro_torch.core.placement.PlacementSpec` balancing
  heterogeneous devices).  A short stage runs its real layer count as its
  loop bound; the JAX package pads every stage to the longest and masks
  the padded scan steps (``jnp.where(m, run(h), h)``, the identity, whose
  zero parameters get zero gradients), which computes the same function,
* each rank runs a plain loop over the microbatches: stage 0 embeds
  microbatch ``m`` (tokens plus learned positions), the other stages
  ``recv`` it from ``stage - 1``; the rank runs its layers and ``send``\\ s
  the result to ``stage + 1``.  The GPipe schedule (MB + S - 1 ticks,
  bubble (S - 1) / (MB + S - 1)) comes out of that loop: no global tick
  loop is needed.  The send/recv graph is a chain, forward and then
  reversed, so it has no cycle,
* the last stage applies the final norm, the LM head and the cross-entropy
  over its whole batch, as the JAX package does outside its pipelined
  region,
* the backward pipeline is run by each rank itself: it keeps every
  microbatch's graph, ``recv``\\ s the output gradient from ``stage + 1``,
  runs ``torch.autograd.backward`` and ``send``\\ s the input gradient to
  ``stage - 1`` (in the JAX package autodiff through ``ppermute`` derives
  it).

**The data axis is a placement difference, not a semantic one.**  The
JAX package replicates the pipelined region over ``data``; here data rank
``d`` takes rows ``[d B/D, (d+1) B/D)`` of the batch.  The loss and every
gradient still equal the full batch's: each last stage scales its masked
mean by its share of the batch's valid labels (a sum over labels and a
count, not a mean of means), the staged gradients are summed over the
``data`` group, and the replicated ``rest`` (embeddings, final norm, the
tied head) is summed over every rank, since its gradient comes from stage
0 (the embedding) and from the last stage (the head).  Every rank draws
the same batch from the same seed (:mod:`repro_torch.data.pipeline`), so
nothing is broadcast.

**Transport** is the process group's backend, which the caller chose
(``runtime.spawn(transport=...)``): gloo, which carries host tensors, so
on the card every activation, gradient and reduction is staged through
host memory with an explicit ``.cpu()`` before the send and
``.to(device)`` after the receive, compute staying on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import make_batch_fn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.stages import stage_counts, stage_slices
from repro_torch.models import params as PM
from repro_torch.models.blocks import _sublayer_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norm
from repro_torch.models.model import (_embed_with_positions, cross_entropy,
                                      lm_logits)
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw

PyTree = Any

# stage boundaries: an int S (uniform split), an explicit [0,...,L] boundary
# list, or anything with a ``.boundaries`` attribute (a PlacementSpec)
Boundaries = Union[int, Sequence[int]]

SUBLAYERS = ("attn", "mlp")


def resolve_boundaries(cfg: ModelConfig, stages: Boundaries) -> List[int]:
    """Normalize to an explicit boundary list [0, ..., num_layers]."""
    if hasattr(stages, "boundaries"):            # PlacementSpec duck-type
        stages = stages.boundaries
    L = cfg.num_layers
    if isinstance(stages, int):
        if L % stages != 0:
            raise ValueError(
                f"{L} layers do not split uniformly into {stages} stages; "
                "pass explicit boundaries (e.g. a PlacementSpec's)")
        step = L // stages
        return list(range(0, L + 1, step))
    bounds = list(stages)
    if bounds[0] != 0 or bounds[-1] != L or bounds != sorted(bounds) \
            or len(set(bounds)) != len(bounds):
        raise ValueError(
            f"boundaries {bounds} must strictly ascend from 0 to {L}")
    return bounds


_stage_counts = stage_counts          # internal alias (pre-export name)


def stage_layer_mask(cfg: ModelConfig, stages: Boundaries) -> torch.Tensor:
    """(S, Lmax) bool: True where a padded stage slot holds a real layer."""
    counts = _stage_counts(resolve_boundaries(cfg, stages))
    lmax = max(counts)
    return torch.arange(lmax)[None, :] < torch.tensor(counts)[:, None]


def _check_family(cfg: ModelConfig) -> None:
    groups = PM.decoder_groups(cfg)
    if len(groups) != 1 or groups[0].sublayers != SUBLAYERS:
        raise ValueError(
            f"the pipeline runs uniform dense decoders (the OPT family): "
            f"{cfg.name} has decoder groups "
            f"{[g.sublayers for g in groups]}")


def stack_for_stages(cfg: ModelConfig, params: PyTree, stages: Boundaries
                     ) -> PyTree:
    """Reshape decoder stack leaves (L, ...) -> (S, Lmax, ...).

    Uniform splits are a pure reshape; non-uniform boundaries slice each
    stage's layers and zero-pad to the longest stage.  Row ``s`` without
    its padding, ``[s, :counts[s]]``, is what the rank of stage ``s``
    holds and runs.
    """
    _check_family(cfg)
    bounds = resolve_boundaries(cfg, stages)
    counts = _stage_counts(bounds)
    S, lmax = len(counts), max(counts)
    g0 = params["decoder"]["g0"]
    if cfg.num_layers == S * lmax:    # uniform: pure reshape
        return tree_map(lambda l: l.reshape((S, lmax) + l.shape[1:]), g0)

    def slice_pad(leaf):
        out = leaf.new_zeros((S, lmax) + leaf.shape[1:])
        for i, (a, b) in enumerate(stage_slices(bounds)):
            out[i, :b - a] = leaf[a:b]
        return out
    return tree_map(slice_pad, g0)


def unstack_stages(cfg: ModelConfig, staged: PyTree,
                   stages: Optional[Boundaries] = None) -> PyTree:
    """Invert :func:`stack_for_stages` (drops non-uniform padding)."""
    L = cfg.num_layers
    if stages is None:                # legacy uniform round-trip
        return tree_map(lambda l: l.reshape((L,) + l.shape[2:]), staged)
    counts = _stage_counts(resolve_boundaries(cfg, stages))
    return tree_map(lambda l: torch.cat(
        [l[i, :c] for i, c in enumerate(counts)], dim=0), staged)


def _stage_forward(cfg: ModelConfig, stage_params: PyTree, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Run this rank's layers.  ``stage_params`` leaves: (count, ...), the
    stage's real layers; each leaf is unbound once, so the backward stacks
    the per-layer gradients in one op.  Attention runs the FA-2 kernels
    (their plain versions on the CPU); the JAX stage hard-codes its
    "chunked" attention, which computes the same function."""
    ctx = {"positions": positions, "causal": True, "attn_impl": "kernel"}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = tree_map(lambda a: a.unbind(0), stage_params)
    count = tree_leaves(stage_params)[0].shape[0]
    for i in range(count):
        unit = tree_map(lambda t: t[i], layers)
        for j, kind in enumerate(SUBLAYERS):
            x, _ = _sublayer_train(kind, unit[f"s{j}_{kind}"], x, aux, cfg,
                                   ctx)
    return x


# --------------------------------------------------------------------------- #
# The mesh, the links between ranks and what they cost
# --------------------------------------------------------------------------- #

def _mesh_extent(mesh, axis: str) -> int:
    """The size of ``mesh``'s named ``axis``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


@dataclass
class PipelineStats:
    """Host seconds this rank spent outside its own compute, accumulated
    until :meth:`reset`: ``copy_s`` staging ``copies`` tensors between the
    card and host memory (gloo on the card only), ``wait_s`` blocked in
    send and receive (the peers' compute and the schedule's bubble
    included), ``allreduce_s`` in the gradient and loss reductions (their
    staging included)."""
    copy_s: float = 0.0
    copies: int = 0
    wait_s: float = 0.0
    allreduce_s: float = 0.0

    def reset(self) -> None:
        self.copy_s, self.copies, self.wait_s, self.allreduce_s = \
            0.0, 0, 0.0, 0.0


class _Links:
    """Point-to-point and reduction calls of one rank over gloo, staged
    through host memory when the tensors live on the card."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.stats = PipelineStats()

    def rank_of(self, data: int, stage: int) -> int:
        return int(self.mesh.mesh[data, stage])

    @staticmethod
    def _via_host(device: torch.device) -> bool:
        return device.type == "cuda"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        torch.cuda.synchronize(t.device)   # the copy would wait for it anyway
        t0 = time.perf_counter()
        out = t.cpu()
        self.stats.copy_s += time.perf_counter() - t0
        self.stats.copies += 1
        return out

    def _to_device(self, t: torch.Tensor, device: torch.device
                   ) -> torch.Tensor:
        t0 = time.perf_counter()
        out = t.to(device)
        torch.cuda.synchronize(device)
        self.stats.copy_s += time.perf_counter() - t0
        self.stats.copies += 1
        return out

    def isend(self, t: torch.Tensor, dst: int):
        """Start sending ``t``; returns a handle for :meth:`wait`, which
        keeps the (staged) buffer alive until the send completes."""
        buf = t.detach().contiguous()
        if self._via_host(buf.device):
            buf = self._to_host(buf)
        return dist.isend(buf, dst=dst), buf

    def recv(self, shape, dtype: torch.dtype, src: int,
             device: torch.device) -> torch.Tensor:
        via_host = self._via_host(device)
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if via_host else device)
        t0 = time.perf_counter()
        dist.recv(buf, src=src)
        self.stats.wait_s += time.perf_counter() - t0
        return self._to_device(buf, device) if via_host else buf

    def wait(self, handles: List) -> None:
        t0 = time.perf_counter()
        for work, _ in handles:
            work.wait()
        self.stats.wait_s += time.perf_counter() - t0
        handles.clear()

    def all_reduce(self, tensors: Sequence[torch.Tensor], group=None
                   ) -> List[torch.Tensor]:
        """Sums of ``tensors`` over ``group`` (every rank by default):
        one reduction per dtype, over the tensors flattened together."""
        device = tensors[0].device
        via_host = self._via_host(device)
        if device.type == "cuda":        # time the reduction, not the
            torch.cuda.synchronize(device)   # compute queued before it
        t0 = time.perf_counter()
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            buf = flat.cpu() if via_host else flat
            dist.all_reduce(buf, group=group)
            if via_host:
                flat = buf.to(device)
            at = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[at:at + n].view(tensors[i].shape)
                at += n
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.stats.allreduce_s += time.perf_counter() - t0
        return out


# --------------------------------------------------------------------------- #
# The pipelined loss
# --------------------------------------------------------------------------- #

class PipelineLoss:
    """``loss(rest, staged, batch)`` with the stage axis pipelined.

    ``rest``: the replicated parameters (the tree without ``decoder``);
    ``staged``: this rank's decoder layers, leaves (count, ...); ``batch``:
    the whole batch, ``tokens`` and ``labels`` (B, T), the same on every
    rank.  Calling it runs the forward pipeline and returns the batch's
    loss on every rank; :meth:`value_and_grad` adds the backward pipeline
    and the reductions.  ``stats`` accumulates the rank's communication
    time."""

    def __init__(self, cfg: ModelConfig, mesh, *, num_microbatches: int,
                 boundaries: Optional[Boundaries] = None):
        _check_family(cfg)
        S = _mesh_extent(mesh, "stage")
        bounds = resolve_boundaries(cfg, boundaries if boundaries is not None
                                    else S)
        if len(bounds) - 1 != S:
            raise ValueError(
                f"boundaries {bounds} define {len(bounds) - 1} stages but "
                f"the mesh 'stage' axis has {S}")
        self.cfg, self.mesh, self.bounds = cfg, mesh, bounds
        self.S, self.D = S, _mesh_extent(mesh, "data")
        self.MB = num_microbatches
        self.data, self.stage = mesh.get_coordinate()
        self.links = _Links(mesh)

    @property
    def layers(self) -> Tuple[int, int]:
        """This rank's [start, stop) decoder layers."""
        return stage_slices(self.bounds)[self.stage]

    @property
    def stats(self) -> PipelineStats:
        return self.links.stats

    def _peer(self, step: int) -> int:
        """The global rank of the stage ``step`` away in this data row."""
        return self.links.rank_of(self.data, self.stage + step)

    def all_reduce(self, tensors: Sequence[torch.Tensor],
                   axis: Optional[str] = None) -> List[torch.Tensor]:
        """Sums over the mesh ``axis`` ("data" or "stage"), over every
        rank when ``None``."""
        group = None if axis is None else self.mesh.get_group(axis)
        return self.links.all_reduce(tensors, group)

    def _rows(self, batch: Dict[str, torch.Tensor]):
        """This data rank's rows: its token microbatches, its labels and
        the batch's count of valid labels."""
        tokens, labels = batch["tokens"], batch["labels"]
        B = tokens.shape[0]
        if B % (self.D * self.MB):
            raise ValueError(
                f"a batch of {B} rows does not split into {self.D} data "
                f"ranks x {self.MB} microbatches")
        n = B // self.D
        rows = slice(self.data * n, (self.data + 1) * n)
        return (tokens[rows].chunk(self.MB), labels[rows],
                (labels >= 0).sum().float())

    def _forward(self, rest: PyTree, staged: PyTree,
                 batch: Dict[str, torch.Tensor]):
        """The forward pipeline: (inputs, outputs, this rank's share of
        the loss), the last stage's share nonzero.  Stage 0's inputs are
        the embeddings; the others' the received activations, as leaves
        that take a gradient when grad mode is on."""
        cfg, s, S = self.cfg, self.stage, self.S
        dev = tree_leaves(rest)[0].device
        mbs, labels, n_total = self._rows(batch)
        mbsz, T = mbs[0].shape
        dtype = getattr(torch, cfg.compute_dtype)
        positions = torch.arange(T, dtype=torch.int32, device=dev)[None] \
            .expand(mbsz, T)
        ins, outs, sends = [], [], []
        for tok in mbs:
            if s == 0:
                x = _embed_with_positions(rest, cfg, {"tokens": tok})
            else:
                x = self.links.recv((mbsz, T, cfg.d_model), dtype,
                                    self._peer(-1), dev)
                x.requires_grad_(torch.is_grad_enabled())
            y = _stage_forward(cfg, staged, x, positions)
            if s < S - 1:
                sends.append(self.links.isend(y, self._peer(1)))
            ins.append(x)
            outs.append(y)
        self.links.wait(sends)
        share = torch.zeros((), dtype=torch.float32, device=dev)
        if s == S - 1:
            h = norm(rest["final_norm"], torch.cat(outs), cfg)
            ce, n_rows = cross_entropy(lm_logits(rest, cfg, h), labels)
            share = ce * (n_rows / n_total.clamp_min(1.0))
        return ins, outs, share

    def __call__(self, rest: PyTree, staged: PyTree,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            _, _, share = self._forward(rest, staged, batch)
            return self.all_reduce([share])[0]

    def value_and_grad(self, rest: PyTree, staged: PyTree,
                       batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, PyTree]]:
        """(the batch's loss, {"rest": grads, "staged": grads}) on every
        rank: ``rest``'s summed over every rank, ``staged``'s over the
        ``data`` group."""
        s, S = self.stage, self.S
        params = {"rest": rest, "staged": staged}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        with torch.enable_grad():
            ins, outs, share = self._forward(rest, staged, batch)
            sends = []
            if s == S - 1:
                share.backward()
                outs.clear()
                if s > 0:
                    for x in reversed(ins):
                        sends.append(self.links.isend(x.grad, self._peer(-1)))
            else:
                for m in reversed(range(self.MB)):
                    y, outs[m] = outs[m], None
                    g = self.links.recv(y.shape, y.dtype, self._peer(1),
                                        y.device)
                    torch.autograd.backward(y, g)
                    if s > 0:
                        sends.append(self.links.isend(ins[m].grad,
                                                      self._peer(-1)))
            self.links.wait(sends)
        del ins
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        for p in leaves:
            p.grad = None
        n_rest = len(tree_leaves(rest))
        g_staged = grads[n_rest:]
        if self.D > 1:
            g_staged = self.all_reduce(g_staged, "data")
        *g_rest, loss = self.all_reduce(grads[:n_rest] + [share.detach()])
        return loss, tree_unflatten(params, g_rest + g_staged)


def make_pipeline_loss(cfg: ModelConfig, mesh, *, num_microbatches: int,
                       boundaries: Optional[Boundaries] = None
                       ) -> PipelineLoss:
    """loss(rest, staged, batch) with the stage axis pipelined.

    ``boundaries`` (a boundary list or PlacementSpec) enables non-uniform
    stage splits; ``None`` keeps the uniform L/S split."""
    return PipelineLoss(cfg, mesh, num_microbatches=num_microbatches,
                        boundaries=boundaries)


# --------------------------------------------------------------------------- #
# The train step
# --------------------------------------------------------------------------- #

def _rank_params(cfg: ModelConfig, layers: Tuple[int, int], seed: int,
                 params: Optional[PyTree], device: DeviceLike):
    """This rank's copies of the replicated parameters and of its stage's
    layers, from the full tree ``params`` (left unmodified) or
    ``init_params(seed)`` on ``device``."""
    dev = resolve_device(device)
    if params is None:
        params = PM.init_params(cfg, device=dev, seed=seed)
    a, b = layers
    rest = {k: tree_map(lambda t: t.detach().to(dev, copy=True), v)
            for k, v in params.items() if k != "decoder"}
    staged = tree_map(lambda t: t[a:b].detach().to(dev, copy=True),
                      params["decoder"]["g0"])
    return rest, staged


def pipeline_train_step(cfg: ModelConfig, mesh, opt_cfg: adamw.OptConfig, *,
                        num_microbatches: int = 4,
                        boundaries: Optional[Boundaries] = None):
    """Returns (init_fn, step_fn) for pipelined training on ``mesh``.

    ``init_fn(seed=0, *, params=None, device=None)`` gives this rank
    ``(rest, staged, opt)``: copies of the replicated parameters, of its
    stage's layers (leaves (count, ...)) and AdamW state over
    ``{"rest", "staged"}``, from ``init_params(seed)`` on ``device`` (the
    card unless "cpu" is asked for) or from the full tree ``params``,
    which is not modified.  ``step_fn(rest, staged, opt, batch)`` returns
    ``(rest, staged, opt, metrics)``, updated in place, with ``loss``,
    ``grad_norm`` and ``lr`` the same on every rank.  The clipping norm is
    sqrt(sum over ``rest`` once + sum over every stage's own leaves),
    reduced over the ``stage`` group.  ``step_fn.loss`` is the
    :class:`PipelineLoss` it runs."""
    loss_fn = make_pipeline_loss(cfg, mesh, num_microbatches=num_microbatches,
                                 boundaries=boundaries)

    def init_fn(seed: int = 0, *, params: Optional[PyTree] = None,
                device: DeviceLike = None):
        rest, staged = _rank_params(cfg, loss_fn.layers, seed, params, device)
        opt = adamw.init_opt_state({"rest": rest, "staged": staged}, opt_cfg)
        return rest, staged, opt

    def sq(tree: PyTree) -> torch.Tensor:
        return torch.stack([g.float().square().sum()
                            for g in tree_leaves(tree)]).sum()

    def step_fn(rest: PyTree, staged: PyTree, opt: Dict[str, Any],
                batch: Dict[str, torch.Tensor]):
        loss, grads = loss_fn.value_and_grad(rest, staged, batch)
        stage_sq = sq(grads["staged"])
        if loss_fn.S > 1:
            stage_sq = loss_fn.all_reduce([stage_sq], "stage")[0]
        gnorm = (sq(grads["rest"]) + stage_sq).sqrt()
        params, opt, mets = adamw.apply_updates(
            {"rest": rest, "staged": staged}, grads, opt, opt_cfg,
            grad_norm=gnorm)
        return params["rest"], params["staged"], opt, dict(mets, loss=loss)

    step_fn.loss = loss_fn
    return init_fn, step_fn


def gather_tree(cfg: ModelConfig, mesh, rest: PyTree, staged: PyTree, *,
                boundaries: Optional[Boundaries] = None) -> Optional[PyTree]:
    """The full tree (``rest`` with ``decoder/g0`` of (L, ...) leaves) on
    global rank 0, on the CPU; ``None`` on the other ranks.  Works for the
    parameters and for trees shaped like them (gradients, moments).  Data
    rank 0's stages send their leaves; the stages are contiguous, so rank
    0 joins them in stage order."""
    S = _mesh_extent(mesh, "stage")
    counts = stage_counts(resolve_boundaries(
        cfg, boundaries if boundaries is not None else S))
    data, stage = mesh.get_coordinate()
    links = _Links(mesh)
    leaves = tree_leaves(staged)
    if data != 0:
        return None
    if stage > 0:
        for t in leaves:
            links.wait([links.isend(t, links.rank_of(0, 0))])
        return None
    parts = [[leaf.detach().cpu()] for leaf in leaves]
    for s in range(1, S):
        for leaf, part in zip(leaves, parts):
            part.append(links.recv((counts[s],) + leaf.shape[1:], leaf.dtype,
                                   links.rank_of(0, s), leaf.device).cpu())
    full = tree_map(lambda t: t.detach().cpu(), rest)
    full["decoder"] = {"g0": tree_unflatten(
        staged, [torch.cat(part) for part in parts])}
    return full


# --------------------------------------------------------------------------- #
# Rank-side entry points (``runtime.spawn`` calls them on every rank)
# --------------------------------------------------------------------------- #

def _device_batch(batch: Dict[str, Any], dev: torch.device
                  ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def evaluate(mesh, cfg: ModelConfig, batch: Dict[str, Any], *,
             num_microbatches: int, boundaries: Optional[Boundaries] = None,
             params: Optional[PyTree] = None, seed: int = 0,
             grads: bool = False,
             device: DeviceLike = None) -> Dict[str, Any]:
    """The pipelined loss of ``batch`` (numpy or tensors, the whole
    batch) under ``params`` (the full tree; ``init_params(seed)`` on the
    rank's device by default), as {"loss": float} on every rank; with
    ``grads`` global rank 0's dict also holds ``grads``, the full
    gradient tree gathered through :func:`gather_tree` (on the CPU)."""
    dev = resolve_device(device)
    loss_fn = make_pipeline_loss(cfg, mesh, num_microbatches=num_microbatches,
                                 boundaries=boundaries)
    rest, staged = _rank_params(cfg, loss_fn.layers, seed, params, dev)
    b = _device_batch(batch, dev)
    if not grads:
        return {"loss": float(loss_fn(rest, staged, b))}
    loss, g = loss_fn.value_and_grad(rest, staged, b)
    out = {"loss": float(loss)}
    full = gather_tree(cfg, mesh, g["rest"], g["staged"],
                       boundaries=boundaries)
    if full is not None:
        out["grads"] = full
    return out


@dataclass
class PipelineRun:
    """One rank's training run: the step losses and norms (the same on
    every rank), host ms a step (each ending in a synchronisation), CUDA
    event ms a step on the card, this rank's :class:`PipelineStats` a step
    in ms, its peak device memory (bytes, the card only) and, on global
    rank 0 when asked for, the final full parameter tree on the CPU."""
    layers: Tuple[int, int]
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    wall_ms: List[float] = field(default_factory=list)
    event_ms: List[float] = field(default_factory=list)
    copy_ms: List[float] = field(default_factory=list)
    copies: List[int] = field(default_factory=list)
    wait_ms: List[float] = field(default_factory=list)
    allreduce_ms: List[float] = field(default_factory=list)
    peak_bytes: int = 0
    params: Optional[PyTree] = None


def train(mesh, cfg: ModelConfig, opt_cfg: adamw.OptConfig, *, steps: int,
          batch: int, seq_len: int, num_microbatches: int = 4,
          boundaries: Optional[Boundaries] = None,
          params: Optional[PyTree] = None, seed: int = 0,
          gather: bool = False,
          device: DeviceLike = None) -> PipelineRun:
    """``steps`` pipelined AdamW steps on this rank, on batches drawn from
    :func:`repro_torch.data.pipeline.make_batch_fn` with ``seed`` (every
    rank draws the same ones), from ``params`` or ``init_params(seed)``
    (the trainer's weights and batches for the same seed).  ``gather``
    returns the final parameters on global rank 0."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    init_fn, step_fn = pipeline_train_step(
        cfg, mesh, opt_cfg, num_microbatches=num_microbatches,
        boundaries=boundaries)
    rest, staged, opt = init_fn(seed, params=params, device=dev)
    data: Iterator = make_batch_fn(cfg, batch, seq_len, seed)
    run = PipelineRun(layers=step_fn.loss.layers)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        b = _device_batch(next(data), dev)
        step_fn.loss.stats.reset()
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize(dev)
            ev[0].record()
        t0 = time.perf_counter()
        rest, staged, opt, mets = step_fn(rest, staged, opt, b)
        if on_card:
            ev[1].record()
            torch.cuda.synchronize(dev)
            run.event_ms.append(ev[0].elapsed_time(ev[1]))
        run.wall_ms.append(1e3 * (time.perf_counter() - t0))
        st = step_fn.loss.stats
        run.copy_ms.append(1e3 * st.copy_s)
        run.copies.append(st.copies)
        run.wait_ms.append(1e3 * st.wait_s)
        run.allreduce_ms.append(1e3 * st.allreduce_s)
        run.losses.append(float(mets["loss"]))
        run.grad_norms.append(float(mets["grad_norm"]))
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if gather:
        run.params = gather_tree(cfg, mesh, rest, staged,
                                 boundaries=boundaries)
    return run
