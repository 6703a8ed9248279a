"""Process runtime: one process per device of a mesh (the port's
counterpart of the JAX package's ``--xla_force_host_platform_device_count``
placeholder devices).

:func:`spawn` starts one rank per device with ``torch.multiprocessing``
(the ``spawn`` start method), joins them through a ``FileStore`` in a
temporary directory (so concurrent runs never collide on a port), builds
the mesh on each and runs the caller's calls there in order: the DT-FM
pipeline's ``("data", "stage")`` edge mesh (``data=``, ``stages=``), or
any mesh by ``shape=`` and ``names=``, such as the production mesh's
``("data", "model")``.  It returns every rank's results and the FA-2
wrappers' launch records, counted in each rank's process from 0 at every
call, summed over the ranks.  A rank that raises fails the run: the join
raises and stops the other ranks.

The transport is the caller's explicit choice, never a fallback (gloo
joins the ranks in every case):

* ``"gloo"`` hands gloo the tensors as they are.  The pipeline stages its
  own transfers through host memory (:mod:`repro_torch.distributed.
  pipeline`), and CPU ranks hold host tensors.
* ``"host"`` moves every collective DTensor issues through host memory
  the ranks share (:class:`HostSlots`: files in the run's temporary
  directory, mapped by every rank), gloo only synchronising them.  On
  the card gloo's own CUDA path crashed an all-gather and its host path
  moved 0.2-0.4 GB/s (``PERF.md`` §6), so the production mesh uses this
  one, on the card and on CPU ranks alike.
* ``"nccl"`` needs a card a rank, so it waits for the multi-card slice
  and raises until then.

Ranks on the card share cards round-robin (one card: all of them on it).
On a mesh given by ``shape=`` every rank counts DTensor's collectives by
kind (:func:`collectives`); the edge mesh's ranks send with ``c10d``
directly and run no such count.  A ``shape=`` mesh on the card needs
``"host"``: gloo's CUDA all-gather crashed its ranks there.
The kernels must be built before the ranks start
(``kernels.build.build_all``): the ranks only load them.
"""

from __future__ import annotations

import collections
import datetime
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import DeviceLike, resolve_device

TRANSPORTS = ("gloo", "host")
_MULTI_CARD_SLICE = ("the multi-card slice of the port (the production "
                     "mesh, four cards over NVLink)")
# a collective or receive that waits longer fails its rank (a full-width
# step takes about a second; a rank's first step, its set-up included,
# under 20 s)
TIMEOUT_S = 600.0


@dataclass
class SpawnResult:
    """``values[c][r]``: call ``c``'s return value on rank ``r``;
    ``launches[c]``: the FA-2 wrappers' launches in call ``c`` by wrapper
    name, summed over the ranks; ``kernels[c]``: the same by the kernel
    instantiation the library reports; ``quant8[c][r]``: the int8
    quantize and dequantize wrappers' launches on rank ``r``;
    ``adamw[c][r]``: the AdamW norm and update wrappers' launches on rank
    ``r``."""
    values: List[List[Any]]
    launches: List[Dict[str, int]]
    kernels: List[Dict[str, int]]
    quant8: Optional[List[List[Dict[str, int]]]] = None
    adamw: Optional[List[List[Dict[str, int]]]] = None


def _fa_wrappers():
    from repro_torch.kernels.flash_attention import kernel as FK
    return (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
            FK.flash_attention_bwd_dkdv)


def _quant8_wrappers():
    from repro_torch.kernels.quant8 import kernel as QK
    return (QK.quantize_blocks, QK.dequantize_blocks)


def _adamw_wrappers():
    from repro_torch.kernels.adamw import kernel as AK
    return (AK.square_sums, AK.adamw_update)


# the functional collectives DTensor issues, each taking its tensor first,
# by the HLO kind they are counted under (the JAX package's dry-run
# record names them so), and the namespace's ops that move no data
KINDS = {"all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_to_all_single": "all-to-all"}
COLLECTIVES = tuple(KINDS)
LOCAL_OPS = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CollectiveCount:
    """Collectives by HLO kind (:data:`KINDS`): ``calls``, ``bytes`` (each
    call's input, what a rank sends in) and ``result_bytes``.  The one
    count of :class:`Collectives` on the ranks and of the dry run's
    ``launch.step_analysis.StepCounter`` on a fake group."""

    def reset(self) -> None:
        self.calls: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()
        self.result_bytes: Dict[str, int] = collections.Counter()

    def add(self, name: str, x: torch.Tensor, out: torch.Tensor) -> str:
        """Count one call of the functional collective ``name``; returns
        its kind."""
        kind = KINDS.get(name, name)
        self.calls[kind] += 1
        self.bytes[kind] += _nbytes(x)
        self.result_bytes[kind] += _nbytes(out)
        return kind

    def totals(self) -> Dict[str, Any]:
        """The JAX dry-run record's collectives: result bytes and calls by
        kind and their total, with the bytes sent in by kind."""
        return {"bytes_by_op": dict(self.result_bytes),
                "counts": dict(self.calls),
                "total_bytes": sum(self.result_bytes.values()),
                "sent_bytes_by_op": dict(self.bytes)}


class HostSlots:
    """The ``host`` transport's staging memory: for every process group a
    rank belongs to, two files of its own in the run's temporary
    directory (collectives on a group alternate between them), mapped
    shared by every rank of the group and grown as a collective needs.
    A collective writes its input into the rank's file, waits on the
    group's gloo barrier, and reads every rank's input from the files;
    the alternation lets a rank that is one collective ahead write while
    the others still read, so one barrier a collective suffices.  Every
    rank reduces in rank order, so all of them get the same sums."""

    def __init__(self, root: Path):
        self.root = root
        self.maps: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self.ops: Dict[str, int] = collections.Counter()
        self.copy_s = 0.0

    def _slot(self, group: str, rank: int, parity: int, nbytes: int,
              own: bool) -> torch.Tensor:
        key = (group, rank, parity)
        t = self.maps.get(key)
        if t is not None and t.numel() >= nbytes:
            return t
        size = 1 << max(20, (nbytes - 1).bit_length())   # power of two
        path = self.root / f"{group}.{rank}.{parity}"
        if own:
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
            try:
                if os.fstat(fd).st_size < size:
                    os.ftruncate(fd, size)
            finally:
                os.close(fd)
        t = torch.from_file(str(path), shared=True, size=size,
                            dtype=torch.uint8)
        self.maps[key] = t
        return t

    def run(self, name: str, x: torch.Tensor, rest: Sequence[Any]
            ) -> torch.Tensor:
        group = rest[-1]
        pg = dist.distributed_c10d._resolve_process_group(group)
        n, r = pg.size(), pg.rank()
        parity = self.ops[group] % 2
        self.ops[group] += 1
        x = x.contiguous()
        flat = x.reshape(-1).view(torch.uint8)
        nbytes = flat.numel()
        t0 = time.perf_counter()
        self._slot(group, r, parity, nbytes, own=True)[:nbytes].copy_(flat)
        self.copy_s += time.perf_counter() - t0
        dist.barrier(group=pg)
        t0 = time.perf_counter()
        parts = [self._slot(group, i, parity, nbytes, own=False)[:nbytes]
                 .view(x.dtype).view(x.shape) for i in range(n)]
        if name == "all_gather_into_tensor":
            out = torch.cat([p.to(x.device) for p in parts])
        elif name == "all_to_all_single":
            if any(s is not None for s in rest[:2]):
                raise NotImplementedError("all_to_all_single with split "
                                          "sizes is not staged")
            chunk = x.shape[0] // n
            out = torch.cat([p[r * chunk:(r + 1) * chunk].to(x.device)
                             for p in parts])
        else:
            op = rest[0]
            if op not in ("sum", "avg"):
                raise NotImplementedError(f"{name} with {op!r} is not "
                                          "staged")
            if name == "reduce_scatter_tensor":
                chunk = x.shape[0] // n
                parts = [p[r * chunk:(r + 1) * chunk] for p in parts]
            out = parts[0].to(x.device, copy=True)
            for p in parts[1:]:
                out += p.to(x.device)
            if op == "avg":
                out /= n
            if name == "all_reduce_":
                x.copy_(out)
                out = x
        self.copy_s += time.perf_counter() - t0
        return out


    def gather(self, x: torch.Tensor, dst: int
               ) -> Optional[List[torch.Tensor]]:
        """Every rank's ``x`` (one shape and dtype on all the ranks of the
        world group) in host memory on rank ``dst``: each rank copies its
        own into its file, and after the barrier ``dst`` alone reads them,
        as views of the files (valid until the next-but-one gather); None
        on the other ranks.  Nothing goes back to a card."""
        group = "gather"
        n, r = dist.get_world_size(), dist.get_rank()
        parity = self.ops[group] % 2
        self.ops[group] += 1
        flat = x.contiguous().reshape(-1).view(torch.uint8)
        nbytes = flat.numel()
        self._slot(group, r, parity, nbytes, own=True)[:nbytes].copy_(flat)
        dist.barrier()
        if r != dst:
            return None
        return [self._slot(group, i, parity, nbytes, own=False)[:nbytes]
                .view(x.dtype).view(x.shape) for i in range(n)]


# the tensor subclasses whose ops come back through a dispatch mode as
# their plain tensors' ops
_WRAPPERS = (DTensor, AsyncCollectiveTensor)


class Collectives(TorchDispatchMode, CollectiveCount):
    """DTensor's collectives on a rank, counted by HLO kind (ms, and
    :class:`CollectiveCount`'s calls, bytes sent in and result bytes),
    each waited for where it is issued.  With ``slots`` (the
    ``host`` transport) each is staged through the ranks' shared host
    memory (:class:`HostSlots`), on the card and the CPU alike, and a
    collective of another kind raises: nothing is left unstaged.  On a
    card the compute queued before a collective is waited for first, so
    its ms are the collective's alone (the copies to and from host
    memory, with the staging, also counted under ``host_copy``)."""

    def __init__(self, slots: Optional[HostSlots] = None):
        super().__init__()
        self.slots = slots
        self.reset()

    def reset(self) -> None:
        CollectiveCount.reset(self)
        self.ms: Dict[str, float] = collections.defaultdict(float)
        if self.slots is not None:
            self.slots.copy_s = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _WRAPPERS) for t in types):
            # a DTensor op (or a funcol wrapper's): let the subclass run
            # first, so the collectives it issues come back through here
            return NotImplemented
        kwargs = kwargs or {}
        if func.namespace != "_c10d_functional":
            return func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if name in LOCAL_OPS:
            return func(*args, **kwargs)
        if name not in COLLECTIVES:
            if self.slots is not None:
                raise NotImplementedError(
                    f"collective {name} is not staged through host memory")
            return func(*args, **kwargs)
        x = args[0]
        on_card = x.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        if self.slots is not None:
            out = self.slots.run(name, x, args[1:])
        else:
            out = torch.ops._c10d_functional.wait_tensor(
                func(*args, **kwargs))
        if on_card:
            torch.cuda.synchronize(x.device)
        self.ms[self.add(name, x, out)] += 1e3 * (time.perf_counter() - t0)
        if self.slots is not None:
            self.ms["host_copy"] = 1e3 * self.slots.copy_s
        return out


_ACTIVE: List[Collectives] = []


def collectives() -> Optional[Collectives]:
    """This rank's :class:`Collectives` inside a :func:`spawn` call on a
    ``shape=`` mesh, else None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _mesh(edge: bool, shape: Tuple[int, ...], names: Tuple[str, ...],
          device: torch.device):
    from repro_torch.launch.mesh import make_edge_mesh, make_mesh
    if edge:
        return make_edge_mesh(shape[1], shape[0])
    return make_mesh(shape, names, device_type=device.type)


def _rank_main(rank: int, world: int, tmp: str, edge: bool,
               shape: Tuple[int, ...], names: Tuple[str, ...],
               transport: str, device: torch.device,
               calls: Sequence[Callable]) -> None:
    torch.set_num_threads(1)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = _mesh(edge, shape, names, device)
        slots = None
        if transport == "host":
            (Path(tmp) / "host").mkdir(exist_ok=True)
            slots = HostSlots(Path(tmp) / "host")
        out = []
        for call in calls:
            wrappers = _fa_wrappers()
            for f in wrappers:
                f.launches = 0
                f.kernels.clear()
            for f in _quant8_wrappers() + _adamw_wrappers():
                f.launches = 0
            if edge:
                value = call(mesh, device=device)
            else:
                with Collectives(slots) as coll:
                    _ACTIVE.append(coll)
                    try:
                        value = call(mesh, device=device)
                    finally:
                        _ACTIVE.pop()
            by_kernel: Dict[str, int] = collections.Counter()
            for f in wrappers:
                by_kernel.update(f.kernels)
            out.append((value, {f.__name__: f.launches for f in wrappers},
                        dict(by_kernel),
                        {f.__name__: f.launches for f in _quant8_wrappers()},
                        {f.__name__: f.launches for f in _adamw_wrappers()}))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(calls: Sequence[Callable], *, data: int = 1,
          stages: Optional[int] = None,
          shape: Optional[Tuple[int, ...]] = None,
          names: Optional[Tuple[str, ...]] = None, transport: str,
          device: DeviceLike = None) -> SpawnResult:
    """Run each of ``calls`` as ``call(mesh, device=...)`` on every rank,
    in order: over the ``data x stages`` edge mesh, or over a mesh of
    ``shape`` named ``names`` (one rank a device, ``prod(shape)`` ranks).
    ``calls`` are picklable callables (module-level functions or
    ``functools.partial`` of them), each rank's ``device`` the card unless
    "cpu" is asked for.  A ``shape=`` mesh on the card takes the
    ``"host"`` transport (gloo's CUDA collectives crashed its ranks)."""
    edge = stages is not None
    if edge == (shape is not None):
        raise ValueError("give either stages= (the edge mesh) or shape= "
                         "and names=")
    if edge:
        shape, names = (data, stages), ("data", "stage")
    elif names is None or len(names) != len(shape):
        raise ValueError(f"a mesh of shape {shape} needs {len(shape)} axis "
                         f"names, got {names}")
    if transport == "nccl":
        raise NotImplementedError(
            f"the nccl transport waits for {_MULTI_CARD_SLICE}; gloo shares "
            "a card among the ranks")
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} is not one of "
                         f"{TRANSPORTS}")
    if edge and transport == "host":
        raise ValueError("transport='host' stages DTensor's collectives; the "
                         "edge mesh sends its own through gloo")
    if (not edge and transport == "gloo"
            and torch.device(device or "cuda").type == "cuda"):
        raise ValueError(
            "a shape= mesh on the card needs transport='host': DTensor's "
            "all-gather through gloo with CUDA tensors crashed its ranks "
            "(SIGSEGV)")
    dev = resolve_device(device)
    world = 1
    for n in shape:
        world *= n
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, args=(world, tmp, edge, tuple(shape), tuple(names),
                              transport, dev, list(calls)),
            nprocs=world, join=True, start_method="spawn")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
    values, launches, kernels = [], [], []
    for c in range(len(calls)):
        values.append([ranks[r][c][0] for r in range(world)])
        total: Dict[str, int] = collections.Counter()
        by_kernel: Dict[str, int] = collections.Counter()
        for r in range(world):
            total.update(ranks[r][c][1])
            by_kernel.update(ranks[r][c][2])
        launches.append(dict(total))
        kernels.append(dict(by_kernel))

    def by_rank(i):
        return [[ranks[r][c][i] for r in range(world)]
                for c in range(len(calls))]
    return SpawnResult(values, launches, kernels, quant8=by_rank(3),
                       adamw=by_rank(4))
