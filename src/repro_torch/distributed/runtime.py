"""Process runtime for the pipeline: one process per ``(data, stage)``
device (the port's counterpart of the JAX package's
``--xla_force_host_platform_device_count`` placeholder devices).

:func:`spawn` starts ``data x stages`` ranks with ``torch.multiprocessing``
(the ``spawn`` start method), joins them through a ``FileStore`` in a
temporary directory (so concurrent runs never collide on a port), builds
the ``("data", "stage")`` mesh on each and runs the caller's calls there
in order.  It returns every rank's results and the FA-2 wrappers' launch
records, counted in each rank's process from 0 at every call, summed over
the ranks.  A rank that raises fails the run: the join raises and stops
the other ranks.

The transport is the caller's explicit choice, never a fallback.  The
one transport is ``"gloo"``, which carries host tensors, so ranks on the
card stage every transfer through host memory
(:mod:`repro_torch.distributed.pipeline`); ranks on the card share cards
round-robin (one card: all of them on it).  ``"nccl"`` needs a card a
rank, so it waits for the multi-card slice and raises until then.  The kernels must
be built before the ranks start (``kernels.build.build_all``): the ranks
only load them.
"""

from __future__ import annotations

import collections
import datetime
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import DeviceLike, resolve_device

TRANSPORTS = ("gloo",)
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
    instantiation the library reports."""
    values: List[List[Any]]
    launches: List[Dict[str, int]]
    kernels: List[Dict[str, int]]


def _fa_wrappers():
    from repro_torch.kernels.flash_attention import kernel as FK
    return (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
            FK.flash_attention_bwd_dkdv)


def _rank_main(rank: int, world: int, tmp: str, data: int, stages: int,
               transport: str, device: torch.device,
               calls: Sequence[Callable]) -> None:
    from repro_torch.launch.mesh import make_edge_mesh
    torch.set_num_threads(1)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        transport, store=dist.FileStore(str(Path(tmp) / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_edge_mesh(stages, data)
        out = []
        for call in calls:
            wrappers = _fa_wrappers()
            for f in wrappers:
                f.launches = 0
                f.kernels.clear()
            value = call(mesh, device=device)
            by_kernel: Dict[str, int] = collections.Counter()
            for f in wrappers:
                by_kernel.update(f.kernels)
            out.append((value, {f.__name__: f.launches for f in wrappers},
                        dict(by_kernel)))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(calls: Sequence[Callable], *, data: int = 1, stages: int,
          transport: str, device: DeviceLike = None) -> SpawnResult:
    """Run each of ``calls`` as ``call(mesh, device=...)`` on every rank of
    a ``data x stages`` mesh, in order; ``calls`` are picklable callables
    (module-level functions or ``functools.partial`` of them), each
    rank's ``device`` the card unless "cpu" is asked for."""
    if transport == "nccl":
        raise NotImplementedError(
            f"the nccl transport waits for {_MULTI_CARD_SLICE}; gloo shares "
            "a card among the ranks")
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} is not one of "
                         f"{TRANSPORTS}")
    dev = resolve_device(device)
    world = data * stages
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, args=(world, tmp, data, stages, transport, dev,
                              list(calls)),
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
    return SpawnResult(values, launches, kernels)
