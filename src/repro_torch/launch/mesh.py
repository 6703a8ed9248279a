"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  Every mesh is a ``torch.distributed.DeviceMesh`` over the
process group the caller initialised, one process a device
(:func:`repro_torch.distributed.runtime.spawn` starts them): the
production ``(data, model)`` mesh, the host's 1-D data mesh, any
``(data, model)`` shape the launcher's ``--mesh`` asks for, and the
DT-FM pipeline's ``(data, stage)`` edge mesh.

:func:`fake_mesh` is the dry run's mesh (the JAX package's 512
placeholder devices): a ``FakeStore`` process group of every rank of the
mesh, seen from rank 0 in this one process, whose collectives move
nothing.  It is a CPU mesh by design, and it destroys its group on exit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple

import torch.distributed as dist


def _world(what: str, needed: int) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialised process group "
            "(repro_torch.distributed.runtime.spawn starts one a rank)")
    world = dist.get_world_size()
    if needed and world != needed:
        raise ValueError(f"{what} needs {needed} ranks; the group has "
                         f"{world}")
    return world


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], *,
              device_type: str = "cuda"):
    """A mesh of ``shape`` named ``names`` over the whole group, rank
    ``r`` at the row-major coordinate of ``r``; ``device_type`` is where
    the ranks' tensors live (DTensor issues its collectives there)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(names):
        raise ValueError(f"a mesh of shape {shape} needs {len(shape)} axis "
                         f"names, got {names}")
    needed = 1
    for n in shape:
        needed *= n
    _world(f"a {' x '.join(map(str, shape))} {tuple(names)} mesh", needed)
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(names))


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16 x 16 = 256-device ``(data, model)`` mesh, or 2 x 16 x 16 =
    512 devices as ``(pod, data, model)``."""
    shape, names = PRODUCTION[multi_pod]
    return make_mesh(shape, names, device_type=device_type)


@contextlib.contextmanager
def fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]
              ) -> Iterator[object]:
    """A CPU mesh of ``shape`` named ``names`` over a fake process group of
    ``prod(shape)`` ranks, this process rank 0; the group is initialised
    on entry and destroyed on exit, so nothing of it outlives the block.
    Its collectives return at once and move no data: what runs on it is
    traced (under ``FakeTensorMode``), not computed."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a fake mesh needs this process to have no "
                           "process group of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_mesh(shape, names, device_type="cpu")
    finally:
        dist.destroy_process_group()


def fake_production_mesh(*, multi_pod: bool = False):
    """:func:`fake_mesh` of the production shape: 16 x 16 ``(data,
    model)``, or 2 x 16 x 16 ``(pod, data, model)``."""
    return fake_mesh(*PRODUCTION[multi_pod])


def make_edge_mesh(num_stages: int, data_parallel: int = 1):
    """Edge-fleet mesh for DT-FM pipeline runs: ``("data", "stage")`` of
    shape (data_parallel, num_stages) over the initialised process group,
    rank ``d * num_stages + s`` at (d, s), on the host: the pipeline
    stages its transfers through host memory."""
    from torch.distributed.device_mesh import init_device_mesh
    _world(f"a {data_parallel} x {num_stages} (data, stage) mesh",
           num_stages * data_parallel)
    return init_device_mesh("cpu", (data_parallel, num_stages),
                            mesh_dim_names=("data", "stage"))


def make_host_mesh(*, device_type: str = "cuda"):
    """Every rank of the group on a 1-D ``("data",)`` mesh."""
    return make_mesh((_world("the host mesh", 0),), ("data",),
                     device_type=device_type)
