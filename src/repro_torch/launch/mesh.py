"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  The edge mesh is a ``torch.distributed.DeviceMesh`` over
the process group the caller initialised (one process per device;
:func:`repro_torch.distributed.runtime.spawn` starts them).  The
production and host meshes belong to the production-mesh slice
(sharding, activation constraints, the dry run) and are not ported yet.
"""

from __future__ import annotations

import torch.distributed as dist

_PRODUCTION_SLICE = ("the production-mesh slice of the port (FSDP + TP "
                     "sharding, activation constraints, the dry run)")


def make_production_mesh(*, multi_pod: bool = False):
    """Not ported yet: the JAX package's 16 x 16 (or 2 x 16 x 16) mesh."""
    raise NotImplementedError(
        f"make_production_mesh waits for {_PRODUCTION_SLICE}")


def make_edge_mesh(num_stages: int, data_parallel: int = 1):
    """Edge-fleet mesh for DT-FM pipeline runs: ``("data", "stage")`` of
    shape (data_parallel, num_stages) over the initialised process group,
    rank ``d * num_stages + s`` at (d, s), on the host: gloo, the
    runtime's transport, carries host tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_edge_mesh needs an initialised process group "
            "(repro_torch.distributed.runtime.spawn starts one a rank)")
    world = dist.get_world_size()
    if world != num_stages * data_parallel:
        raise ValueError(
            f"a {data_parallel} x {num_stages} (data, stage) mesh needs "
            f"{num_stages * data_parallel} ranks; the group has {world}")
    return init_device_mesh("cpu", (data_parallel, num_stages),
                            mesh_dim_names=("data", "stage"))


def make_host_mesh():
    """Not ported yet: the JAX package's 1-D data mesh over local
    devices."""
    raise NotImplementedError(f"make_host_mesh waits for {_PRODUCTION_SLICE}")
