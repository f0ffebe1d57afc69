"""Device meshes on ``torch.distributed`` — the port of
``repro/launch/mesh.py``.

Defined as functions, so importing this module touches no process group:
the dry run starts a fake group of 256 or 512 ranks before it builds a
production mesh, and everything else sees the world its process group has.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions (``("data", "model")``, or ``("pod", "data", "model")``).  On
the card its collectives run over NCCL; on the CPU, when the caller asks
for it, over gloo.  With no process group initialised ``make_host_mesh``
starts a world of one in this process (an in-process store, no port).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.placement import backend_for, ensure_process_group

__all__ = ["SINGLE_POD", "MULTI_POD", "backend_for", "ensure_process_group",
           "make_production_mesh", "make_host_mesh", "mesh_chip_count"]

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _mesh(device: torch.device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks a pod over ("data", "model"); two pods = 512 over
    ("pod", "data", "model").  The process group must already hold that
    many ranks (the dry run's fake group does)."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    device = ensure_process_group(device)
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"a production mesh {shape} needs {math.prod(shape)} ranks; the "
            f"process group has {dist.get_world_size()}")
    return _mesh(device, shape, names)


def make_host_mesh(model_parallel: int = 1, device=None):
    """A ("data", "model") mesh over whatever world the process group has
    (a world of one when there is none): ``model_parallel`` ranks on
    ``model`` (clipped to the world), the rest on ``data``.  On the card
    unless ``device`` names another (no card and no ``device`` raises)."""
    device = ensure_process_group(device)
    n = dist.get_world_size()
    model = max(1, min(model_parallel, n))
    if n % model:
        raise ValueError(f"a world of {n} does not split into "
                         f"{model}-wide model groups")
    return _mesh(device, (n // model, model), ("data", "model"))


def mesh_chip_count(mesh) -> int:
    return int(mesh.size())
