"""Process meshes (``repro.launch.mesh``).

Functions, not module-level constants, so importing this module starts
no process group.  Production shapes: single-pod (data=16, model=16) =
256 chips; multi-pod (pod=2, data=16, model=16) = 512.  Those meshes are
shapes only (:func:`make_production_mesh`): the spec functions run on
them with no process.  A mesh that moves data is made over the process
group that is up (:func:`make_mesh`), one process a rank: gloo on CPU
processes (:func:`small_host_mesh`, the tests' mesh), NCCL on cards.
"""
from __future__ import annotations

import datetime
import math
from typing import Optional, Tuple

import torch.distributed as dist

from ..parallel.sharding import Mesh, ParallelCtx

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def init_group(backend: str, rank: int, world_size: int, store_path: str,
               timeout_s: float = 60.0, device=None) -> None:
    """Start this process's rank of a ``world_size`` group, meeting the
    others through a file (no port to collide on).  A collective that
    waits longer than ``timeout_s`` raises instead of hanging.
    ``device``: the card this rank binds (NCCL)."""
    kw = {} if device is None else {"device_id": device}
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape, axes = PRODUCTION[multi_pod]
    return Mesh(axes, shape)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None) -> Mesh:
    """``shape`` over the process group that is up (its size must be the
    shape's product); rank k sits at the row-major position k.
    ``device_type``: ``cuda`` under NCCL, ``cpu`` otherwise, unless
    given."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("no process group is up: start one "
                           "(launch.mesh.init_group) before make_mesh")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return Mesh(axes, shape, dm)


def ctx_for_mesh(mesh: Mesh, **kw) -> ParallelCtx:
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ParallelCtx(mesh=mesh, data_axes=data_axes, **kw)


def small_host_mesh(n: Optional[int] = None, model: int = 2) -> Mesh:
    """The tests' (data, model) mesh over a gloo group of CPU processes
    (``n`` ranks: the group's size by default)."""
    n = n or dist.get_world_size()
    return make_mesh((n // model, model), ("data", "model"), "cpu")
