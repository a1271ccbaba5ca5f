"""Production and host meshes over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``, with the same shapes and axis names:

Single pod: (data=16, model=16) — 256 devices.
Multi-pod:  (pod=2, data=16, model=16) — 512 devices; the sharding rules
place only data parallelism on ``pod``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks
``0 .. n - 1`` of the initialised default process group, the axis names its
``mesh_dim_names``. A mesh smaller than the world is a degraded mesh: its
ranks are the survivors, and the ranks past it are the lost hosts. Every
rank of the world builds it (the per-axis groups are made collectively);
ranks outside it see ``get_coordinate() is None``.

Functions, not module-level constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

# the backend of a world on each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_single_process(device_type: str = "cuda") -> None:
    """Start a world of one process (rank 0 of 1) on ``device_type``'s
    backend, over an in-process store: it opens no port and needs no
    network. Raises if a default group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    if device_type == "cuda":
        torch.cuda.set_device(0)        # the communicator's device
    dist.init_process_group(BACKENDS[device_type], store=dist.HashStore(),
                            rank=0, world_size=1)


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("no default process group: initialise one first "
                           "(init_single_process for a world of one)")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the world has "
                           f"{world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "cuda")


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device_type: str = "cuda"):
    """Small mesh over the first ``pod * data * model`` ranks."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or of anything with
    ``mesh_dim_names`` and ``shape`` (a mesh planned without processes)."""
    names: Sequence[str] = mesh.mesh_dim_names
    return dict(zip(names, tuple(mesh.shape)))
