"""Mesh construction for the port's launchers and tests, as the
reference's ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
processes of the default process group, one device a process. Both
makers initialise the group when none exists: from the ``torchrun``
environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ...) when it is
set, else as a world of one process. The backend follows the device:
NCCL on the card, gloo on the CPU. A caller that needs another (two
ranks sharing one card) initialises the group itself first, and the
makers use it. Importing this module touches no process group.

``make_host_mesh`` spreads the world over ``("data", "model")``;
``make_production_mesh`` is the reference's pod layout, (data 16,
model 16) = 256 processes, or (pod 2, data 16, model 16) = 512, and
raises on a smaller world.
"""
from __future__ import annotations

import os

from repro_torch.device import DeviceLike, resolve_device


def _ensure_group(device) -> int:
    """The default process group's world size, initialising the group
    first when there is none; ``device`` picks the backend."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=names)


def make_host_mesh(model_par: int = 1, device: DeviceLike = None):
    """A ("data", "model") mesh over the whole world: world / model_par
    data-parallel rows of ``model_par`` tensor-parallel processes. On
    the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    world = _ensure_group(dev)
    if model_par < 1 or world % model_par:
        raise ValueError(f"--model-par {model_par} does not divide the "
                         f"world of {world} processes")
    return _mesh(dev, (world // model_par, model_par), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``, over a world of exactly 256 / 512 processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for x in shape:
        n *= x
    dev = resolve_device(device)
    world = _ensure_group(dev)
    if world != n:
        raise RuntimeError(
            f"the production mesh {shape} needs {n} processes, one a "
            f"device, and the world has {world}: launch with torchrun "
            f"(e.g. --nnodes {n // 8} --nproc-per-node 8)")
    return _mesh(dev, shape, names)
