"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group and no device.  A mesh is a ``torch.distributed``
``DeviceMesh`` over the ranks of the process group the caller has
initialised (one process per device: NCCL on the card, gloo on the CPU),
its dimension names the reference's axis names.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over every rank of the world
    (their product must be the world size); ``device_type`` "cpu" for a
    gloo world."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 devices (``data``, ``model``); (2, 16, 16) = 512
    across 2 pods (``pod``, ``data``, ``model``).  ``data`` carries DP/FSDP
    and sequence-parallel KV pages, ``model`` TP/EP, ``pod`` cross-pod
    data parallelism.  Only in a world of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs a world of "
                           f"{math.prod(shape)} ranks, this one has {world}")
    return make_mesh(shape, axes, device_type)
