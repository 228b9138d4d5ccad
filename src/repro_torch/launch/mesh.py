"""Device meshes — counterpart of the JAX package's ``launch/mesh.py`` over
``torch.distributed.device_mesh.init_device_mesh``.

``make_production_mesh`` is a function, so importing this module touches
no device state.  Single pod: (16, 16) = 256 devices, mesh dimensions
("data", "model"); multi-pod: (2, 16, 16) = 512 with an outer "pod"
dimension (outer data parallelism, expert parallelism).  The process group
must be up first (``torch.distributed.init_process_group`` with its
address, world size and rank: nothing on a single machine announces a
cluster), and a mesh whose size is not the world size raises.  A mesh
lives on the GPUs unless ``device_type="cpu"`` is asked for (the gloo
backend).
"""
from __future__ import annotations

import math

import torch.distributed as dist

# the reference keeps the degrees here; the port beside the mesh
# dimension names
from repro_torch.models.partitioning import (  # noqa: F401
    dp_degree, mesh_device_type, tp_degree)

SINGLE_POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_mesh(shape, names, *, device_type=None):
    """A ``DeviceMesh`` of ``shape`` with dimensions ``names`` over every
    rank of the initialized process group."""
    device_type = mesh_device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("initialize the process group first "
                           "(torch.distributed.init_process_group with "
                           "init_method, world_size and rank)")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} holds {n} "
                         f"devices; the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type=device_type)


def make_debug_mesh(data: int = 1, model: int = 1, *, device_type=None):
    """A small ("data", "model") mesh: (1, 1) on one card, (2, 2) or
    (1, 4) over four CPU ranks in the tests."""
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)
