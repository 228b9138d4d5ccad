"""Elastic scaling — counterpart of the JAX package's
``runtime/elastic.py``: rebuild the mesh on a changed device set and
re-place state from the last checkpoint.

A checkpoint written on one mesh restores onto any other (the
checkpointer stores whole host arrays and places them with the *new*
mesh's shardings), so shrink and grow are: detect -> choose a new mesh
shape -> rebuild the shardings -> restore.  The controller then re-runs
Algorithm 1 on the new slot set.  Devices are the ranks of the process
group (one card a rank).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.models.partitioning import mesh_device_type


def best_mesh_shape(n_devices: int, *, prefer_model: int = 16
                    ) -> Tuple[int, int]:
    """(data, model) for an arbitrary surviving device count: the largest
    power-of-two model degree <= prefer_model that divides n_devices
    (head-level TP needs uniform shards and the head counts divide powers
    of two), rest to data."""
    model = 1
    while (model * 2 <= min(prefer_model, n_devices)
           and n_devices % (model * 2) == 0):
        model *= 2
    return n_devices // model, model


class ElasticMesh:
    """A ("data", "model") ``DeviceMesh`` over ``devices`` (ranks; default
    every rank of the process group) of the shape ``best_mesh_shape``
    picks.  Every rank of the group builds it, those outside it too."""

    def __init__(self, devices=None, prefer_model: int = 16, *,
                 device_type=None):
        self.device_type = mesh_device_type(device_type)
        self.devices = list(devices if devices is not None
                            else range(dist.get_world_size()))
        self.prefer_model = prefer_model
        self.mesh = self._build()

    def _build(self):
        from torch.distributed.device_mesh import DeviceMesh
        data, model = best_mesh_shape(len(self.devices),
                                      prefer_model=self.prefer_model)
        ranks = np.array(self.devices[:data * model]).reshape(data, model)
        return DeviceMesh(self.device_type, ranks.tolist(),
                          mesh_dim_names=("data", "model"))

    def resize(self, devices, prefer_model=None) -> "ElasticMesh":
        """The mesh over a new device set (and, when given, a new
        preferred model degree)."""
        return ElasticMesh(devices, prefer_model or self.prefer_model,
                           device_type=self.device_type)


def elastic_restore(ckpt: Checkpointer, step: int, like_tree,
                    make_shardings, mesh):
    """Restore a checkpoint onto a (possibly different) mesh.
    ``make_shardings(mesh)`` builds the sharding tree for that mesh."""
    return ckpt.restore(step, like_tree, shardings=make_shardings(mesh))
