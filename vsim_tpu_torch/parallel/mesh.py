"""Rank meshes (port of vsim_tpu/parallel/mesh.py).

A JAX ``Mesh`` is a grid of devices that one program drives.  Here each
rank is its own process with its own device, so a ``Mesh`` is the grid of
ranks as this rank sees it: the size of each named axis, this rank's
coordinate on it, and the process group of the ranks that share every
other coordinate (``torch.distributed.device_mesh.DeviceMesh.get_group``),
over which the model's collectives run.  A mesh whose model axis has size
1 runs no collective.

``make_mesh`` builds one over the initialized process group (see
parallel/distributed.py); ``single_device_mesh`` needs none.  A ``Mesh``
built by hand from sizes and a coordinate (no groups) serves what needs
only the layout: ``sharding.param_pspecs`` and ``shard_params`` of one
rank's shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"


@dataclasses.dataclass
class Mesh:
    """``sizes[i]`` ranks along ``axis_names[i]``; this rank sits at
    ``coord``.  ``groups[i]`` is the process group of axis i (None when
    the mesh has no process group behind it)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coord: Optional[Tuple[int, ...]] = None
    groups: Optional[Tuple[object, ...]] = None
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        self.sizes = tuple(int(s) for s in self.sizes)
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.sizes)} sizes for axes "
                             f"{self.axis_names}")
        if self.coord is None:
            self.coord = (0,) * len(self.sizes)
        self.coord = tuple(self.coord)
        if any(not 0 <= c < s for c, s in zip(self.coord, self.sizes)):
            raise ValueError(f"coordinate {self.coord} outside {self.sizes}")

    @property
    def shape(self):
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis it lacks)."""
        if axis not in self.axis_names:
            return 0
        return self.coord[self.axis_names.index(axis)]

    def group(self, axis: str):
        if self.groups is None or axis not in self.axis_names:
            return None
        return self.groups[self.axis_names.index(axis)]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (AXIS_DATA, AXIS_MODEL),
              device: Optional[torch.device] = None) -> Mesh:
    """A mesh over every rank of the initialized process group, ranks laid
    out in row-major order.  Default shape (1, world): every rank on the
    model axis (tensor parallel), as the JAX package's default.
    ``device``: this rank's device (default: ``distributed.local_device``
    of the group's backend).  Without a process group only a mesh of one
    rank can be made."""
    from vsim_tpu_torch.parallel import distributed

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = (1, world) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != world or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} "
                         f"!= {world} ranks")
    if device is None:
        device = distributed.local_device()
    if not dist.is_initialized():
        return Mesh(tuple(axis_names), shape, device=torch.device(device))
    from torch.distributed.device_mesh import DeviceMesh

    dev = torch.device(device)
    dm = DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                    mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(axis_names), shape,
                coord=tuple(dm.get_coordinate()),
                groups=tuple(dm.get_group(a) for a in axis_names),
                device=dev)


def single_device_mesh(device: Optional[torch.device] = None) -> Mesh:
    """A (1, 1) mesh of this rank alone: no collectives."""
    from vsim_tpu_torch.parallel import distributed

    dev = torch.device(device) if device is not None \
        else distributed.local_device()
    return Mesh((AXIS_DATA, AXIS_MODEL), (1, 1), device=dev)
