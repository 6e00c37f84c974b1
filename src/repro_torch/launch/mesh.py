"""LM meshes over ``torch.distributed`` ranks (the twin of the reference's
``launch/mesh.py``).

The reference's mesh is a grid of devices driven by one controller; the
port's is a grid of ranks, one program each (SPMD).  Axis names and shapes
are the reference's: ``("data", "model")``, or ``("pod", "data",
"model")`` for a 3-tuple; ``pod`` is pure data parallelism across pods,
``data`` FSDP / data parallelism, ``model`` tensor / expert parallelism.
Ranks are laid out row-major over the grid, as the reference lays out its
devices, so rank ``r`` sits at ``np.unravel_index(r, shape)``.

:class:`MeshShape` is the grid alone (axis names and sizes): what the
sharding rules read, and all a test needs to check them at 256 chips
without 256 ranks.  :class:`Mesh` adds this rank's coordinate and one
process group per axis, from a ``torch.distributed.device_mesh.DeviceMesh``
with ``mesh_dim_names``.  The ``DeviceMesh`` is made for the ``cuda``
device type over NCCL, and for ``cpu`` over gloo, whose ranks may share
one card: the port runs no DTensor, so the device type only decides which
device state ``DeviceMesh`` sets up, and gloo ranks on one card must not
each claim a card of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = [
    "Mesh",
    "MeshShape",
    "axis_sizes",
    "make_mesh",
    "make_production_mesh",
    "make_test_mesh",
    "production_mesh_shape",
    "rank_grid",
]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A grid of ranks: its axis names and their sizes."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"MeshShape: axes {self.axis_names} for sizes {self.sizes}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a jax ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))


@dataclasses.dataclass(frozen=True)
class Mesh(MeshShape):
    """A :class:`MeshShape` over the ranks of a process group: this rank's
    coordinate on each axis and the process group of each axis (the ranks
    that differ from this one only along it)."""

    coords: tuple = ()
    groups: tuple = ()
    device_mesh: Any = None

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.sizes))


def _axes_for(shape) -> tuple:
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def production_mesh_shape(*, multi_pod: bool = False, shape=None) -> MeshShape:
    """(16, 16) single pod = 256 chips; (2, 16, 16) = 2 pods × 256 chips.
    ``shape`` overrides the (data, model) factorization of the same chips
    per pod, e.g. (64, 4) for architectures whose head structure shards
    only 4-way (xLSTM)."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(int(s) for s in shape)
    return MeshShape(_axes_for(shape), shape)


def rank_grid(mesh: MeshShape) -> np.ndarray:
    """The ranks of the grid, row-major: ``rank_grid(m)[c] == r`` for the
    coordinate c of rank r."""
    return np.arange(mesh.size).reshape(mesh.sizes)


def make_mesh(shape, axes) -> Mesh:
    """The mesh of ``shape`` with ``axes`` over the default process group,
    which must exist and hold exactly the mesh's ranks."""
    grid = MeshShape(tuple(axes), tuple(int(s) for s in shape))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks first (launch.distributed.run_ranks)")
    world = dist.get_world_size()
    if world != grid.size:
        raise ValueError(f"make_mesh: a {grid.sizes} mesh needs {grid.size} ranks, the world holds {world}")
    dm = DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu", torch.from_numpy(rank_grid(grid)),
                    mesh_dim_names=grid.axis_names)
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), grid.sizes))
    return Mesh(grid.axis_names, grid.sizes, coords, tuple(dm.get_group(a) for a in grid.axis_names), dm)


def make_production_mesh(*, multi_pod: bool = False, shape=None) -> Mesh:
    """The reference's production mesh over the current ranks (256 or 512
    of them, or ``shape``'s product)."""
    grid = production_mesh_shape(multi_pod=multi_pod, shape=shape)
    return make_mesh(grid.sizes, grid.axis_names)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh for tests and the card's mesh phase."""
    return make_mesh(shape, axes)
