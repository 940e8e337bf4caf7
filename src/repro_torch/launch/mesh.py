"""Meshes over the running process group (``repro.launch.mesh``).

Rank ``r`` of an ``(a, b, ...)`` mesh sits at ``np.unravel_index(r,
shape)``: row-major, as ``jax.make_mesh`` lays out its devices, so on a
``("data", "model")`` mesh the ranks of one data row are consecutive.
The process group is the caller's (``torch.distributed.init_process_group``
with its address, world size and rank); a one-rank mesh needs none.
The device each rank computes on comes from the caller: ``cuda`` unless
it names another, and no CUDA device raises (``device.resolve_device``).
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch.distributed as dist

from repro_torch.device import resolve_device


class Mesh:
    """Named axes over the world's ranks.  ``shape`` maps each axis to
    its extent (as the reference's ``mesh.shape``), ``devices`` is the
    rank array, ``device`` this rank's torch device.  For every set of
    axes whose extent exceeds 1, the process group of this rank and its
    peers along those axes (the ranks that share its coordinates on the
    other axes) is made with the mesh: every rank makes every group, in
    one order, as ``torch.distributed.new_group`` requires."""

    def __init__(self, shape, axis_names, device=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        n = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != n:
            raise RuntimeError(
                f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the "
                f"process group has {world}; launch {n} processes (python "
                f"-m torch.distributed.run --nproc-per-node {n} ...)")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = np.arange(n).reshape(shape)
        self.device = resolve_device(device)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self._groups = {}
        for r in range(1, len(axis_names) + 1):
            for sub in itertools.combinations(axis_names, r):
                size = math.prod(self.shape[a] for a in sub)
                if size == 1:
                    continue
                if size == n:
                    self._groups[sub] = dist.group.WORLD
                    continue
                idx = [axis_names.index(a) for a in sub]
                rows = np.moveaxis(self.devices, idx,
                                   range(-len(sub), 0)).reshape(-1, size)
                for ranks in rows:
                    g = dist.new_group([int(x) for x in ranks])
                    if self.rank in ranks:
                        self._groups[sub] = g

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def index(self, axes) -> int:
        """This rank's coordinate along ``axes`` (row-major over them)."""
        key = self._key(axes)
        c = 0
        for a in key:
            c = c * self.shape[a] + self.coords[a]
        return c

    def group(self, axes):
        """The process group along ``axes``; None when their extent is
        1."""
        key = self._key(axes)
        return self._groups.get(key) if self.size(key) > 1 else None

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device})")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16 x 16 ``("data", "model")`` ranks, or 2 x 16 x 16 with a leading
    pure-data-parallel ``pod`` axis; raises, naming the ranks it needs,
    when the process group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh, have {world}; launch "
            f"{n} processes (python -m torch.distributed.run --nnodes ... "
            f"--nproc-per-node ...)")
    return Mesh(shape, axes, device)


def make_debug_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the running process group (which
    must hold ``data * model`` ranks; one rank needs none)."""
    return Mesh((data, model), ("data", "model"), device)
