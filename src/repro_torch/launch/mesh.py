"""The "mesh" of the port: named axes over
``torch.distributed`` process groups (a port of ``repro.launch.mesh`` and
of the ``jax.make_mesh`` calls the reference's tests make).

The reference's mesh is a ``jax.sharding.Mesh`` whose named axes the
collectives address inside ``shard_map``. Here every process is one rank,
and an :class:`Axis` carries what a collective along it needs: its size,
this rank's index on it, the global ranks of its members and the process
group. ``make_mesh(shape, names)`` lays the ranks out row-major, the last
axis fastest (on ``(pod, data)``: rank = pod·D + data), as
``jax.make_mesh`` orders CPU devices; ``make_local_mesh(M)`` is the
reference's ``(data=world/M, model=M)`` mesh.

The default process group is built from ``RANK`` / ``WORLD_SIZE``
(``torchrun``, with ``MASTER_ADDR`` / ``MASTER_PORT``) or, with neither
set, for one process (an in-memory store; no port is opened). NCCL serves
CUDA, gloo the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class Axis:
    name: str
    size: int
    index: int                 # this rank's position along the axis
    ranks: Tuple[int, ...]     # global ranks of the members, in axis order
    group: Any = None          # process group; None for a size-1 axis
                               # that no group spans


@dataclasses.dataclass(frozen=True)
class Mesh:
    axes: Tuple[Axis, ...]
    device: torch.device
    owns_group: bool = False   # this mesh initialised the process group

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"no mesh axis {name!r} in {self.axis_names}")

    def destroy(self) -> None:
        """Tear the process group down if this mesh set it up."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _init_group(device: torch.device) -> bool:
    """Initialise the default process group unless one exists. Returns
    whether this call did."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    return True


def _axis_groups(shape, world: int):
    """Per axis, the global ranks of every line of the mesh along it
    (row-major layout, last axis fastest), in a fixed order."""
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    lines = []
    for d, size in enumerate(shape):
        starts = [r for r in range(world) if (r // strides[d]) % size == 0]
        lines.append([tuple(s + i * strides[d] for i in range(size))
                      for s in starts])
    return strides, lines


def make_mesh(shape, axis_names, *, device: Optional[str] = None) -> Mesh:
    """Mesh of ``shape`` (one size per name) over every rank of the job,
    whose product must be the world size. Each rank takes the card
    ``LOCAL_RANK`` (default 0) unless ``device`` is given;
    ``device='cpu'`` runs on the CPU over gloo.

    Each axis of size > 1 gets one process group per line of the mesh
    along it (the whole world where one line holds every rank); every
    rank creates every group, in one fixed order, then joins one
    all-reduce on each of its own groups, so that no communicator is
    first used by a point-to-point batch that only some members post (a
    tree level)."""
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not fit names {names}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owns = _init_group(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the job has {world}")
    strides, lines = _axis_groups(shape, world)
    axes = []
    for d, (name, size) in enumerate(zip(names, shape)):
        mine = next(line for line in lines[d] if rank in line)
        group = None
        if size > 1:
            for line in lines[d]:            # every rank, every group
                g = (dist.group.WORLD if len(line) == world
                     else dist.new_group(list(line)))
                if line == mine:
                    group = g
        axes.append(Axis(name, size, (rank // strides[d]) % size, mine,
                         group))
    for a in axes:
        if a.group is not None:
            dist.all_reduce(torch.zeros(1, device=dev), group=a.group)
    return Mesh(tuple(axes), dev, owns)


def make_local_mesh(model_parallel: int = 1, *,
                    device: Optional[str] = None) -> Mesh:
    """Mesh over every rank of the job: ``(data=world/M, model=M)`` for
    ``model_parallel`` M, rank ``d·M + m`` at ``(d, m)`` (the last axis
    fastest, as ``jax.make_mesh`` lays devices out), with a ``model``
    group a data row over gloo or NCCL. Each rank takes the card
    ``LOCAL_RANK`` (default 0) unless ``device`` is given; ``device='cpu'``
    runs on the CPU over gloo."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if dist.is_initialized():
        world = dist.get_world_size()
    m = int(model_parallel)
    if m < 1 or world % m:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the job's {world} rank(s)")
    return make_mesh((world // m, m), ("data", "model"), device=device)
