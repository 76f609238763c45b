"""The data-parallel "mesh" of the port: named axes over a
``torch.distributed`` process group (a port of ``repro.launch.mesh``).

The reference's mesh is a ``jax.sharding.Mesh`` whose named axes the
collectives address inside ``shard_map``. Here every process is one rank,
and an :class:`Axis` carries what a collective along it needs: its size,
this rank's index on it, the global ranks of its members and the process
group. This slice supports one data axis plus the reference's trailing
size-1 ``model`` axis (the ``(data, model=1)`` local mesh); the 2-pod
``(pod, data)`` mesh comes with the hierarchical schedules (ROADMAP §1
item 6).

The process group is built from ``RANK`` / ``WORLD_SIZE`` (``torchrun``,
with ``MASTER_ADDR`` / ``MASTER_PORT``) or, with neither set, for one
process (an in-memory store; no port is opened). NCCL serves CUDA, gloo
the CPU.
"""
from __future__ import annotations

import dataclasses
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


def make_local_mesh(model_parallel: int = 1, *,
                    device: Optional[str] = None) -> Mesh:
    """Mesh over every rank of the job: ``(data=world, model=1)``. Each
    rank takes the card ``LOCAL_RANK`` (default 0) unless ``device`` is
    given; ``device='cpu'`` runs on the CPU over gloo."""
    if model_parallel != 1:
        raise NotImplementedError(
            "model parallelism is not ported to repro_torch yet (ROADMAP §1 "
            "item 6)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owns = _init_group(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    data = Axis("data", world, rank, tuple(range(world)), dist.group.WORLD)
    model = Axis("model", 1, 0, (rank,), None)
    return Mesh((data, model), dev, owns)
