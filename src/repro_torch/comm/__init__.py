"""Collective-schedule subsystem (paper §III-C): gradient all-reduce
decomposed into schedules over the mesh's data-parallel axes, each with a
reduce-scatter-terminal form for the sharded rungs. A port of
``repro.comm``: every schedule of the reference (psum, ring, hierarchical,
2d_torus, dbtree, and the ``bucketed`` alias), with the ring-step fold
kernel K3 (``comm.ring_kernel``). The cost model, the autotuner and the
serialisable CommPlan are ROADMAP §1 item 7.
"""
from typing import Sequence

from repro_torch.comm.registry import (  # noqa: F401
    available, get_reduce_scatter, get_schedule)


def shard_axis_size(axes: Sequence[str], sizes: Sequence[int]):
    """(axis, size) the sharded-update path scatters over: the innermost
    non-trivial axis, as ``schedules.shard_axis`` picks it."""
    for a, s in zip(reversed(tuple(axes)), reversed(tuple(sizes))):
        if s > 1:
            return a, s
    return tuple(axes)[-1], tuple(sizes)[-1]
