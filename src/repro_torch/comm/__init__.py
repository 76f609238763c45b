"""Collective-schedule subsystem (paper §III-C): gradient all-reduce
decomposed into schedules over the mesh's data-parallel axes, each with a
reduce-scatter-terminal form for the ZeRO-1 path. A port of
``repro.comm``; this slice has the ``psum`` and ``ring`` schedules (and
the ``bucketed`` alias). The hierarchical, 2d_torus and dbtree schedules,
the cost model, the autotuner and the serialisable CommPlan are ROADMAP
§1 items 6 and 7.
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
