"""All-reduce schedules over the data-parallel mesh axes (a port of
``repro.comm.schedules``).

A *schedule* is ``fn(buf, axes, *, use_kernel=False) -> buf``: it takes one
flat bucket buffer and the ordered tuple of mesh axes (``launch.mesh.Axis``)
to reduce over, and returns the elementwise SUM over every rank of those
axes (callers divide for the mean). Outer axes come first, so ``axes[-1]``
is the innermost one, where the scatter rings run.

Registered here:

  psum  one fused all-reduce over all axes (``dist.all_reduce``; NCCL or
        gloo picks the algorithm). It reduces its buffer in place.
  ring  the bandwidth-optimal ring (reduce-scatter + all-gather over
        point-to-point sends) per axis, innermost first.

Each has a reduce-scatter-terminal form (``@register_rs``) for the ZeRO-1
path: this rank's contiguous CHUNK-aligned 1/n shard of the summed buffer,
sharded over ``shard_axis(axes)`` under the ring layout
(``primitives.shard_index``). ring stops at its native scatter; psum
reduces fully, then keeps its chunk.

The hierarchical, 2d_torus and dbtree schedules are ROADMAP §1 item 6, and
so is ``use_kernel=True``: the ring-step fold kernel (K3) is reached only
by a ring across two or more cards.
"""
from __future__ import annotations

from repro_torch.comm import primitives as prim
from repro_torch.comm.registry import register, register_rs
from repro_torch.core.bucketing import CHUNK


def shard_axis(axes):
    """The axis the ZeRO-1 shards live on: the innermost axis of size > 1,
    so a trailing trivial axis (the local ``(data, model=1)`` mesh) does
    not stop the scatter from splitting the buffer."""
    for a in reversed(tuple(axes)):
        if a.size > 1:
            return a
    return tuple(axes)[-1]


def _step_fn(use_kernel: bool):
    if not use_kernel:
        return prim.default_step_fn, 1
    raise NotImplementedError(
        "the ring-step fold kernel K3 (repro/comm/ring_kernel.py::"
        "ring_add_step, CommConfig.use_kernel) is not ported to repro_torch "
        "yet (ROADMAP §1 item 6)")


@register("psum")
def psum_schedule(buf, axes, *, use_kernel: bool = False):
    return prim.psum(buf, tuple(axes))


@register("ring")
def ring_schedule(buf, axes, *, use_kernel: bool = False):
    step_fn, pad_to = _step_fn(use_kernel)
    for axis in reversed(tuple(axes)):   # innermost (fastest) axis first
        buf = prim.ring_all_reduce(buf, axis, step_fn=step_fn, pad_to=pad_to)
    return buf


# --------------------------------------------------------------------------
# reduce-scatter-terminal forms (ZeRO-1 sharded-update path)
#
# Contract: fn(buf, axes, *, use_kernel) -> shard, this rank's contiguous
# CHUNK-aligned 1/n slice of the summed buffer (n = size of
# shard_axis(axes), ring layout: rank r owns chunk (r+1)%n), already
# reduced over every other axis.

def _rs_split(axes):
    intra = shard_axis(axes)
    rest = tuple(a for a in axes if a is not intra)
    return intra, rest


@register_rs("psum")
def psum_reduce_scatter(buf, axes, *, use_kernel: bool = False):
    """No native scatter: one fused all-reduce, keep the owned chunk."""
    buf = prim.psum(buf, tuple(axes))
    return prim.slice_own_chunk(buf, shard_axis(axes), pad_to=CHUNK)


@register_rs("ring")
def ring_reduce_scatter_schedule(buf, axes, *, use_kernel: bool = False):
    """Native: ring reduce-scatter on the shard axis, ring all-reduce of
    the 1/n shard along the remaining axes."""
    intra, rest = _rs_split(axes)
    step_fn, pad_to = _step_fn(use_kernel)
    shard, _ = prim.ring_reduce_scatter(buf, intra, step_fn=step_fn,
                                        pad_to=max(pad_to, CHUNK))
    for axis in reversed(rest):
        shard = prim.ring_all_reduce(shard, axis, step_fn=step_fn,
                                     pad_to=pad_to)
    return shard
