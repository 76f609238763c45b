"""All-reduce schedules over the data-parallel mesh axes (a port of
``repro.comm.schedules``).

A *schedule* is ``fn(buf, axes, *, use_kernel=False) -> buf``: it takes one
flat bucket buffer and the ordered tuple of mesh axes (``launch.mesh.Axis``)
to reduce over, and returns the elementwise SUM over every rank of those
axes (callers divide for the mean). Outer axes come first (``(pod, data)``
on the 2-pod mesh), so ``axes[-1]`` is the innermost one, where the scatter
rings run.

Registered here:

  psum          one fused all-reduce per axis (``dist.all_reduce``; NCCL
                or gloo picks the algorithm). It reduces its buffer in
                place.
  ring          the bandwidth-optimal ring (reduce-scatter + all-gather
                over point-to-point sends) per axis, innermost first.
  hierarchical  Akiba-style (arXiv:1711.04325): ring reduce-scatter on
                ``shard_axis`` (the innermost non-trivial axis), one fused
                all-reduce of the 1/n shard across the other axes, ring
                all-gather back.
  2d_torus      Sony-style (arXiv:1811.05233): ring reduce-scatter on
                ``shard_axis``, ring all-reduce of the shard along each
                other axis, ring all-gather back.
  dbtree        double binary tree per axis (``primitives.tree_all_reduce``),
                innermost first.

``use_kernel=True`` swaps the reduce-scatter fold for the ring-step kernel
K3 (``comm.ring_kernel``), which needs CHUNK-aligned chunk rows: the ring
forms then pass ``pad_to=CHUNK``. The tree's fold is a plain add, so
``use_kernel`` is inert for psum and dbtree, as in the reference.

Each schedule has a reduce-scatter-terminal form (``@register_rs``) for the
sharded rungs: this rank's contiguous CHUNK-aligned 1/n shard of the summed
buffer, sharded over ``shard_axis(axes)`` under the ring layout
(``primitives.shard_index``) and already reduced over every other axis.
ring, hierarchical and 2d_torus stop at their native scatter; psum and
dbtree reduce fully, then keep their chunk. Summation order is part of the
contract: each all-reduce form scatters on the same axis, in the same
order, as its reduce-scatter form, so the replicated and sharded rungs of
one schedule sum alike.
"""
from __future__ import annotations

from repro_torch.comm import primitives as prim
from repro_torch.comm.registry import register, register_rs
from repro_torch.core.bucketing import CHUNK


def shard_axis(axes):
    """The axis the shards live on: the innermost axis of size > 1, so a
    trailing trivial axis (the local ``(data, model=1)`` mesh) neither
    stops the scatter from splitting the buffer nor collapses the
    hierarchy into a fused all-reduce."""
    for a in reversed(tuple(axes)):
        if a.size > 1:
            return a
    return tuple(axes)[-1]


def _step_fn(use_kernel: bool):
    if not use_kernel:
        return prim.default_step_fn, 1
    from repro_torch.comm.ring_kernel import kernel_step_fn
    return kernel_step_fn(), CHUNK


def _split(axes):
    intra = shard_axis(axes)
    rest = tuple(a for a in axes if a is not intra)
    return intra, rest


@register("psum")
def psum_schedule(buf, axes, *, use_kernel: bool = False):
    return prim.psum(buf, tuple(axes))


@register("ring")
def ring_schedule(buf, axes, *, use_kernel: bool = False):
    step_fn, pad_to = _step_fn(use_kernel)
    for axis in reversed(tuple(axes)):   # innermost (fastest) axis first
        buf = prim.ring_all_reduce(buf, axis, step_fn=step_fn, pad_to=pad_to)
    return buf


@register("hierarchical")
def hierarchical_schedule(buf, axes, *, use_kernel: bool = False):
    intra, rest = _split(axes)
    step_fn, pad_to = _step_fn(use_kernel)
    shard, n = prim.ring_reduce_scatter(buf, intra, step_fn=step_fn,
                                        pad_to=pad_to)
    shard = prim.psum(shard, rest)
    return prim.ring_all_gather(shard, intra, n)


@register("dbtree")
def dbtree_schedule(buf, axes, *, use_kernel: bool = False):
    for axis in reversed(tuple(axes)):
        buf = prim.tree_all_reduce(buf, axis)
    return buf


@register("2d_torus")
def torus_schedule(buf, axes, *, use_kernel: bool = False):
    intra, rest = _split(axes)
    step_fn, pad_to = _step_fn(use_kernel)
    shard, n = prim.ring_reduce_scatter(buf, intra, step_fn=step_fn,
                                        pad_to=pad_to)
    for axis in reversed(rest):
        shard = prim.ring_all_reduce(shard, axis, step_fn=step_fn,
                                     pad_to=pad_to)
    return prim.ring_all_gather(shard, intra, n)


# --------------------------------------------------------------------------
# reduce-scatter-terminal forms (the sharded rungs)
#
# Contract: fn(buf, axes, *, use_kernel) -> shard, this rank's contiguous
# CHUNK-aligned 1/n slice of the summed buffer (n = size of
# shard_axis(axes), ring layout: rank r owns chunk (r+1)%n), already
# reduced over every other axis, so that
# ``primitives.ring_all_gather(shard, shard_axis, L)`` rebuilds the full
# buffer from the shard axis alone.

@register_rs("psum")
def psum_reduce_scatter(buf, axes, *, use_kernel: bool = False):
    """No native scatter: one fused all-reduce, keep the owned chunk."""
    buf = prim.psum(buf, tuple(axes))
    return prim.slice_own_chunk(buf, shard_axis(axes), pad_to=CHUNK)


@register_rs("ring")
@register_rs("2d_torus")
def ring_reduce_scatter_schedule(buf, axes, *, use_kernel: bool = False):
    """Native: ring reduce-scatter on the shard axis, ring all-reduce of
    the 1/n shard along the remaining axes. This is also the torus
    all-reduce's scatter phase, so 2d_torus registers it too."""
    intra, rest = _split(axes)
    step_fn, pad_to = _step_fn(use_kernel)
    shard, _ = prim.ring_reduce_scatter(buf, intra, step_fn=step_fn,
                                        pad_to=max(pad_to, CHUNK))
    for axis in reversed(rest):
        shard = prim.ring_all_reduce(shard, axis, step_fn=step_fn,
                                     pad_to=pad_to)
    return shard


@register_rs("hierarchical")
def hierarchical_reduce_scatter(buf, axes, *, use_kernel: bool = False):
    """Ring reduce-scatter within the shard axis, fused all-reduce of the
    shard across the outer axes (the hierarchical schedule minus its
    all-gather)."""
    intra, rest = _split(axes)
    step_fn, pad_to = _step_fn(use_kernel)
    shard, _ = prim.ring_reduce_scatter(buf, intra, step_fn=step_fn,
                                        pad_to=max(pad_to, CHUNK))
    return prim.psum(shard, rest)


@register_rs("dbtree")
def dbtree_reduce_scatter(buf, axes, *, use_kernel: bool = False):
    """The tree has no scatter form: the full double-binary-tree
    all-reduce per axis, then keep the owned chunk."""
    for axis in reversed(tuple(axes)):
        buf = prim.tree_all_reduce(buf, axis)
    return prim.slice_own_chunk(buf, shard_axis(axes), pad_to=CHUNK)
