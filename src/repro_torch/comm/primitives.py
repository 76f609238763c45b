"""Ring collective primitives over point-to-point sends (a port of
``repro.comm.primitives``).

Every schedule in ``repro_torch.comm.schedules`` is built from these, on
flat 1-D buffers, along one mesh axis (``launch.mesh.Axis``):

  ring_reduce_scatter  n-1 shift-and-add steps; rank r ends holding the
                       fully reduced chunk ``(r+1) % n`` of the buffer.
  ring_all_gather      n-1 shift-and-deposit steps; the inverse layout
                       walk rebuilds the full buffer from per-rank chunks.
  ring_all_reduce      reduce-scatter + all-gather, the bandwidth-optimal
                       ring (2(n-1) messages of B/n).
  tree_all_reduce      two mirrored binomial trees, each reducing and
                       broadcasting half the buffer (the dbtree schedule).

Chunk convention, as the reference's: the buffer is zero-padded to
``n * c`` elements and viewed as ``(n, c)`` chunk rows. At reduce-scatter
step ``s`` rank ``r`` sends its partial sum of chunk ``(r - s) % n`` to
``r + 1`` and folds the one it receives into chunk ``(r - 1 - s) % n``.
The fold is ``step_fn`` (``default_step_fn``, or the ring-step kernel K3,
``comm.ring_kernel``). The neighbour exchange is one
``dist.batch_isend_irecv`` (send right, receive left), so the same code
runs on gloo and NCCL; a tree level posts only the sends and receives of
its own edges.

A size-1 axis returns the input unchanged, so schedules compose over
meshes with trivial axes (the local ``(data, model=1)`` mesh). ``psum`` is
the fused all-reduce (``dist.all_reduce``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_flatten, tree_unflatten


def axes_size(axes) -> int:
    """Product of the sizes of several mesh axes."""
    n = 1
    for a in axes:
        n *= a.size
    return n


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum ``x`` over every rank of ``axes``, IN PLACE (callers hand a
    buffer they own), one ``all_reduce`` per axis that a process group
    spans; returns ``x``."""
    for a in axes:
        if a.group is not None:
            dist.all_reduce(x, group=a.group)
    return x


def pmean_tree(tree, axes):
    """Mean of a dict tree of tensors over ``axes`` in ONE all-reduce: the
    leaves are packed into a flat f32 buffer and split back into their
    own dtypes and shapes."""
    flat = tree_flatten(tree)
    leaves = [x for _, x in flat]
    buf = torch.cat([x.detach().reshape(-1).float() for x in leaves])
    buf = psum(buf, axes) / axes_size(axes)
    out = [piece.reshape(x.shape).to(x.dtype) for piece, x in
           zip(buf.split([x.numel() for x in leaves]), leaves)]
    return tree_unflatten([p for p, _ in flat], out)


def _ppermute(x: torch.Tensor, axis) -> torch.Tensor:
    """Send ``x`` to the next rank on the axis, receive the previous
    rank's (the reference's ``ppermute`` over ``(i, (i+1) % n)``)."""
    n, i = axis.size, axis.index
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, axis.ranks[(i + 1) % n], axis.group),
           dist.P2POp(dist.irecv, out, axis.ranks[(i - 1) % n], axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def default_step_fn(recv, chunks, k):
    """Fold the received partial into local chunk ``k``: recv + chunks[k]."""
    return recv + chunks[k]


def _as_chunks(x, n, pad_to: int = 1):
    """View 1-D ``x`` as (n, c) zero-padded chunk rows; c % pad_to == 0."""
    L = x.shape[0]
    c = -(-L // (n * pad_to)) * pad_to
    if n * c != L:
        x = torch.nn.functional.pad(x, (0, n * c - L))
    return x.reshape(n, c)


def ring_reduce_scatter(x, axis, *, step_fn=None, pad_to: int = 1):
    """Returns (shard, orig_len): rank r holds the summed chunk (r+1)%n."""
    n = axis.size
    L = x.shape[0]
    if n == 1:
        return x, L
    step_fn = step_fn or default_step_fn
    r = axis.index
    chunks = _as_chunks(x, n, pad_to)
    acc = chunks[r]
    for s in range(n - 1):
        acc = _ppermute(acc, axis)
        acc = step_fn(acc, chunks, (r - 1 - s) % n)
    return acc, L


def ring_all_gather(shard, axis, orig_len: int):
    """Inverse of ``ring_reduce_scatter``'s layout: rebuild the flat buffer
    (rank r starts holding chunk (r+1)%n), truncated to ``orig_len``."""
    n = axis.size
    if n == 1:
        return shard
    r = axis.index
    out = shard.new_zeros((n,) + tuple(shard.shape))
    out[(r + 1) % n] = shard
    cur = shard
    for t in range(1, n):
        cur = _ppermute(cur, axis)
        out[(r - t + 1) % n] = cur
    return out.reshape(-1)[:orig_len]


def ring_all_reduce(x, axis, *, step_fn=None, pad_to: int = 1):
    """Bandwidth-optimal single-axis ring all-reduce (sum)."""
    shard, L = ring_reduce_scatter(x, axis, step_fn=step_fn, pad_to=pad_to)
    return ring_all_gather(shard, axis, L)


def shard_index(axis) -> int:
    """Which chunk of an ``n``-chunked buffer this rank owns under the ring
    reduce-scatter layout: ``(r + 1) % n``."""
    n = axis.size
    if n == 1:
        return 0
    return (axis.index + 1) % n


def slice_own_chunk(x, axis, *, pad_to: int = 1):
    """Reduce-scatter tail for schedules without a native scatter (psum,
    dbtree, hierarchical's fallback):
    view the already fully reduced buffer as ``(n, c)`` chunk rows and
    keep the chunk this rank owns under the ring layout."""
    n = axis.size
    if n == 1:
        return x
    return _as_chunks(x, n, pad_to)[shard_index(axis)]


# --------------------------------------------------------------------------
# binomial trees (the dbtree schedule's building block)

def tree_edges(n: int):
    """Binomial-tree edges rooted at rank 0, as per-level (child, parent)
    pair lists, leaves first. Level ``l`` pairs every rank whose lowest set
    bit is ``l`` with that bit cleared, so every rank sends once and rank 0
    holds the full reduction after ``ceil(log2 n)`` levels. Any ``n``:
    non-powers of two have sparser levels."""
    levels, step = [], 1
    while step < n:
        levels.append([(s, s - step) for s in range(step, n, 2 * step)])
        step *= 2
    return levels


def _exchange(sends, axis):
    """One batch of point-to-point messages along ``axis``: ``sends`` are
    (tensor, dst index, src index) of the edges this rank takes part in;
    the tensor is sent where this rank is the source, and a buffer shaped
    like it receives where this rank is the destination. Returns the
    received buffers, ``None`` for the edges this rank sends on. A rank on
    no edge posts nothing."""
    me, ops, out = axis.index, [], []
    for x, dst, src in sends:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  axis.ranks[dst], axis.group))
            out.append(None)
        else:
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[src],
                                  axis.group))
            out.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def tree_all_reduce(x, axis):
    """Double-binary-tree all-reduce (sum) along one axis (NCCL lineage):
    tree A (rooted at rank 0) reduces and broadcasts the first half of the
    buffer, its rank-mirrored twin B (rooted at n-1) the second, so the
    critical path is ``2*ceil(log2 n)`` messages of B/2. A reducing parent
    adds what its child sends; everyone else keeps its value. In the
    broadcast a child takes its parent's value; everyone else keeps its
    own (the reference's ``jnp.where`` masks select exactly the
    receivers). Both trees' edges of a level go in one batch."""
    n = axis.size
    if n == 1:
        return x
    r = axis.index
    levels = tree_edges(n)
    h = -(-x.shape[0] // 2)
    halves = [x[:h], x[h:]]             # tree A: ranks as-is; B: mirrored

    def level(pairs, down):
        sends, owners = [], []
        for i, half in enumerate(halves):
            if half.numel() == 0:
                continue
            for c, p in pairs:
                src, dst = (p, c) if down else (c, p)
                if i == 1:
                    src, dst = n - 1 - src, n - 1 - dst
                if r in (src, dst):
                    sends.append((half, dst, src))
                    owners.append(i)
        for i, got in zip(owners, _exchange(sends, axis)):
            if got is not None:
                halves[i] = got if down else halves[i] + got

    for pairs in levels:                 # reduce toward the roots
        level(pairs, down=False)
    for pairs in reversed(levels):       # broadcast back down
        level(pairs, down=True)
    return torch.cat(halves)
