"""Broadcast-free parallel parameter initialization (paper §III-B.1).

Each parameter leaf draws from its own ``torch.Generator`` seeded from
``(seed, crc32(path))``, so every process computes the identical
initializer with zero communication. The values differ from the JAX
package's threefry draws; tests carry the reference's params across
(``repro_torch.weights``) instead of comparing draws.

A leaf is one draw on the host, in f32; leaves are drawn in threads,
largest first, as far as a budget of host memory allows (each has its own
generator, so the values do not depend on the order). ``dtype`` makes the
f32 leaves in another dtype (serving: bf16), each cast as it is copied to
the device, so the f32 tree never exists: a 15 B-param MoE's f32 tree
would not fit on the card beside its bf16 cast.

Over a mesh's model axis (``mesh``; ROADMAP §1 item 6.2) a rank keeps only
its shard of each split leaf, equal bit for bit to the whole leaf's slice:
a leaf's draw is one sequence of its generator, so each split leaf drawn
at random is drawn once a model group, on the host of the rank that owns
it (the leaves taken largest first, rank after rank), and scattered over
the group a chunk of rows at a time; data replicas draw their own, with
no broadcast. The rest (replicated leaves, constant fills) each rank
makes itself. The host's budget is shared by the processes of one host
(``LOCAL_WORLD_SIZE``, as ``torchrun`` sets it), and an owner takes it
for its leaves in their order, so four ranks on one host draw
qwen1.5-32b's 141 GB of f32 leaves with at most a budget's worth held.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from repro_torch.models.common import PD, local_shape, local_slice, \
    model_axis
from repro_torch.tree import tree_flatten, tree_unflatten

#: elements cast and copied to the device at a time
CHUNK = 1 << 26
#: draws in flight at most, and the share of the host's free memory their
#: f32 buffers may hold together (at least the largest leaf's)
WORKERS = 8
HOST_SHARE = 0.6


def leaf_seed(seed: int, path: str) -> int:
    """Per-leaf generator seed from the run seed and the leaf's tree path."""
    return (seed * 2 ** 32 + zlib.crc32(path.encode())) % 2 ** 63


def _dtype(pd: PD, dtype):
    return dtype if dtype is not None and pd.dtype == torch.float32 \
        else pd.dtype


def _draw(pd: PD, seed: int) -> torch.Tensor:
    """The whole leaf's f32 values on the host: a truncated normal in ±2σ,
    as in the paper's ResNet logs, drawn on the CPU so a seed gives the
    same values on every device."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.empty(pd.shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(pd.scale)


def _init_leaf(pd: PD, seed: int, device, dtype=None) -> torch.Tensor:
    """One leaf on ``device``; an f32 leaf is made in ``dtype`` if given,
    with the values of the f32 leaf's cast, bit for bit."""
    dt = _dtype(pd, dtype)
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    if pd.init == "const":   # constant fill with value = pd.scale
        return torch.full(pd.shape, pd.scale, dtype=dt, device=device)
    if pd.init == "normal":
        x = _draw(pd, seed)
        if torch.device(device).type == "cpu" and dt == torch.float32:
            return x
        # cast and copy a chunk at a time: no second host buffer
        out = torch.empty(pd.shape, dtype=dt, device=device)
        src, dst = x.view(-1), out.view(-1)
        for lo in range(0, src.numel(), CHUNK):
            dst[lo:lo + CHUNK].copy_(src[lo:lo + CHUNK])
        return out
    raise ValueError(f"unknown init {pd.init!r}")


def _host_free_bytes() -> int:
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return 0


def _host_budget(largest: int) -> int:
    """Bytes of f32 draws this process may hold at once: its share of the
    host's free memory (split between the host's processes), at least the
    largest leaf's."""
    procs = max(int(os.environ.get("LOCAL_WORLD_SIZE", 1)), 1)
    return max(int(HOST_SHARE * _host_free_bytes()) // procs, largest)


def _nbytes(pd: PD) -> int:
    return 4 * torch.Size(pd.shape).numel() if pd.init == "normal" else 0


def materialize(tree, seed: int, device, dtype=None, sink=None, mesh=None):
    """Initialize every leaf of a ``PD`` tree on ``device``. ``dtype``
    (serving: bf16) makes the f32 leaves in that dtype, one leaf at a time,
    so the f32 tree never exists; the values equal its cast bit for
    bit. ``sink(path, leaf)``, given, takes each leaf as it is made (from
    the drawing threads, a leaf once) and nothing is kept: returns
    None. ``mesh``: make this rank's shards over its model axis (see the
    module's docstring); every rank of the mesh must call it alike."""
    flat = tree_flatten(tree)
    paths = [p for p, _ in flat]
    tp = model_axis(mesh)
    if tp is None:
        leaves = _make(flat, seed, device, dtype, sink)
        return None if sink is not None else tree_unflatten(paths, leaves)
    if sink is not None:
        raise ValueError("materialize: sink= and a model axis together")
    scattered = [i for i, (_, pd) in enumerate(flat)
                 if pd.init == "normal" and local_slice(pd, tp)[0] is not None]
    own = [i for i in range(len(flat)) if i not in scattered]
    leaves = dict(zip(own, _make(
        [(flat[i][0], dataclasses.replace(flat[i][1],
                                          shape=local_shape(flat[i][1], tp)))
         for i in own], seed, device, dtype, None)))
    leaves.update(_scatter_leaves(flat, scattered, seed, device, dtype, tp))
    return tree_unflatten(paths, [leaves[i] for i in range(len(flat))])


def _make(flat, seed, device, dtype, sink):
    """Each (path, descriptor) of ``flat`` made on this rank, in threads,
    largest first, within the host's budget: the leaves in ``flat``'s
    order (None each with a ``sink``)."""
    nbytes = [_nbytes(pd) for _, pd in flat]
    free = [_host_budget(max(nbytes, default=0))]
    cv = threading.Condition()
    leaves = [None] * len(flat)

    def make(i):
        with cv:                      # hold the leaf's f32 bytes
            cv.wait_for(lambda: free[0] >= nbytes[i])
            free[0] -= nbytes[i]
        try:
            path, pd = flat[i]
            leaf = _init_leaf(pd, leaf_seed(seed, path), device, dtype)
            if sink is None:
                leaves[i] = leaf
            else:
                sink(path, leaf)
        finally:
            with cv:
                free[0] += nbytes[i]
                cv.notify_all()

    order = sorted(range(len(flat)), key=lambda i: -nbytes[i])
    with ThreadPoolExecutor(max_workers=WORKERS) as ex:
        for f in [ex.submit(make, i) for i in order]:
            f.result()
    return leaves


def _scatter_leaves(flat, idx, seed, device, dtype, tp):
    """The split leaves ``idx`` of ``flat`` drawn at random: each drawn
    whole on its owner's host (the j-th largest by model rank j mod M),
    in threads that take the host's budget in the leaves' order, and
    scattered over the model group in that order, a chunk of rows of the
    local shard at a time. Returns {index: this rank's shard}."""
    order = sorted(idx, key=lambda i: -_nbytes(flat[i][1]))
    mine = [i for j, i in enumerate(order) if j % tp.size == tp.index]
    nbytes = {i: _nbytes(flat[i][1]) for i in mine}
    free = [_host_budget(max(nbytes.values(), default=0))]
    turn = [0]
    cv = threading.Condition()

    def draw(k, i):
        with cv:                      # in order, so the scatters progress
            cv.wait_for(lambda: turn[0] == k and free[0] >= nbytes[i])
            free[0] -= nbytes[i]
            turn[0] += 1
            cv.notify_all()
        path, pd = flat[i]
        return _draw(pd, leaf_seed(seed, path))

    out = {}
    with ThreadPoolExecutor(max_workers=WORKERS) as ex:
        futs = {i: ex.submit(draw, k, i) for k, i in enumerate(mine)}
        for j, i in enumerate(order):
            pd = flat[i][1]
            shard = torch.empty(local_shape(pd, tp), dtype=_dtype(pd, dtype),
                                device=device)
            x = futs.pop(i).result() if i in futs else None
            _scatter(x, shard, local_slice(pd, tp), tp,
                     tp.ranks[j % tp.size])
            if x is not None:
                del x
                with cv:
                    free[0] += nbytes[i]
                    cv.notify_all()
            out[i] = shard
    return out


def _scatter(x, shard, where, tp, src: int):
    """Rank ``src``'s whole leaf ``x`` (None elsewhere) over the model
    group: each rank's slice ``where`` (dim, start, length) into its
    ``shard``, a chunk of its leading rows at a time (each cast and copied
    to the device there)."""
    d, _, k = where
    row = max(shard[0].numel(), 1) if shard.dim() else 1
    step = max(CHUNK // row, 1)
    for lo in range(0, shard.shape[0], step):
        hi = min(lo + step, shard.shape[0])
        parts = None
        if x is not None:
            parts = [x.narrow(d, r * k, k)[lo:hi].to(
                device=shard.device, dtype=shard.dtype).contiguous()
                for r in range(tp.size)]
        dist.scatter(shard[lo:hi], parts, src=src, group=tp.group)
