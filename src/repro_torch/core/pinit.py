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
"""
from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.models.common import PD
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


def _init_leaf(pd: PD, seed: int, device, dtype=None) -> torch.Tensor:
    """One leaf on ``device``; an f32 leaf is made in ``dtype`` if given,
    with the values of the f32 leaf's cast, bit for bit."""
    dt = dtype if dtype is not None and pd.dtype == torch.float32 \
        else pd.dtype
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    if pd.init == "const":   # constant fill with value = pd.scale
        return torch.full(pd.shape, pd.scale, dtype=dt, device=device)
    if pd.init == "normal":
        # truncated normal in ±2σ, as in the paper's ResNet logs; drawn on
        # the CPU so a seed gives the same values on every device
        gen = torch.Generator().manual_seed(seed)
        x = torch.empty(pd.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        x.mul_(pd.scale)
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


def materialize(tree, seed: int, device, dtype=None, sink=None):
    """Initialize every leaf of a ``PD`` tree on ``device``. ``dtype``
    (serving: bf16) makes the f32 leaves in that dtype, one leaf at a time,
    so the f32 tree never exists; the values equal its cast bit for
    bit. ``sink(path, leaf)``, given, takes each leaf as it is made (from
    the drawing threads, a leaf once) and nothing is kept: returns
    None."""
    flat = tree_flatten(tree)
    nbytes = [4 * torch.Size(pd.shape).numel() if pd.init == "normal" else 0
              for _, pd in flat]
    free = [max(int(HOST_SHARE * _host_free_bytes()), max(nbytes, default=0))]
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
    if sink is None:
        return tree_unflatten([p for p, _ in flat], leaves)
