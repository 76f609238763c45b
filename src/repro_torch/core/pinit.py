"""Broadcast-free parallel parameter initialization (paper §III-B.1).

Each parameter leaf draws from its own ``torch.Generator`` seeded from
``(seed, crc32(path))``, so every process computes the identical
initializer with zero communication. The values differ from the JAX
package's threefry draws; tests carry the reference's params across
(``repro_torch.weights``) instead of comparing draws.
"""
from __future__ import annotations

import zlib

import torch

from repro_torch.models.common import PD
from repro_torch.tree import tree_flatten, tree_unflatten


def leaf_seed(seed: int, path: str) -> int:
    """Per-leaf generator seed from the run seed and the leaf's tree path."""
    return (seed * 2 ** 32 + zlib.crc32(path.encode())) % 2 ** 63


def _init_leaf(pd: PD, seed: int, device) -> torch.Tensor:
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=pd.dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=pd.dtype, device=device)
    if pd.init == "const":   # constant fill with value = pd.scale
        return torch.full(pd.shape, pd.scale, dtype=pd.dtype, device=device)
    if pd.init == "normal":
        # truncated normal in ±2σ, as in the paper's ResNet logs; drawn on
        # the CPU so a seed gives the same values on every device
        gen = torch.Generator().manual_seed(seed)
        x = torch.empty(pd.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (pd.scale * x).to(device=device, dtype=pd.dtype)
    raise ValueError(f"unknown init {pd.init!r}")


def materialize(tree, seed: int, device) -> dict:
    """Initialize every leaf of a ``PD`` tree on ``device``."""
    flat = tree_flatten(tree)
    return tree_unflatten(
        [p for p, _ in flat],
        [_init_leaf(pd, leaf_seed(seed, p), device) for p, pd in flat])
