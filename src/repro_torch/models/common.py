"""Parameter descriptors and the LM's shared numerics.

Parameters are described abstractly first (``PD``: shape, dtype,
initializer) and materialized by ``repro_torch.core.pinit`` — the basis of
the paper's §III-B.1 broadcast-free initialization: every process derives
the same per-leaf seed from the tree path and a shared seed. The JAX
package's descriptor also carries a PartitionSpec; the port's single-device
slice has no use for one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class PD:
    """Abstract parameter descriptor (a tree leaf)."""
    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | const
    scale: float = 0.02
    dtype: torch.dtype = torch.float32


def pd_stack(tree, n: int):
    """Add a leading layer dim of size n to every descriptor (the stacked
    layers of an LM, which the port walks with a Python loop)."""
    return tree_map(lambda pd: dataclasses.replace(pd, shape=(n, *pd.shape)),
                    tree)


def dense_pd(d_in: int, d_out: int, *, scale: Optional[float] = None) -> PD:
    if scale is None:
        scale = d_in ** -0.5
    return PD((d_in, d_out), init="normal", scale=scale)


# ---------------------------------------------------------------------------
# numerics (the JAX package's rounding: f32 inside, back to x's dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split (not interleaved) rotation with f32
    angles. x: (..., S, H, Dh); positions: (..., S) integers."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs      # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]              # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask_block(qpos, kpos, window: int = 0):
    """(Q, K) boolean mask (True = attend) for absolute positions."""
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def attention_mask(qpos, kpos, causal: bool, window: int = 0):
    """(Q, K) boolean mask (True = attend) of a causal and/or windowed
    (window > 0) attention at absolute positions."""
    if causal:
        return causal_mask_block(qpos, kpos, window)
    return kpos[None, :] > (qpos[:, None] - window)
