"""Mixed-precision policy (paper §IV): compute in bf16, keep master weights
and the optimizer update in fp32 (bf16 needs no loss scaling)."""
from __future__ import annotations

import torch

from repro_torch.tree import lazy_map


def cast_to_compute(params, dtype=torch.bfloat16):
    """Cast fp32 parameter leaves to the compute dtype (fwd/bwd pass);
    other leaves pass through unchanged. A ``tree.LazyTree`` (the overlap
    wrap's) gives a lazy tree: each leaf is cast when the forward first
    reads it, just after its group's identity is made there, so the
    identity still receives the f32 cotangent and runs as soon as its
    group's cotangents exist."""
    def f(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(dtype)
        return x
    return lazy_map(f, params)
