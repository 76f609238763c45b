"""Mixed-precision policy (paper §IV): compute in bf16, keep master weights
and the optimizer update in fp32 (bf16 needs no loss scaling)."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def cast_to_compute(params, dtype=torch.bfloat16):
    """Cast fp32 parameter leaves to the compute dtype (fwd/bwd pass);
    other leaves pass through unchanged."""
    def f(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(dtype)
        return x
    return tree_map(f, params)
