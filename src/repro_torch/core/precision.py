"""Mixed-precision policy (paper §IV): compute in bf16, keep master weights
and the optimizer update in fp32 (bf16 needs no loss scaling)."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.tree import lazy_map

#: the forward and backward's compute dtype; ``f32_compute`` sets f32
_COMPUTE = torch.bfloat16


def compute_dtype() -> torch.dtype:
    return _COMPUTE


@contextlib.contextmanager
def f32_compute():
    """Within it the models compute in f32: ``cast_to_compute`` keeps the
    f32 masters and an LM's embedding rows stay f32
    (``transformer._embed``), so on f32 params an LM runs wholly in f32,
    forward and backward: the form in which two implementations differ
    only by the order of f32 sums, which the parity checks hold tightly
    where bf16 roundings would hide a fault."""
    global _COMPUTE
    before, _COMPUTE = _COMPUTE, torch.float32
    try:
        yield
    finally:
        _COMPUTE = before


def cast_to_compute(params, dtype=None):
    """Cast fp32 parameter leaves to the compute dtype (fwd/bwd pass; by
    default ``compute_dtype()``); other leaves pass through unchanged. A
    ``tree.LazyTree`` (the overlap wrap's) gives a lazy tree: each leaf is
    cast when the forward first reads it, just after its group's identity
    is made there, so the identity still receives the f32 cotangent and
    runs as soon as its group's cotangents exist."""
    dtype = dtype or _COMPUTE

    def f(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(dtype)
        return x
    return lazy_map(f, params)
