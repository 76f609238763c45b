"""Plain PyTorch versions of the port's kernels.

Each kernel wrapper runs these for a tensor that lies on the
CPU, and ``chip_smoke.py`` and the GPU tests hold each kernel against them
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.bucketing import CHUNK


def batched_sumsq(flat, seg_ids, n_tensors: int):
    """flat: (n_chunks*CHUNK,) ; seg_ids: (n_chunks,) integer.
    Returns (n_tensors,) f32 sum of squares per segment; chunks whose id
    lies outside [0, n_tensors) are dropped, as ``segment_sum`` does."""
    x = flat.reshape(-1, CHUNK).float()
    per_chunk = (x * x).sum(dim=-1)
    seg = seg_ids.long()
    keep = (seg >= 0) & (seg < n_tensors)
    out = torch.zeros(n_tensors, dtype=torch.float32, device=flat.device)
    return out.index_add_(0, seg[keep], per_chunk[keep])


def lars_packed_update(p, g, m, trust, seg_ids, *, lr, momentum, wd):
    """Flat packed LARS step. p/g/m: (n_chunks*CHUNK,) f32 (g may be
    bf16); trust: (n_tensors,) f32; seg_ids: (n_chunks,) integer; ``lr`` a
    float or 0-d tensor. Returns new (p, m), with the reference's
    association ``m2 = momentum*m + (lr*t)*g``."""
    t = trust[seg_ids.long()].repeat_interleave(CHUNK)
    if isinstance(lr, torch.Tensor):
        lr = lr.to(device=p.device, dtype=torch.float32)
    g = g.float() + wd * p
    m2 = momentum * m + (lr * t) * g
    return p - m2, m2
