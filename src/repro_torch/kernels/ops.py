"""Public wrappers around the port's kernels.

Each wrapper chooses by the tensor's device: the plain PyTorch version
(``kernels/ref``) for a CPU tensor, the hand-written kernel for a CUDA
tensor (or an error).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import bucketing
from repro_torch.kernels.batched_norm import batched_sumsq  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lars_update import lars_packed_update  # noqa: F401
from repro_torch.kernels.smoothed_xent import smoothed_xent_rows  # noqa: F401
from repro_torch.models.common import PD
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@functools.lru_cache(maxsize=16)
def _segment_ids(plan: bucketing.BucketPlan, device: torch.device):
    """The plan's segment map on ``device``, uploaded once per plan."""
    return torch.from_numpy(bucketing.segment_ids(plan)).to(device)


@functools.lru_cache(maxsize=16)
def _plan_for(signature) -> bucketing.BucketPlan:
    paths, shapes = zip(*signature)
    return bucketing.make_plan(tree_unflatten(paths, [PD(s) for s in shapes]))


def tree_sumsq(tree, *, plan=None):
    """Per-tensor sums of squares of a tree through ONE batched-norm
    launch (paper §III-B.2). Returns a tree of 0-d f32 tensors matching
    ``tree``. Without a ``plan`` the JAX package's default plan is used
    (4 MB buckets), built once per tree signature."""
    if plan is None:
        plan = _plan_for(tuple((p, tuple(x.shape))
                               for p, x in tree_flatten(tree)))
    flat = bucketing.pack_flat(tree, plan, dtype=torch.float32)
    seg = _segment_ids(plan, flat.device)
    sq = batched_sumsq(flat, seg, plan.n_tensors)
    # packing order is the reverse flatten order
    return tree_unflatten(plan.paths, list(sq.unbind())[::-1])


def tree_norms(tree, *, plan=None):
    """Per-tensor L2 norms of a tree: ``tree_sumsq``'s square roots."""
    return tree_map(torch.sqrt, tree_sumsq(tree, plan=plan))


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """(B, S, H, Dk) / (B, S, K, D*) layout wrapper around the flash kernel.
    Returns (B, Sq, H, Dv) (a transposed view of the kernel's output)."""
    B, Sq, H, Dk = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    qf = q.transpose(1, 2).contiguous().view(B * H, Sq, Dk)
    kf = k.transpose(1, 2).contiguous().view(B * K, k.shape[1], Dk)
    vf = v.transpose(1, 2).contiguous().view(B * K, v.shape[1], Dv)
    o = flash_attention(qf, kf, vf, causal=causal, window=window,
                        n_q_heads=H, n_kv_heads=K)
    return o.reshape(B, H, Sq, Dv).transpose(1, 2)
