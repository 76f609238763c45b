"""Optimizers: momentum-SGD (the paper's base solver), LARS [You et al.,
arXiv:1708.03888] — the paper's §III-A.1 layer-wise adaptive rate
scaling — and LAMB. A port of ``repro.core.lars``.

LARS per tensor w with gradient g:
    trust = η · ||w|| / (||g|| + wd·||w|| + ε)
    v    ← μ·v + lr·trust·(g + wd·w)
    w    ← w − v
Trust scaling applies to every tensor of two or more dimensions, the
classifier head's ``head/w`` included (the reference's ``_is_scaled``);
1-D tensors (biases, BN scales) take trust 1.

Per-tensor norms are computed either one tensor at a time or, with
``OptConfig.use_kernel``, by the batched-norm kernel over the bucket-packed
buffer (``kernels/ops.tree_norms``). The ZeRO-1 sharded update
(``sharded_update_from_shards``) works on this rank's packed bucket shards:
its trust norms always go through the batched-norm wrapper (the kernel on
the card, once a step), and ``update_kernel=True`` runs the fused packed
update once a step over every bucket's shards
(``kernels.lars_update.lars_packed_update_multi``: one launch on the card).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "lars"            # lars | sgdm | lamb
    momentum: float = 0.9         # beta1 for lamb
    beta2: float = 0.999          # lamb second-moment decay
    weight_decay: float = 5e-5
    trust_coef: float = 0.001     # η (lars); lamb uses ratio directly
    eps: float = 1e-9
    nesterov: bool = False
    use_kernel: bool = False      # batched-norm kernel for the norms


def init_momentum(params, kind: str = "lars"):
    zeros = lambda: tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    if kind == "lamb":
        # LAMB carries Adam's two moments in one tree, so the TrainState
        # shape is optimizer-agnostic
        return {"m": zeros(), "v": zeros(), "count": 0}
    return zeros()


def _is_scaled(p) -> bool:
    """Trust-ratio scaling applies to >=2-D tensors only."""
    return p.dim() >= 2


def tensor_norms(tree):
    """Per-tensor L2 norms, one reduction per tensor (the per-layer
    baseline the paper's batched kernel replaces)."""
    return tree_map(lambda x: torch.sqrt(torch.sum(torch.square(x.float()))),
                    tree)


def _batched_norms(params, grads, cfg):
    """All per-tensor norms in one pass (kernel) or one per tensor."""
    if cfg.use_kernel:
        from repro_torch.kernels import ops
        return ops.tree_norms(params), ops.tree_norms(grads)
    return tensor_norms(params), tensor_norms(grads)


@torch.no_grad()
def update(params, grads, mom, lr, cfg: OptConfig):
    """One optimizer step on fp32 masters; ``grads`` may be bf16 and ``lr``
    a float or 0-d f32 tensor. Returns (new_params, new_mom) as new trees."""
    lr = float(lr)
    if cfg.kind == "sgdm":
        def upd(p, g, v):
            g = g.float() + cfg.weight_decay * p
            v2 = cfg.momentum * v + lr * g
            step = (cfg.momentum * v2 + lr * g) if cfg.nesterov else v2
            return p - step, v2
        out = tree_map(upd, params, grads, mom)
    elif cfg.kind == "lars":
        wn, gn = _batched_norms(params, grads, cfg)

        def upd(p, g, v, pw, gw):
            g = g.float()
            if _is_scaled(p):
                trust = cfg.trust_coef * pw / (gw + cfg.weight_decay * pw
                                               + cfg.eps)
                trust = torch.where(pw > 0, trust, 1.0)
            else:
                trust = 1.0
            g = g + cfg.weight_decay * p
            v2 = cfg.momentum * v + (lr * trust) * g
            return p - v2, v2
        out = tree_map(upd, params, grads, mom, wn, gn)
    elif cfg.kind == "lamb":
        # You et al. 2020 (LAMB): Adam statistics + per-tensor trust ratio
        # ||w|| / ||update||
        t = mom["count"] + 1
        b1, b2 = cfg.momentum, cfg.beta2
        new_m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(),
                         grads, mom["m"])
        new_v = tree_map(lambda g, v: b2 * v + (1 - b2) * g.float()
                         * g.float(), grads, mom["v"])
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        c1 = float(1 - torch.pow(f32(b1), f32(t)))
        c2 = float(1 - torch.pow(f32(b2), f32(t)))

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            u = u + cfg.weight_decay * p
            if _is_scaled(p):
                wn = torch.sqrt(torch.sum(torch.square(p)))
                un = torch.sqrt(torch.sum(torch.square(u)))
                ratio = torch.where((wn > 0) & (un > 0), wn / un, 1.0)
            else:
                ratio = 1.0
            return p - lr * ratio * u

        new_params = tree_map(upd, params, new_m, new_v)
        return new_params, {"m": new_m, "v": new_v, "count": t}
    else:
        raise ValueError(cfg.kind)
    new_params = tree_map(lambda t: t[0], out)
    new_mom = tree_map(lambda t: t[1], out)
    return new_params, new_mom


# --------------------------------------------------------------------------
# ZeRO-1 sharded update (explicit-DP path; see core/ddp.py)

@functools.lru_cache(maxsize=16)
def _shard_maps(plan, n_shards: int, k: int, device: torch.device):
    """Rank-``k`` row of every bucket's shard segment map, and the rows
    concatenated in bucket order (the map of the one batched-norm call and
    of the one fused-update call over all shards), on ``device``, built
    once per plan. The concatenation must be non-decreasing, as the
    batched-norm kernel finds a segment by binary search: ids rise with the
    packing order and padding repeats a bucket's last id, so it is by
    construction, and checked here once."""
    from repro_torch.core import bucketing
    rows = [m[k] for m in bucketing.shard_segment_ids(plan, n_shards)]
    cat = np.concatenate(rows)
    if (cat[1:] < cat[:-1]).any():
        raise ValueError("shard segment map is not non-decreasing")
    return (tuple(torch.from_numpy(r.copy()).to(device) for r in rows),
            torch.from_numpy(cat).to(device))


@functools.lru_cache(maxsize=16)
def _scaled_mask(plan, device: torch.device):
    from repro_torch.core import bucketing
    return torch.from_numpy(bucketing.trust_scaled_mask(plan)).to(device)


def shard_trust_ratios(param_shards, grad_shards, seg_ids, plan,
                       cfg: OptConfig, *, shard_axis):
    """Per-tensor LARS trust ratios from summed partial norms.

    Each rank holds one contiguous shard per bucket; a tensor's squared
    norm is the sum over the shard axis of every shard's per-CHUNK partial
    sums, routed to the tensor by ``seg_ids``, the rank's shard segment
    maps of all buckets concatenated (split spans share one id). The
    partial sums are ONE ``kernels.batched_norm.batched_sumsq_multi`` call
    over both vectors' shards (one launch on the card); a tensor split
    across buckets is summed in that one pass, not as a sum of per-bucket
    sums. The sum over ranks is ONE all-reduce of both vectors. Returns a
    ``(n_tensors,)`` f32 trust vector indexed by tensor id (1.0 for <2-D
    tensors and for sgdm)."""
    from repro_torch.comm import primitives as prim
    from repro_torch.kernels.batched_norm import batched_sumsq_multi
    dev = param_shards[0].device
    if cfg.kind != "lars":
        return torch.ones(plan.n_tensors, dtype=torch.float32, device=dev)
    sq = batched_sumsq_multi((param_shards, grad_shards), seg_ids,
                             plan.n_tensors)
    sq = prim.psum(sq, (shard_axis,))
    wn, gn = torch.sqrt(sq[0]), torch.sqrt(sq[1])
    raw = cfg.trust_coef * wn / (gn + cfg.weight_decay * wn + cfg.eps)
    return torch.where(_scaled_mask(plan, dev) & (wn > 0), raw, 1.0)


@torch.no_grad()
def sharded_update_from_shards(p_shards, grad_shards, mom_shards, lr,
                               cfg: OptConfig, plan, *, shard_axis,
                               n_shards: int, update_kernel: bool = False):
    """One ZeRO-1 optimizer step on this rank's PERSISTENT bucket shards.

    ``p_shards`` / ``grad_shards`` / ``mom_shards``: per-bucket local fp32
    buffers of ``bucketing.shard_elems`` length: the master shards carried
    in ``TrainState.shards``, the reduce-scatter output, and the sharded
    momentum. Returns ``(param_shards, mom_shards)``. With
    ``update_kernel=True`` ONE call of the fused update
    (``kernels.lars_update.lars_packed_update_multi``, K2 once a step: one
    launch on the card, its plain version on the CPU) updates every
    bucket's ``p_shards`` and ``mom_shards`` IN PLACE and returns them;
    otherwise the plain version (``kernels.ref``) runs bucket by bucket,
    as the reference's loop does, and returns new buffers."""
    from repro_torch.comm.primitives import shard_index
    from repro_torch.kernels import ref
    from repro_torch.kernels.lars_update import lars_packed_update_multi
    if cfg.kind not in ("lars", "sgdm"):
        raise ValueError(f"sharded_update supports lars/sgdm, not "
                         f"{cfg.kind!r}")
    if cfg.nesterov:
        raise ValueError("nesterov momentum is unsupported on shards")
    segs, seg_all = _shard_maps(plan, n_shards, shard_index(shard_axis),
                                p_shards[0].device)
    trust = shard_trust_ratios(p_shards, grad_shards, seg_all, plan, cfg,
                               shard_axis=shard_axis)
    kw = dict(lr=lr, momentum=cfg.momentum, wd=cfg.weight_decay)
    if update_kernel:
        return lars_packed_update_multi(p_shards, grad_shards, mom_shards,
                                        trust, seg_all, **kw)
    new_p, new_m = [], []
    for p_s, g_s, m_s, seg in zip(p_shards, grad_shards, mom_shards, segs):
        p2, m2 = ref.lars_packed_update(p_s, g_s, m_s, trust, seg, **kw)
        new_p.append(p2)
        new_m.append(m2)
    return tuple(new_p), tuple(new_m)
