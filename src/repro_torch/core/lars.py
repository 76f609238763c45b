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
buffer (``kernels/ops.tree_norms``). The ZeRO-1 sharded update is ROADMAP
§1 item 7.
"""
from __future__ import annotations

import dataclasses

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
