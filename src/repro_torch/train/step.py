"""Train/eval steps (a port of ``repro.train.step``).

The port runs the reference's ``comm='xla'`` replicated step on a single
device: the loss is label-smoothed cross entropy (paper §III-A.2), the
optimizer LARS or momentum-SGD (paper §III-A.1) on fp32 masters with bf16
compute (paper §IV). Gradients are taken with respect to the bf16 compute
copy of the weights, as in the reference: each bf16 copy is an autograd
leaf of its own, not a cast of the master that autograd follows, so the
gradients arrive in bf16 and the optimizer upcasts them.

The explicit data-parallel schedules (ROADMAP §1 item 6), the ZeRO ladder
(item 7) and the guard and tracer (item 8) are not ported yet; asking for
them raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import CommConfig
from repro_torch.core import lars
from repro_torch.core.label_smoothing import smoothed_xent, top1_accuracy
from repro_torch.core.precision import cast_to_compute
from repro_torch.models.resnet import resnet_forward
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def make_loss_fn(model, *, smoothing: float = 0.1, aux_coef: float = 0.01):
    def loss_fn(params, batch, bn_state=None):
        (logits, aux), new_bn = model.forward_train(params, batch, bn_state)
        loss, _ = smoothed_xent(logits, batch["labels"], smoothing=smoothing)
        total = loss + aux_coef * aux
        acc = top1_accuracy(logits.detach(), batch["labels"])
        metrics = {"loss": loss.detach(), "aux": aux.detach(), "acc": acc}
        return total, (metrics, new_bn)

    return loss_fn


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP §1 item {item})")


def make_train_step(model, opt_cfg: lars.OptConfig, schedule, *,
                    smoothing: float = 0.1, mesh=None, comm="xla",
                    bucket_mb: float = 4.0, comm_dtype: str = "bf16",
                    grad_accum: int = 1, tracer=None, guard: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``comm`` is 'xla' or a ``CommConfig`` with ``strategy='xla'`` and
    ``sharding='replicated'``; ``mesh`` must be None (one device).
    ``comm_dtype='bf16'`` differentiates the bf16 compute copy, 'f32' the
    fp32 masters. ``grad_accum`` splits the batch into that many
    microbatches, chains the BN statistics through them and means the f32
    gradients and the metrics, as the reference's scan does. Metrics are
    0-d tensors on the batch's device; ``lr`` a 0-d f32 CPU tensor."""
    comm_cfg = comm if isinstance(comm, CommConfig) else CommConfig(
        strategy=comm, bucket_mb=bucket_mb, wire_dtype=comm_dtype)
    if comm_cfg.strategy != "xla":
        raise _not_ported(f"comm={comm_cfg.strategy!r}", 6)
    if comm_cfg.sharding != "replicated":
        raise _not_ported(f"sharding={comm_cfg.sharding!r}", 7)
    if mesh is not None:
        raise _not_ported("a multi-device mesh", 6)
    if guard:
        raise _not_ported("guard=True", 8)
    if tracer is not None:
        raise _not_ported("the step tracer", 8)
    if comm_cfg.wire_dtype not in ("bf16", "f32"):
        raise ValueError(comm_cfg.wire_dtype)
    bf16 = comm_cfg.wire_dtype == "bf16"
    loss_fn = make_loss_fn(model, smoothing=smoothing)

    def grads_of(p_in, batch, bn_state):
        flat = tree_flatten(p_in)
        total, (metrics, new_bn) = loss_fn(p_in, batch, bn_state)
        grads = torch.autograd.grad(total, [leaf for _, leaf in flat])
        return tree_unflatten([p for p, _ in flat], grads), metrics, new_bn

    def train_step(state: TrainState, batch):
        p_in = cast_to_compute(state.params) if bf16 else state.params
        p_in = tree_map(lambda p: p.detach().requires_grad_(), p_in)
        if grad_accum == 1:
            grads, metrics, new_bn = grads_of(p_in, batch, state.bn_state)
        else:
            # the paper's 81,920 global batch on fewer chips: microbatches
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads, new_bn, ms = None, state.bn_state, []
            for i in range(grad_accum):
                g, m, new_bn = grads_of(
                    p_in, {k: v[i] for k, v in micro.items()}, new_bn)
                g = tree_map(lambda x: x.float(), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / grad_accum, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        lr = schedule(state.step)
        params, mom = lars.update(state.params, grads, state.mom, lr,
                                  opt_cfg)
        metrics = dict(metrics, lr=lr)
        return TrainState(state.step + 1, params, mom, new_bn), metrics

    return train_step


def make_eval_step(model):
    """eval_step(params, batch, bn_state) -> {'loss', 'acc'} with the
    running BN statistics and no smoothing (conv family)."""
    cfg = model.cfg

    @torch.no_grad()
    def eval_step(params, batch, bn_state=None):
        logits, _ = resnet_forward(cast_to_compute(params), bn_state, cfg,
                                   batch["images"], train=False)
        loss, _ = smoothed_xent(logits, batch["labels"], smoothing=0.0)
        return {"loss": loss, "acc": top1_accuracy(logits, batch["labels"])}

    return eval_step
