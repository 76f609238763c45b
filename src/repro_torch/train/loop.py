"""Training loop with the paper's MLPerf-v0.5.0 tag stream (Appendix 1:
run_start / train_step / eval_accuracy / run_stop), a port of
``repro.train.loop`` without its fault-tolerance machinery.

Checkpoints, the step watchdog, fault injection, the guard and the tracer
are ROADMAP §1 item 8; passing their arguments raises
``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.train.state import TrainState

_WHERE = "repro_torch/train/loop.py"

#: arguments of the reference loop whose machinery is not ported yet,
#: with the value that leaves it off
_NOT_PORTED = {"ckpt_dir": None, "ckpt_every": 0, "keep_last_k": 0,
               "step_timeout_s": 0.0, "comm_plan": None, "faults": None,
               "tracer": None, "guard": None}


def mlperf_log(tag: str, value=None):
    """The Appendix-1 tag line, through the ``obs.metrics`` registry."""
    obs_metrics.event(tag, value, where=_WHERE)


def make_params_reader(train_step: Callable) -> Callable:
    """The params evals must read. A zero1 or zero3 state carries its fp32
    masters in ``state.shards``: under zero1 with gather-ahead (the
    default) ``state.params`` is the forward copy, one update BEHIND them,
    and under zero3 it is None. So for a sharded step this reads the
    masters from the shards, gathering every rank's shard along the shard
    axis; a zero2 state (no shards) and a replicated one read
    ``state.params``, the masters."""
    if getattr(train_step, "sharding", "replicated") == "replicated":
        return lambda state: state.params
    import torch.distributed as dist
    from repro_torch.train.state import full_params_from_shards
    plan, n = train_step.bucket_plan, train_step.n_shards
    axis = train_step.mesh.axis(train_step.shard_axis)

    def rows(shard):
        if n == 1:
            return shard
        parts = [torch.empty_like(shard) for _ in range(n)]
        dist.all_gather(parts, shard, group=axis.group)
        return torch.cat(parts)

    def read(state: TrainState):
        if state.shards is None:
            return state.params
        return full_params_from_shards([rows(s) for s in state.shards],
                                       plan, n)
    return read


def authoritative_params(state: TrainState, train_step: Callable):
    """One-off form of :func:`make_params_reader`."""
    return make_params_reader(train_step)(state)


def _sync(metrics) -> None:
    """Wait for the step, as the reference's ``block_until_ready``."""
    if metrics["loss"].is_cuda:
        torch.cuda.synchronize(metrics["loss"].device)


def train(state: TrainState, train_step: Callable, batch_fn: Callable, *,
          steps: int, eval_step: Optional[Callable] = None,
          eval_batch_fn: Optional[Callable] = None, eval_every: int = 0,
          log_every: int = 10, seed: int = 0, **not_ported):
    """Runs optimizer steps up to global step ``steps`` (a state that has
    taken steps continues from ``state.step``). Returns (state, history)."""
    for name, value in not_ported.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"train() got an unexpected argument {name!r}")
        if value != _NOT_PORTED[name]:
            raise NotImplementedError(
                f"loop.train({name}=...) is not ported to repro_torch yet "
                f"(ROADMAP §1 item 8)")
    read_params = make_params_reader(train_step)
    mesh = getattr(train_step, "mesh", None)
    mlperf_log("run_start")
    mlperf_log("run_set_random_seed", seed)
    history = []
    t0 = time.time()
    i = state.step
    while i < steps:
        batch = batch_fn(state.step)
        state, metrics = train_step(state, batch)
        _sync(metrics)
        if log_every and (i % log_every == 0 or i == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            mlperf_log("train_step",
                       {"step": i, "loss": round(m["loss"], 4),
                        "lr": round(m.get("lr", 0.0), 6)})
        if eval_every and eval_step is not None \
                and (i + 1) % eval_every == 0:
            mlperf_log("eval_start")
            eb = eval_batch_fn(state.step + 100_000)
            em = eval_step(read_params(state), eb, state.bn_state)
            if mesh is not None:     # each rank evaluated its own rows
                from repro_torch.comm.primitives import pmean_tree
                em = pmean_tree(em, mesh.axes)
            em = {k: float(v) for k, v in em.items()}
            mlperf_log("eval_accuracy",
                       {"step": i, **{k: round(v, 4) for k, v in em.items()}})
            mlperf_log("eval_stop")
            history.append({"step": i, **{f"eval_{k}": v
                                          for k, v in em.items()}})
        i += 1
    dt = time.time() - t0
    mlperf_log("run_stop", {"steps": int(state.step),
                            "wall_s": round(dt, 2), "preempted": False})
    mlperf_log("run_final")
    return state, history
