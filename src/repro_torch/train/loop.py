"""Training loop with the paper's MLPerf-v0.5.0 tag stream (Appendix 1:
run_start / train_step / eval_accuracy / run_stop) and the elastic and
fault-tolerance machinery of ``repro.train.loop``:

* **step watchdog** (``step_timeout_s``): each step runs in a worker
  thread under a time budget; a hung collective or stalled device trips
  it, the loop restores the last good checkpoint (in new tensors) and
  retries with exponential backoff, up to ``max_step_retries`` times. A
  thread cannot be killed, and the abandoned one may wake and launch the
  update into the state it was given, so under the watchdog each step
  runs on a copy of the state (the reference turns buffer donation off for
  the same reason) and the loop never goes on with the abandoned step's.
* **SIGTERM preemption drain** (handler installed from the main thread
  only): the in-flight step finishes, a checkpoint is committed, and the
  loop returns early.
* **checkpoints** (``ckpt_dir``): step-tagged saves every ``ckpt_every``
  steps with the CommPlan, ``keep_last_k`` retention, a baseline save
  under the watchdog and a final save at run_stop. On a mesh every rank
  takes part (``checkpoint.save(mesh=...)``); over a model axis the saves
  and restores gather and cut the split leaves by the step's
  ``param_pd``.
* **fault hooks** (``faults``): a ``train.faults.FaultInjector`` or its
  spec string.
* **numerical-integrity guard** (``guard``; a step built with
  ``make_train_step(..., guard=True)``): the sentinel's skipped steps are
  replayed in place, a divergence detector trips the in-memory rollback
  ring (device snapshots) with an optional LR re-warmup, escalating to a
  checkpoint restore and then bounded exhaustion.
* **tracer** (``tracer``): the loop owns the step windows
  (``begin_step``/``end_step``), drops an abandoned step's window, and
  records checkpoint commits and recovery events.
"""
from __future__ import annotations

import contextlib
import functools
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.faults import FaultInjector, parse_faults
from repro_torch.train.guard import (DivergenceDetector, GuardConfig,
                                     RollbackRing, rewarmup_scale_fn)
from repro_torch.train.state import TrainState, gather_rows, host_snapshot

_WHERE = "repro_torch/train/loop.py"


class StepTimeoutError(RuntimeError):
    """A training step exceeded the watchdog budget."""


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
    from repro_torch.train.state import full_params_from_shards
    plan, n = train_step.bucket_plan, train_step.n_shards
    axis = train_step.mesh.axis(train_step.shard_axis)

    def read(state: TrainState):
        if state.shards is None:
            return state.params
        return full_params_from_shards(
            [gather_rows(s, axis) for s in state.shards], plan, n)
    return read


def authoritative_params(state: TrainState, train_step: Callable):
    """One-off form of :func:`make_params_reader`."""
    return make_params_reader(train_step)(state)


def _sync(metrics) -> None:
    """Wait for the step, as the reference's ``block_until_ready``."""
    if metrics["loss"].is_cuda:
        torch.cuda.synchronize(metrics["loss"].device)


def _state_device(state: TrainState) -> Optional[torch.device]:
    for field in state:
        leaves = (field.values() if isinstance(field, dict) else
                  field if isinstance(field, (tuple, list)) else [field])
        for x in leaves:
            if isinstance(x, torch.Tensor):
                return x.device
    return None


def _call_with_timeout(fn: Callable, timeout_s: float, device=None):
    """Run ``fn`` with a wall-clock budget. ``timeout_s <= 0`` calls
    inline. The worker thread first makes ``device`` (a CUDA device) its
    current device, and is daemonic: a hung step is abandoned (it cannot be
    killed), which is the recover-by-restore case the watchdog is for."""
    if not timeout_s or timeout_s <= 0:
        return fn()
    box = {}

    def worker():
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            box["ok"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            box["err"] = e

    t = threading.Thread(target=worker, daemon=True,
                         name="repro-step-watchdog")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise StepTimeoutError(
            f"step exceeded the {timeout_s:.1f}s watchdog budget (hung "
            f"collective / stalled device?)")
    if "err" in box:
        raise box["err"]
    return box["ok"]


def train(state: TrainState, train_step: Callable, batch_fn: Callable, *,
          steps: int, eval_step: Optional[Callable] = None,
          eval_batch_fn: Optional[Callable] = None, eval_every: int = 0,
          log_every: int = 10, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 0, seed: int = 0, keep_last_k: int = 0,
          step_timeout_s: float = 0.0, max_step_retries: int = 3,
          retry_backoff_s: float = 0.5, comm_plan=None, faults=None,
          tracer=None, guard: Optional[GuardConfig] = None):
    """Runs optimizer steps up to global step ``steps`` (a resumed state
    continues from ``state.step``). Returns (state, history).

    ``guard`` (a ``train.guard.GuardConfig``) configures the recovery
    ladder and needs a guarded step (``make_train_step(..., guard=True)``);
    a guarded step with ``guard=None`` runs under ``GuardConfig()``.
    ``tracer`` (an ``obs.trace.Tracer``, also given to
    ``make_train_step``) makes the loop own the step windows."""
    mlperf_log("run_start")
    mlperf_log("run_set_random_seed", seed)
    injector = (faults if isinstance(faults, FaultInjector)
                else FaultInjector(parse_faults(faults)))
    read_params = make_params_reader(train_step)
    mesh = getattr(train_step, "mesh", None)
    param_pd = getattr(train_step, "param_pd", None)
    history = []
    t0 = time.time()
    watchdog = bool(step_timeout_s and step_timeout_s > 0)
    last_saved_step = None

    guarded = bool(getattr(train_step, "guarded", False))
    if guard is not None and not guarded:
        raise ValueError(
            "loop.train(guard=...) needs a guarded step — build it with "
            "make_train_step(..., guard=True)")
    device = _state_device(state)
    gcfg = guard if guard is not None else (GuardConfig() if guarded
                                            else None)
    detector = DivergenceDetector(gcfg) if guarded else None
    ring = RollbackRing(gcfg.ring_capacity) if guarded else None
    rewarm = rewarmup_scale_fn(gcfg.rewarmup_steps) if guarded else None
    rewarm_start = None       # step a recovery re-warmup window opened at
    skips = 0                 # consecutive sentinel skips
    rollbacks = 0             # ring rollbacks used
    restores = 0              # guard checkpoint restores used

    def save_ckpt(s: TrainState) -> None:
        nonlocal last_saved_step
        gstep = int(s.step)
        span = (tracer.host_span("checkpoint_commit", step=gstep)
                if tracer is not None else contextlib.nullcontext())
        with span:
            path = ckpt.save(s, ckpt_dir, tag=ckpt.step_tag(gstep),
                             comm_plan=comm_plan, keep_last_k=keep_last_k,
                             mesh=mesh, param_pd=param_pd)
        last_saved_step = gstep
        mlperf_log("checkpoint_saved",
                   {"step": gstep, "tag": ckpt.step_tag(gstep)})
        if ckpt.is_writer():
            injector.on_saved(path, gstep)

    def restore(s: TrainState) -> TrainState:
        return ckpt.load(s, ckpt_dir, tag=None, mesh=mesh,
                         param_pd=param_pd)

    preempted = threading.Event()

    def _on_sigterm(signum, frame):
        preempted.set()
        mlperf_log("sigterm_received")

    old_handler = None
    if threading.current_thread() is threading.main_thread():
        old_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    def run_step(state, batch, i, guard_in):
        injector.on_step(i)
        if tracer is not None:
            tracer.begin_step()
        s2, m = (train_step(state, batch, guard_in) if guarded
                 else train_step(state, batch))
        _sync(m)
        if tracer is not None:
            tracer.end_step(i)
        return s2, m

    if watchdog and ckpt_dir and not ckpt.available_tags(ckpt_dir):
        # baseline restore point: the watchdog must always have somewhere
        # to roll back to, even if the very first step hangs
        save_ckpt(state)
    i = int(state.step)
    retries = 0
    if guarded and ring is not None:
        # baseline snapshot: rung 2 has a target even if the first steps
        # diverge
        ring.snapshot(state)
    try:
        while i < steps:
            batch = injector.poison_batch(batch_fn(state.step), i)
            guard_in = None
            if guarded:
                scale = (1.0 if rewarm_start is None
                         else rewarm(i - rewarm_start))
                guard_in = {"lr_scale": np.float32(scale),
                            "loss_scale": np.float32(injector.loss_scale(i))}
            try:
                # under the watchdog the step must not consume the state the
                # loop keeps: an abandoned step may still write into its
                # input. The call binds its arguments, so nothing keeps the
                # step's input alive once it has returned.
                state, metrics = _call_with_timeout(functools.partial(
                    run_step, host_snapshot(state) if watchdog else state,
                    batch, i, guard_in), step_timeout_s, device)
                retries = 0
            except StepTimeoutError as e:
                retries += 1
                if tracer is not None:
                    # the hung step's stamps are meaningless (and may still
                    # trickle in): drop its window, mark the event
                    tracer.abort_step()
                    tracer.instant("watchdog_timeout", step=i,
                                   attempt=retries)
                obs_metrics.counter("obs.watchdog_timeout_total",
                                    where=_WHERE, step=i)
                mlperf_log("watchdog_timeout",
                           {"step": i, "attempt": retries,
                            "timeout_s": step_timeout_s})
                history.append({"step": i, "watchdog_timeout": retries})
                if retries > max_step_retries:
                    raise RuntimeError(
                        f"step {i} timed out {retries} times "
                        f"(budget {step_timeout_s:.1f}s each) — giving up "
                        f"after bounded retries") from e
                if ckpt_dir:
                    try:
                        state = restore(state)
                        i = int(state.step)
                        if tracer is not None:
                            tracer.instant("watchdog_restore", step=i)
                        mlperf_log("watchdog_restore", {"resume_step": i})
                        history.append({"step": i, "watchdog_restore": 1})
                    except ckpt.CheckpointError as err:
                        mlperf_log("watchdog_no_checkpoint",
                                   {"step": i, "error": str(err),
                                    "action": "retrying with the "
                                              "in-memory state"})
                time.sleep(min(retry_backoff_s * 2 ** (retries - 1), 30.0))
                continue
            if guarded:
                # ---- the recovery ladder
                g_loss = float(metrics["loss"])
                g_gnorm = float(metrics["gnorm"])
                reason = None
                if float(metrics["skipped"]) > 0:
                    # rung 1: the sentinel refused the update; the state
                    # (and state.step) are unchanged: replay step i
                    skips += 1
                    obs_metrics.counter("obs.guard.skip_total",
                                        where=_WHERE, step=i)
                    if tracer is not None:
                        tracer.instant("guard_skip", step=i, attempt=skips)
                    mlperf_log("guard_skip",
                               {"step": i, "attempt": skips,
                                "nonfinite": int(float(metrics["nonfinite"]))})
                    history.append({"step": i, "guard_skip": skips})
                    if skips <= gcfg.max_skips:
                        if not preempted.is_set():
                            continue
                        reason = "preempted mid-skip"
                    else:
                        reason = (f"{skips} consecutive nonfinite steps "
                                  f"at step {i}")
                else:
                    skips = 0
                    if detector.observe(g_loss, g_gnorm) != "ok":
                        reason = (f"divergence at step {i}: loss "
                                  f"{g_loss:.4g}, grad-norm {g_gnorm:.4g} "
                                  f"vs EMA {detector.ema_gnorm or 0.0:.4g}")
                if reason == "preempted mid-skip":
                    # a skipped step committed nothing: drain like the
                    # preemption path below
                    mlperf_log("preempt_drain", {"step": i})
                    if ckpt_dir and last_saved_step != int(state.step):
                        save_ckpt(state)
                    break
                if reason is not None:
                    recovered = False
                    snap = ring.newest()
                    if snap is not None and rollbacks < gcfg.max_rollbacks:
                        # rung 2: in-memory rollback, no checkpoint IO
                        rollbacks += 1
                        state = RollbackRing.restore(snap[1])
                        i = int(state.step)
                        if gcfg.rewarmup_steps:
                            rewarm_start = i
                        obs_metrics.counter("obs.guard.rollback_total",
                                            where=_WHERE, step=i)
                        if tracer is not None:
                            tracer.instant("guard_rollback", step=i,
                                           used=rollbacks)
                        mlperf_log("guard_rollback",
                                   {"resume_step": i, "used": rollbacks,
                                    "reason": reason})
                        history.append({"step": i,
                                        "guard_rollback": rollbacks})
                        if ckpt_dir:
                            # guard-escalation save: step-tagged, so
                            # retention can prune a spiky run's trail
                            save_ckpt(state)
                        recovered = True
                    elif ckpt_dir and restores < gcfg.max_restores:
                        # rung 3: checkpoint restore
                        try:
                            state = restore(state)
                            restores += 1
                            i = int(state.step)
                            if gcfg.rewarmup_steps:
                                rewarm_start = i
                            obs_metrics.counter("obs.guard.restore_total",
                                                where=_WHERE, step=i)
                            if tracer is not None:
                                tracer.instant("guard_ckpt_restore", step=i)
                            mlperf_log("guard_ckpt_restore",
                                       {"resume_step": i, "reason": reason})
                            history.append({"step": i, "guard_restore": 1})
                            recovered = True
                        except ckpt.CheckpointError as err:
                            mlperf_log("guard_no_checkpoint",
                                       {"step": i, "error": str(err)})
                    if not recovered:
                        # rung 4: bounded exhaustion
                        raise RuntimeError(
                            f"numerical guard exhausted its recovery "
                            f"ladder ({rollbacks} rollbacks, {restores} "
                            f"checkpoint restores) — {reason}")
                    skips = 0
                    continue
                if ring is not None and \
                        int(state.step) % max(gcfg.snapshot_every, 1) == 0:
                    # snapshot only a state that passed sentinel AND
                    # detector: a spiked state is never a restore target
                    ring.snapshot(state)
            if log_every and (i % log_every == 0 or i == steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": i, **m})
                mlperf_log("train_step",
                           {"step": i, "loss": round(m["loss"], 4),
                            "lr": round(m.get("lr", 0.0), 6)})
                if guarded:
                    obs_metrics.gauge("obs.guard.gnorm", m["gnorm"],
                                      where=_WHERE, step=i)
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
                           {"step": i, **{k: round(v, 4)
                                          for k, v in em.items()}})
                mlperf_log("eval_stop")
                history.append({"step": i, **{f"eval_{k}": v
                                              for k, v in em.items()}})
            i += 1
            if ckpt_dir and ckpt_every and i % ckpt_every == 0:
                save_ckpt(state)
            if preempted.is_set():
                # announced preemption: the in-flight step has drained;
                # commit the tail once (a drained step on the ckpt_every
                # cadence was saved just above)
                if tracer is not None:
                    tracer.instant("preempt_drain", step=i)
                mlperf_log("preempt_drain", {"step": i})
                if ckpt_dir and last_saved_step != int(state.step):
                    save_ckpt(state)
                break
        if ckpt_dir and last_saved_step != int(state.step):
            # run_stop tail: a step count off the ckpt_every cadence (or no
            # cadence at all) still leaves a final checkpoint
            save_ckpt(state)
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
    dt = time.time() - t0
    mlperf_log("run_stop", {"steps": int(state.step),
                            "wall_s": round(dt, 2),
                            "preempted": preempted.is_set()})
    mlperf_log("run_final")
    return state, history
