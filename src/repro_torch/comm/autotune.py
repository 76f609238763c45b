"""Bucket-size autotuning against the alpha-beta cost model (§III-C.1), a
port of ``repro.comm.autotune`` (the same names and arithmetic; the
constants are the card's, ``launch/hw.py``, passed as ``links=`` and
``hw=``).

The paper hand-tunes its "several megabytes" bucket size: big buckets
amortize per-message latency (alpha), small buckets finish earlier groups
sooner and hide more communication behind the backward pass. This module
makes that trade-off a search:

  1. For each candidate ``bucket_mb``, build the static ``BucketPlan``
     (``core/bucketing.py`` — group boundaries in backward-completion
     order).
  2. Predict each bucket's collective time with ``comm/cost.py`` and each
     group's backward compute time with a per-group backward-time model
     (measured total backward time apportioned over groups by parameter
     volume — conv/matmul grad FLOPs scale with parameter count at fixed
     batch).
  3. Simulate the overlapped timeline: bucket *b*'s collective may start
     once its group's gradients are ready AND the link is free (collectives
     serialize on the wire), so

        start_b  = max(ready_b, finish_{b-1});  finish_b = start_b + c_b
        exposed  = max(0, finish_last - t_backward_total)

     and the step pays ``t_backward + exposed`` for communication.
  4. Pick the candidate minimizing predicted step time (ties: fewer
     buckets, i.e. fewer messages).

``CommConfig(bucket_mb='auto')`` routes through :func:`autotune` when
``train.step.make_train_step`` builds the step.

Two extensions (docs/comm.md):

* ``backward_profile='measured'`` replaces the volume-apportioned FLOPs
  model with one *profiled* warm-up step: per-group completion timestamps
  captured at the overlap group boundaries (``ddp.wrap_params_for_probe``;
  on the card CUDA events recorded on the current stream) become a
  cumulative time-vs-volume curve (:class:`BackwardProfile`) that any
  candidate plan's group boundaries interpolate into.
* ``sharding='zero1'`` prices the ZeRO-1 timeline instead of the
  all-reduce one: per-bucket reduce-scatter (overlapped with the backward),
  the 1/n packed update on the persistent shards, and the param
  all-gather — RS(g) + AG(p) + update/n vs AR(g) + full update.
  ``gather='ahead'`` (default) hides the AG under the NEXT step's forward
  (``ddp.gather_ahead_params``, the implemented timeline); ``'at_end'``
  charges the full AG to the step (the end-of-step issue point).
* ``sharding='zero2'`` prices the middle rung: the gradient collective is
  the same in-backward reduce-scatter and the update runs on 1/n, but the
  params stay a replicated fp32 master — the step-end all-gather rides a
  4-byte fp32 wire (the masters must not quantize) and is fully exposed
  (there is no next-forward issue point to hide it under).
* ``sharding='zero3'`` prices the just-in-time timeline: the *forward*
  owns the param all-gathers. Bucket groups are consumed in reverse
  packing order (packing is backward-completion order), each group's AG
  must land before its forward compute, AGs serialize on the wire, and
  with ``gather='per_group'`` the backward re-gathers each group the same
  way (the rematerialized forward re-runs the AG), stretching the
  effective backward timeline; ``gather='ahead'`` retains the forward
  copies so the backward pays nothing extra. The per-group forward time
  is apportioned from the measured ``t_forward`` (the forward-start
  probe) exactly like the backward curve.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import cost
from repro_torch.core import bucketing
from repro_torch.launch import hw as hw_mod
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

#: candidate bucket sizes, MB — brackets the paper's "several megabytes"
CANDIDATES_MB: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


@dataclasses.dataclass(frozen=True)
class BackwardProfile:
    """Measured backward-time curve: cumulative wall time at cumulative
    packed parameter volume (fine-granularity group boundaries, packing
    order). ``backward_times`` interpolates any plan's boundaries into it,
    so one profiled step serves every bucket-size candidate."""
    cum_elems: Tuple[int, ...]
    cum_time_s: Tuple[float, ...]
    #: measured forward time (forward-start probe -> backward-start marker);
    #: None on profiles captured before the forward probe existed, in which
    #: case ``simulate`` falls back to the t_backward/2 heuristic
    t_forward_s: Optional[float] = None

    @property
    def total_s(self) -> float:
        return self.cum_time_s[-1]


@dataclasses.dataclass(frozen=True)
class OverlapSim:
    """Predicted overlapped-step timeline for one (plan, schedule)."""
    t_backward_s: float          # total backward compute
    t_comm_s: float              # serialized collective time, all buckets
    t_exposed_s: float           # comm left showing after the backward ends
    t_step_s: float              # backward + exposed comm (+ update)
    overlap_eff: float           # fraction of comm hidden: 1 - exposed/comm
    t_update_s: float = 0.0      # optimizer step (1/n of it when sharded)
    t_gather_s: float = 0.0      # param all-gather (sharded modes only;
                                 # zero3 per_group counts both passes)
    mode: str = "allreduce"      # 'allreduce' | 'shard_update' (AG at step
                                 # end) | 'shard_update+gather_ahead' |
                                 # 'zero2' (fp32 AG at step end) |
                                 # 'zero3_jit_gather' | 'zero3_retain'


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    schedule: str
    bucket_mb: float
    plan: bucketing.BucketPlan
    sim: OverlapSim

    @property
    def n_buckets(self) -> int:
        return self.plan.n_buckets


def backward_times(plan: bucketing.BucketPlan, t_backward_s: float,
                   profile: Optional[BackwardProfile] = None
                   ) -> Tuple[float, ...]:
    """Per-group backward time. With a measured ``profile``, each group
    boundary interpolates the cumulative time-vs-volume curve (rescaled to
    ``t_backward_s`` so an explicit override still applies); otherwise the
    total is apportioned by each group's padded parameter volume."""
    if profile is not None and profile.total_s > 0:
        xs = np.concatenate([[0.0], np.asarray(profile.cum_elems, float)])
        ys = np.concatenate([[0.0], np.asarray(profile.cum_time_s, float)])
        cum = np.interp(np.cumsum(plan.bucket_sizes), xs, ys)
        cum = cum * (t_backward_s / profile.total_s)
        return tuple(np.diff(np.concatenate([[0.0], cum])))
    total = float(sum(plan.bucket_sizes)) or 1.0
    return tuple(t_backward_s * s / total for s in plan.bucket_sizes)


def measure_backward_profile(loss, params, *, bucket_mb: float =
                             CANDIDATES_MB[0], warmup: int = 1
                             ) -> BackwardProfile:
    """One profiled warm-up step (``backward_profile='measured'``).

    ``loss(params) -> scalar`` is differentiated with every fine-granularity
    bucket group's params routed through a probing identity
    (``ddp.wrap_params_for_probe``), a forward-start marker on the params
    (``ddp.mark_forward_start``), and a backward-start marker on the loss
    itself. Each probe records a CUDA event on the current stream (the
    moment the card reaches that point of the queue; read after a sync) or,
    on the CPU, a host stamp. The group stamps give the cumulative
    backward-time curve, the forward-to-backward gap the measured
    ``t_forward_s``. Uses the smallest candidate bucket size so the curve
    resolves every coarser plan's boundaries."""
    from repro_torch.core import ddp
    plan = bucketing.make_plan(params, bucket_mb=bucket_mb)
    flat = tree_flatten(params)
    paths = [p for p, _ in flat]
    dev = flat[0][1].device
    cuda = dev.type == "cuda"
    stamps: Dict[int, object] = {}

    def probe(i):
        if i in stamps:
            return
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps[i] = ev
        else:
            stamps[i] = time.perf_counter()

    def run():
        leaves = [x.detach().requires_grad_() for _, x in flat]
        p = ddp.mark_forward_start(tree_unflatten(paths, leaves), probe)
        p = ddp.wrap_params_for_probe(p, plan, probe)
        out = ddp.mark_backward_start(loss(p), probe)
        torch.autograd.grad(out, leaves)
        if cuda:
            torch.cuda.synchronize(dev)

    for _ in range(max(warmup, 1)):
        run()
    stamps.clear()
    run()
    if -1 not in stamps or len(stamps) != plan.n_buckets + 2:
        raise RuntimeError(
            f"backward profile incomplete: {sorted(stamps)} of "
            f"{plan.n_buckets} groups stamped")
    if cuda:
        origin = stamps[-2]
        secs = {i: origin.elapsed_time(ev) / 1e3 for i, ev in stamps.items()}
    else:
        secs = dict(stamps)
    t_fwd0 = secs.pop(-2)
    t0 = secs.pop(-1)
    t_forward = max(t0 - t_fwd0, 1e-9)
    # The timeline model assumes groups complete in packing order (the
    # §III-C.2 static-group premise), but a real tree's flatten order only
    # approximates it, so the i-th packing group takes the i-th order
    # statistic of the measured completion times, keeping the measured
    # *spacing* without letting one out-of-order group flatten the curve.
    rel = sorted(max(secs[i] - t0, 1e-9) for i in range(plan.n_buckets))
    return BackwardProfile(tuple(int(c) for c in
                                 np.cumsum(plan.bucket_sizes)),
                           tuple(float(t) for t in rel),
                           t_forward_s=float(t_forward))


def backward_flops_per_param(family: Optional[str] = None) -> float:
    """Backward FLOPs per parameter per example. Matmul families touch each
    weight ~once per token: fwd 2 FLOPs/param, bwd ~2x that. Convolutions
    reuse each weight across spatial positions — ResNet-50 is ~4.1 GFLOP
    fwd per 224px image over 25.6M params, a ~160x reuse factor."""
    if family == "conv":
        return 2 * 4.1e9 / 25.6e6
    return 4.0


def estimate_backward_time(n_params: int, *, per_device_batch: int = 320,
                           mfu: float = 0.45,
                           flops_per_param: float = 4.0,
                           hw: Optional[hw_mod.Hardware] = None) -> float:
    """Order-of-magnitude backward-time model when no measurement is given:
    backward ~= 2x forward ~= ``flops_per_param`` FLOPs per parameter per
    example (see :func:`backward_flops_per_param`), at ``mfu`` of the
    card's bf16 matmul rate (``hw.peak_flops_bf16``). 320 = the paper's
    81,920 global batch on 256 chips. Callers with a profiled step should
    pass the measured time instead."""
    hw = hw or hw_mod.H100
    flops = flops_per_param * float(n_params) * per_device_batch
    return flops / (hw.peak_flops_bf16 * mfu)


def resolve_policy(sharding: Optional[str], gather: Optional[str], *,
                   shard_update: bool = False, gather_ahead: bool = True
                   ) -> Tuple[str, str]:
    """Map the deprecated boolean spellings onto the ``sharding=``/
    ``gather=`` policy enum when the enum is not given explicitly."""
    if sharding is None:
        sharding = "zero1" if shard_update else "replicated"
    if gather is None:
        if sharding == "zero3":
            gather = "per_group"
        elif sharding == "zero2":
            gather = "at_end"
        else:
            gather = "ahead" if gather_ahead else "at_end"
    return sharding, gather


def _forward_budget(t_backward_s: float, profile: Optional[BackwardProfile],
                    t_forward_s: Optional[float]) -> float:
    """Forward-time budget, resolved in order: explicit ``t_forward_s`` >
    the profile's measured ``t_forward_s`` (rescaled the same way the
    backward curve is, so an explicit ``t_backward_s`` override stays
    proportional) > the t_backward/2 heuristic."""
    if t_forward_s is not None:
        return t_forward_s
    if (profile is not None and profile.t_forward_s is not None
            and profile.total_s > 0):
        return profile.t_forward_s * (t_backward_s / profile.total_s)
    return 0.5 * t_backward_s


def simulate(plan: bucketing.BucketPlan, schedule: str,
             axes: Sequence[str], sizes: Sequence[int], *,
             dtype_bytes: int = 2, t_backward_s: float,
             links: Optional[Dict[str, cost.Link]] = None,
             profile: Optional[BackwardProfile] = None,
             shard_update: bool = False, param_dtype_bytes: int = 2,
             gather_ahead: bool = True,
             t_forward_s: Optional[float] = None,
             sharding: Optional[str] = None,
             gather: Optional[str] = None,
             hw: Optional[hw_mod.Hardware] = None) -> OverlapSim:
    """Walk the §III-C.2 timeline: groups finish their backward in packing
    order; each bucket's collective starts at max(grads ready, link free).

    ``sharding='zero1'`` prices the ZeRO-1 timeline instead: the per-bucket
    collective is the reduce-scatter-terminal form (issued inside the
    backward), the optimizer step runs on 1/n_shards of the persistent
    shards, and the param all-gather (``param_dtype_bytes`` per element —
    bf16 by default) is priced per ``gather``: 'ahead' (default) issues it
    at the start of the next step's forward, so it hides up to the forward
    budget (see :func:`_forward_budget`) and only the overhang is charged;
    'at_end' issues it at step end, fully exposed.

    ``sharding='zero3'`` walks the AG-in-forward timeline: bucket groups
    are consumed in REVERSE packing order during the forward (packing is
    backward-completion order), each group's forward compute waits for its
    just-in-time AG (AGs serialize on the wire), and the forward budget is
    apportioned over groups by volume. With ``gather='per_group'`` the
    backward re-gathers every group the same way (remat re-runs the AG),
    stretching the effective backward timeline the RS overlap runs
    against; ``gather='ahead'`` retains the forward copies. RS and AG are
    budgeted on independent wire timelines (full duplex).

    ``shard_update``/``gather_ahead`` remain as the deprecated boolean
    spellings; the enum kwargs win when both are given. ``links`` and
    ``hw`` default to ``launch.hw.H100``'s."""
    sharding, gather = resolve_policy(sharding, gather,
                                      shard_update=shard_update,
                                      gather_ahead=gather_ahead)
    bt = backward_times(plan, t_backward_s, profile)
    sharded = sharding != "replicated"
    n_elems = int(sum(plan.bucket_sizes))
    n_buckets = plan.n_buckets
    # zero2's step-end gather writes the authoritative fp32 masters — it
    # rides a 4-byte wire regardless of the configured param wire dtype
    ag_bytes = 4 if sharding == "zero2" else param_dtype_bytes
    ag_times = [
        cost.predict_all_gather(axes, sizes, s * ag_bytes,
                                links=links).time_s
        for s in plan.bucket_sizes] if sharded else [0.0] * n_buckets
    exposed = 0.0
    t_gather = 0.0

    if sharding == "zero3":
        # -- forward: just-in-time per-group AG, reverse packing order --
        t_fwd = _forward_budget(t_backward_s, profile, t_forward_s)
        total = float(n_elems) or 1.0
        fwd_t = [t_fwd * s / total for s in plan.bucket_sizes]
        ag_free = 0.0
        compute_free = 0.0
        for b in reversed(range(n_buckets)):
            ag_free += ag_times[b]          # AGs serialize on the wire
            compute_free = max(compute_free, ag_free) + fwd_t[b]
        exposed += max(0.0, compute_free - t_fwd)
        t_gather += sum(ag_times)
        if gather == "per_group":
            # backward re-gathers group b before its backward compute —
            # the stalls stretch the effective backward timeline
            rag_free = 0.0
            bfree = 0.0
            ready = []
            for b in range(n_buckets):
                rag_free += ag_times[b]
                bfree = max(bfree, rag_free) + bt[b]
                ready.append(bfree)
            t_bwd_eff = bfree
            t_gather += sum(ag_times)
        else:                               # 'ahead': retain, no re-gather
            ready = list(np.cumsum(bt))
            t_bwd_eff = t_backward_s
    else:
        ready = list(np.cumsum(bt))
        t_bwd_eff = t_backward_s

    # -- gradient collective, overlapped with the (effective) backward --
    free = 0.0
    t_comm = 0.0
    for b, payload in enumerate(plan.bucket_bytes(dtype_bytes)):
        pred = cost.predict_reduce_scatter if sharded else cost.predict
        c = pred(schedule, axes, sizes, payload,
                 n_buckets=1, links=links).time_s
        free = max(float(ready[b]), free) + c
        t_comm += c
    exposed += max(0.0, free - t_bwd_eff) + (t_bwd_eff - t_backward_s)

    if not sharded:
        t_update = cost.lars_update_time_s(n_elems, 1, hw=hw)
        mode = "allreduce"
    else:
        _, n_shards = cost.shard_axis_size(axes, sizes)
        t_update = cost.lars_update_time_s(n_elems, n_shards, hw=hw)
        if sharding == "zero3":
            mode = ("zero3_jit_gather" if gather == "per_group"
                    else "zero3_retain")
        elif sharding == "zero2":
            t_gather = sum(ag_times)
            exposed += t_gather          # step-end fp32 AG, fully exposed
            mode = "zero2"
        elif gather == "ahead":
            t_gather = sum(ag_times)
            t_fwd = _forward_budget(t_backward_s, profile, t_forward_s)
            exposed += max(0.0, t_gather - t_fwd)
            mode = "shard_update+gather_ahead"
        else:
            t_gather = sum(ag_times)
            exposed += t_gather
            mode = "shard_update"
        t_comm += t_gather
    eff = min(1.0, max(0.0, 1.0 - exposed / t_comm)) if t_comm > 0 else 1.0
    return OverlapSim(t_backward_s=t_backward_s, t_comm_s=t_comm,
                      t_exposed_s=exposed,
                      t_step_s=t_backward_s + exposed + t_update,
                      overlap_eff=eff, t_update_s=t_update,
                      t_gather_s=t_gather, mode=mode)


def autotune(tree, *, schedule: str, axes: Sequence[str],
             sizes: Sequence[int], dtype_bytes: int = 2,
             t_backward_s: Optional[float] = None,
             family: Optional[str] = None,
             candidates: Sequence[float] = CANDIDATES_MB,
             links: Optional[Dict[str, cost.Link]] = None,
             profile: Optional[BackwardProfile] = None,
             shard_update: bool = False, gather_ahead: bool = True,
             param_dtype_bytes: int = 2,
             sharding: Optional[str] = None,
             gather: Optional[str] = None,
             hw: Optional[hw_mod.Hardware] = None) -> TunedPlan:
    """Best bucket size for one schedule on one mesh. ``tree`` is the
    parameter (descriptor) pytree the plans are built from; ``family``
    (configs ModelConfig.family) refines the backward-time default when no
    measured ``t_backward_s``/``profile`` is given; ``sharding='zero1'``
    prices the RS(g)+update/n+AG(p) timeline instead of AR(g)+update (the
    AG hidden behind the next forward when ``gather='ahead'``), and
    ``sharding='zero3'`` prices the AG-in-forward JIT-gather timeline
    (see :func:`simulate`). The deprecated ``shard_update``/
    ``gather_ahead`` booleans still resolve when the enum is absent."""
    sharding, gather = resolve_policy(sharding, gather,
                                      shard_update=shard_update,
                                      gather_ahead=gather_ahead)
    if t_backward_s is None:
        if profile is not None:
            t_backward_s = profile.total_s
        else:
            n_params = sum(math.prod(leaf.shape)
                           for leaf in tree_leaves(tree))
            t_backward_s = estimate_backward_time(
                n_params, flops_per_param=backward_flops_per_param(family),
                hw=hw)
    best = None
    for mb in candidates:
        plan = bucketing.make_plan(tree, bucket_mb=mb,
                                   dtype_bytes=dtype_bytes)
        sim = simulate(plan, schedule, axes, sizes, dtype_bytes=dtype_bytes,
                       t_backward_s=t_backward_s, links=links,
                       profile=profile, sharding=sharding, gather=gather,
                       param_dtype_bytes=param_dtype_bytes, hw=hw)
        key = (sim.t_step_s, plan.n_buckets)
        if best is None or key < best[0]:
            best = (key, TunedPlan(schedule=schedule, bucket_mb=mb,
                                   plan=plan, sim=sim))
    assert best is not None, "empty candidate list"
    return best[1]


def best_plan(tree, *, axes: Sequence[str], sizes: Sequence[int],
              schedules: Optional[Sequence[str]] = None,
              dtype_bytes: int = 2, t_backward_s: Optional[float] = None,
              family: Optional[str] = None,
              links: Optional[Dict[str, cost.Link]] = None,
              profile: Optional[BackwardProfile] = None,
              shard_update: bool = False, gather_ahead: bool = True,
              param_dtype_bytes: int = 2,
              sharding: Optional[str] = None,
              gather: Optional[str] = None,
              hw: Optional[hw_mod.Hardware] = None) -> TunedPlan:
    """Joint (schedule x bucket size) search over every registered schedule
    that has a cost model."""
    if schedules is None:
        from repro_torch.comm.registry import available
        schedules = available()
    sharding, gather = resolve_policy(sharding, gather,
                                      shard_update=shard_update,
                                      gather_ahead=gather_ahead)
    best = None
    for s in schedules:
        try:
            t = autotune(tree, schedule=s, axes=axes, sizes=sizes,
                         dtype_bytes=dtype_bytes, t_backward_s=t_backward_s,
                         family=family, links=links, profile=profile,
                         sharding=sharding, gather=gather,
                         param_dtype_bytes=param_dtype_bytes, hw=hw)
        except KeyError:          # registered but uncosted schedule
            continue
        key = (t.sim.t_step_s, t.n_buckets)
        if best is None or key < best[0]:
            best = (key, t)
    assert best is not None, \
        f"no costed schedule among {list(schedules)!r}"
    return best[1]
