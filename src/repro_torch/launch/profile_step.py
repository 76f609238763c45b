"""Where a training step's time goes, on the card.

Drives the port's replicated step (full-width ResNet-50 by default; with
``--arch qwen1.5-0.5b`` the dense LM, batch 2 x seq 4096 of lcg tokens,
remat on, its loss through the smoothed cross-entropy kernel K4) or an
explicit-DP step over every rank of the job (one without ``torchrun``):
``--comm`` names the schedule (default psum), ``--sharding
zero1|zero2|zero3`` the rung (4 MB buckets, in-backward collectives, the
fused update kernel K2 unless ``--no-kernel``), ``--pods N`` lays the
ranks out as the ``(pod, data)`` mesh (else ``(data, model=1)``) and
``--ring-kernel`` runs the ring folds through K3
(``CommConfig.use_kernel``). It prints one JSON object (one per rank):

* ``step_ms``: host clock around whole steps ending in a device sync
  (median and quartiles over ``--steps``), images/s (tokens/s for an LM;
  over every rank), peak memory, and the launches a step of K3 (the
  ring-step fold), K1 and K2 in the timed steps;
* ``phase_ms``: CUDA-event times of the step's phases, run one after
  another: forward (loss), backward (``autograd.grad``), optimizer
  (``lars.update``, with the batched-norm kernel or without); for zero1
  also the gather ahead, with the reduce-scatters inside the backward and
  the sharded update (K1 + K2) as the optimizer; none for the replicated
  explicit step;
* ``profile``: from ``torch.profiler`` over ``PROFILE_STEPS`` steps, the
  device time per kernel group and the device's idle share of the window
  (1 − the union of kernel intervals over the window's span), kernels a
  step.

  PYTHONPATH=src python -m repro_torch.launch.profile_step --batch 64
  PYTHONPATH=src python -m repro_torch.launch.profile_step \\
      --arch qwen1.5-0.5b --seq 4096 --batch 2 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.profile_step --batch 64 \\
      --sharding zero1
  PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
      repro_torch.launch.profile_step --batch 256 --comm psum   # 64 a card
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 -m \\
      repro_torch.launch.profile_step --batch 256 --comm 2d_torus \\
      --pods 2 --ring-kernel
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from repro_torch.comm import ring_kernel
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core import ddp, lars
from repro_torch.core.precision import cast_to_compute
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.kernels import batched_norm, lars_update
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.launch.train import SCHEDULES
from repro_torch.models.registry import build_model
from repro_torch.train.state import init_state, sharded_state_kwargs
from repro_torch.train.step import make_loss_fn, make_train_step
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

WARMUP, PROFILE_STEPS = 3, 3

#: kernel-name substrings -> group, first match wins
GROUPS = (("batched_sumsq", ("chunk_sumsq", "segment_sum")),
          ("lars_packed_update", ("lars_update",)),
          ("ring_add_step", ("ring_add",)),
          ("nccl", ("nccl",)),
          ("convolution", ("conv", "cudnn", "xmma", "sm90_", "implicit",
                           "wgrad", "dgrad", "fprop", "gemm", "cutlass")),
          ("reduction", ("reduce",)),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("copy/cast", ("copy", "cat", "memset", "fill")))
#: the same for an LM step: the loss kernel K4 on its own, the matmuls
#: (cuBLAS's nvjet_* among them), the chunked attention's softmax parts;
#: copies and casts ahead of the elementwise group, whose launcher
#: templates (elementwise_kernel<..., direct_copy_kernel_cuda>) they share
LM_GROUPS = (("smoothed_xent", ("smoothed_xent",)),
             ("batched_sumsq", ("chunk_sumsq", "segment_sum")),
             ("gemm", ("gemm", "nvjet", "cutlass", "sm90_", "xmma", "cublas",
                       "gemv")),
             ("softmax", ("softmax",)),
             ("reduction", ("reduce",)),
             ("copy/cast/index", ("copy", "cat", "memset", "fill",
                                  "index", "scatter", "gather")),
             ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _group(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def quartiles(xs):
    if len(xs) < 2:
        return {"median": xs[0] if xs else None}
    q = statistics.quantiles(xs, n=4)
    return {"p25": q[0], "median": statistics.median(xs), "p75": q[2]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet50",
                    choices=["resnet50", "qwen1.5-0.5b"])
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-sized model (for a CPU rehearsal)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 64 images, or 2 sequences for an LM")
    ap.add_argument("--seq", type=int, default=4096,
                    help="LM sequence length")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--no-kernel", action="store_true",
                    help="per-tensor LARS norms instead of the kernel; "
                         "zero1: the plain packed update instead of K2 "
                         "(its trust norms always run K1)")
    ap.add_argument("--sharding", default="replicated",
                    choices=["replicated", "zero1", "zero2", "zero3"])
    ap.add_argument("--comm", default=None, choices=["xla", *SCHEDULES],
                    help="default: 'psum' with a sharded rung or --pods, "
                         "else 'xla'; an explicit schedule runs over every "
                         "rank of the job (torchrun)")
    ap.add_argument("--pods", type=int, default=1,
                    help="lay the ranks out as the (pod, data) mesh with "
                         "this many pods")
    ap.add_argument("--ring-kernel", action="store_true",
                    help="ring folds through the kernel K3 "
                         "(CommConfig.use_kernel)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    explicit = args.sharding != "replicated" or args.pods > 1
    comm = args.comm or ("psum" if explicit else "xla")
    if comm in ("xla", "naive") and args.sharding != "replicated":
        ap.error(f"--sharding {args.sharding} needs a bucketed schedule "
                 f"(--comm)")
    if comm == "xla" and (args.pods > 1 or args.ring_kernel):
        ap.error("--pods and --ring-kernel need an explicit schedule "
                 "(--comm)")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lm = cfg.family != "conv"
    if args.batch is None:
        args.batch = 2 if lm else 64
    model = build_model(cfg)
    opt = lars.OptConfig(use_kernel=not args.no_kernel)
    sched = make_schedule(ScheduleConfig(base_lr=0.1,
                                         total_steps=10 ** 6))
    mesh = None
    if comm != "xla":
        if args.pods > 1:
            world = int(os.environ.get("WORLD_SIZE", 1))
            mesh = make_mesh((args.pods, world // args.pods),
                             ("pod", "data"), device=args.device)
        else:
            mesh = make_local_mesh(device=args.device)
        dev = mesh.device
        step = make_train_step(model, opt, sched, mesh=mesh, comm=CommConfig(
            strategy=comm, sharding=args.sharding, overlap=True,
            update_kernel=not args.no_kernel, use_kernel=args.ring_kernel,
            bucket_mb=4))
        state = init_state(model, 0, device=dev,
                           **sharded_state_kwargs(step))
    else:
        step = make_train_step(model, opt, sched)
        state = init_state(model, 0, device=dev)
    batch_fn = make_batch_fn(cfg, InputShape("p", "train", args.seq if lm
                                             else 0, args.batch),
                             device=dev, mesh=mesh)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    for i in range(WARMUP):
        state, _ = step(state, batch_fn(i))
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counters = (ring_kernel.ring_add_step, batched_norm.batched_sumsq,
                lars_update.lars_packed_update)
    for c in counters:
        c.launches = 0
    times = []
    for i in range(args.steps):
        batch = batch_fn(i)
        sync()
        t = time.perf_counter()
        state, _ = step(state, batch)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = quartiles(times)
    launches = {name: c.launches / args.steps for name, c in
                zip(("k3_ring_add_step", "k1_batched_sumsq",
                     "k2_lars_packed_update"), counters)}
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "arch": cfg.arch_id, "batch": args.batch,
           "comm": comm, "sharding": args.sharding,
           "ranks": mesh.size if mesh else 1,
           "mesh": (dict(zip(mesh.axis_names, [a.size for a in mesh.axes]))
                    if mesh else None),
           "rank": mesh.rank if mesh else 0,
           "use_kernel": opt.use_kernel, "ring_kernel": args.ring_kernel,
           "launches_per_step": launches,
           "seq": args.seq if lm else None, "remat": cfg.remat,
           "steps": args.steps,
           "step_ms": step_ms,
           ("tokens_per_s" if lm else "images_per_s"):
               args.batch * (args.seq if lm else 1) / step_ms["median"] * 1e3,
           "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)}

    if dev.type == "cuda":
        if comm == "xla":
            out["phase_ms"] = _phases(model, opt, state, batch_fn(0), dev)
        elif args.sharding == "zero1":
            out["phase_ms"] = _phases_zero1(model, opt, state, batch_fn(0),
                                            dev, step)
        out["profile"] = _profile(step, state, batch_fn, PROFILE_STEPS, dev,
                                  LM_GROUPS if lm else GROUPS)
    if mesh is not None:
        mesh.destroy()
    print(json.dumps(out), flush=True)
    return out


def _phases_zero1(model, opt, state, batch, dev, step, reps: int = 5):
    """Median CUDA-event time of the ZeRO-1 step's phases: the gather
    ahead, the forward, the backward (with the in-backward
    reduce-scatters) and the sharded update (K1 trust norms + K2)."""
    loss_fn = make_loss_fn(model)
    plan, axes = step.bucket_plan, step.mesh.axes
    axis = step.mesh.axis(step.shard_axis)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    acc = {"gather": [], "forward": [], "backward": [], "optimizer": []}
    for _ in range(reps):
        shards = [x.clone() for x in state.shards]
        mom = [x.clone() for x in state.mom]
        e = [ev() for _ in range(5)]
        e[0].record()
        params = ddp.gather_ahead_params(shards, plan, shard_axis=axis)
        e[1].record()
        sinks = ddp.make_shard_sinks(plan, step.n_shards, device=dev)
        p = ddp.wrap_params_for_overlap(params, plan, strategy=step.comm,
                                        axes=axes, shard_sinks=sinks)
        total, _ = loss_fn(p, batch, state.bn_state)
        e[2].record()
        g_shards = torch.autograd.grad(total, sinks)
        e[3].record()
        lars.sharded_update_from_shards(
            shards, list(g_shards), mom, 0.1, opt, plan, shard_axis=axis,
            n_shards=step.n_shards, update_kernel=opt.use_kernel)
        e[4].record()
        torch.cuda.synchronize(dev)
        for k, (a, b) in zip(acc, zip(e, e[1:])):
            acc[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in acc.items()}


def _phases(model, opt, state, batch, dev, reps: int = 5):
    """Median CUDA-event time of forward, backward and optimizer."""
    loss_fn = make_loss_fn(model)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    acc = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(reps):
        e = [ev() for _ in range(4)]
        p_in = tree_map(lambda p: p.detach().requires_grad_(),
                        cast_to_compute(state.params))
        flat = tree_flatten(p_in)
        e[0].record()
        total, _ = loss_fn(p_in, batch, state.bn_state)
        e[1].record()
        grads = torch.autograd.grad(total, [x for _, x in flat])
        e[2].record()
        lars.update(state.params, tree_unflatten([p for p, _ in flat], grads),
                    state.mom, 0.1, opt)
        e[3].record()
        torch.cuda.synchronize(dev)
        for k, (a, b) in zip(acc, zip(e, e[1:])):
            acc[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in acc.items()}


def _profile(step, state, batch_fn, n: int, dev, groups):
    batches = [batch_fn(i) for i in range(n)]

    def run():
        s = state
        for b in batches:
            s, _ = step(s, b)

    return device_profile(run, dev, n, groups)


def device_profile(fn, dev, steps: int, groups=GROUPS):
    """``torch.profiler`` over ``fn()`` (``steps`` steps): device time by
    kernel group (``groups``: name substrings, first match wins) and by
    kernel, and the device's idle share of the window (1 - the union of
    kernel intervals over the window's span)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"error": "the profiler recorded no device time"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_group, names = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        g = _group(e.name, groups)
        by_group[g] = by_group.get(g, 0.0) + d
        names[e.name] = names.get(e.name, 0.0) + d
    top = sorted(names.items(), key=lambda t: -t[1])[:12]
    return {"steps": steps, "window_ms": window / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / window,
            "kernels": len(kernels), "kernels_per_step": len(kernels) / steps,
            "group_ms_per_step": {g: v / 1e3 / steps for g, v in
                                  sorted(by_group.items(),
                                         key=lambda t: -t[1])},
            "top_kernels_ms_per_step": [[k[:90], v / 1e3 / steps]
                                        for k, v in top]}


if __name__ == "__main__":
    main()
