"""Where a training step's time goes, on the card.

Drives the port's replicated step (full-width ResNet-50 by default) and
prints one JSON object:

* ``step_ms``: host clock around whole steps ending in a device sync
  (median and quartiles over ``--steps``), images/s, peak memory;
* ``phase_ms``: CUDA-event times of the step's three phases, run one after
  another: forward (loss), backward (``autograd.grad``), optimizer
  (``lars.update``, with the batched-norm kernel or without);
* ``profile``: from ``torch.profiler`` over ``PROFILE_STEPS`` steps, the
  device time per kernel group and the device's idle share of the window
  (1 − the union of kernel intervals over the window's span).

  PYTHONPATH=src python -m repro_torch.launch.profile_step --batch 64
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.core import lars
from repro_torch.core.precision import cast_to_compute
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.state import init_state
from repro_torch.train.step import make_loss_fn, make_train_step
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

WARMUP, PROFILE_STEPS = 3, 3

#: kernel-name substrings -> group, first match wins
GROUPS = (("batched_sumsq", ("chunk_sumsq", "segment_sum")),
          ("convolution", ("conv", "cudnn", "xmma", "sm90_", "implicit",
                           "wgrad", "dgrad", "fprop", "gemm", "cutlass")),
          ("reduction", ("reduce",)),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("copy/cast", ("copy", "cat", "memset", "fill")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"p25": q[0], "median": statistics.median(xs), "p75": q[2]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-sized ResNet (for a CPU rehearsal)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--no-kernel", action="store_true",
                    help="per-tensor LARS norms instead of the kernel")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("resnet50")
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    opt = lars.OptConfig(use_kernel=not args.no_kernel)
    sched = make_schedule(ScheduleConfig(base_lr=0.1,
                                         total_steps=10 ** 6))
    step = make_train_step(model, opt, sched)
    batch_fn = make_batch_fn(cfg, InputShape("p", "train", 0, args.batch),
                             device=dev)
    state = init_state(model, 0, device=dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    for i in range(WARMUP):
        state, _ = step(state, batch_fn(i))
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(args.steps):
        batch = batch_fn(i)
        sync()
        t = time.perf_counter()
        state, _ = step(state, batch)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = _quartiles(times)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "arch": cfg.arch_id, "batch": args.batch,
           "use_kernel": opt.use_kernel, "steps": args.steps,
           "step_ms": step_ms,
           "images_per_s": args.batch / step_ms["median"] * 1e3,
           "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)}

    if dev.type == "cuda":
        out["phase_ms"] = _phases(model, opt, state, batch_fn(0), dev)
        out["profile"] = _profile(step, state, batch_fn, PROFILE_STEPS, dev)
    print(json.dumps(out), flush=True)
    return out


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


def _profile(step, state, batch_fn, n: int, dev):
    from torch.profiler import ProfilerActivity, profile
    batches = [batch_fn(i) for i in range(n)]
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            state, _ = step(state, b)
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
    groups, names = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        g = _group(e.name)
        groups[g] = groups.get(g, 0.0) + d
        names[e.name] = names.get(e.name, 0.0) + d
    top = sorted(names.items(), key=lambda t: -t[1])[:12]
    return {"steps": n, "window_ms": window / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / window,
            "kernels": len(kernels),
            "group_ms_per_step": {g: v / 1e3 / n for g, v in
                                  sorted(groups.items(), key=lambda t: -t[1])},
            "top_kernels_ms_per_step": [[k[:90], v / 1e3 / n]
                                        for k, v in top]}


if __name__ == "__main__":
    main()
