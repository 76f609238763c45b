#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port still builds, is right and trains.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. card     needs CUDA; prints the card's name and power limit
  2. build    compiles every CUDA kernel from the checkout (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the training path gives it; times the kernel, the
              plain version and a library yardstick beside the bound
  4. slice    full-width ResNet-50 (224², 1000 classes, width 64), batch 64,
              6 LARS steps (poly2, label smoothing 0.1, bf16 compute, fp32
              masters, OptConfig(use_kernel=True)) through make_train_step +
              loop.train; every kernel must be launched on this path
  5. context  one step with the norm kernel and one without, from one state
              and batch: the new params agree to 1e-5
  6. cli      python -m repro_torch.launch.train --reduced on the card
Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s, and f32
#: operations/s outside the tensor cores (the kernels square and add in f32)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BATCH, STEPS = 64, 6


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str):
    print(f"== {name}", flush=True)


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Device time per call from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: int, f32_ops: int):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_batched_sumsq(dev):
    """K1 at the training path's shape (ResNet-50's plan) in f32 and bf16,
    plus a ragged case with empty segments; timings at the f32 shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.kernels import batched_norm, ref
    from repro_torch.models import resnet
    from repro_torch.tree import tree_leaves

    plan = bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0])
    seg = torch.from_numpy(bucketing.segment_ids(plan)).to(dev)
    n_chunks, n_tensors = seg.numel(), plan.n_tensors
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n_chunks * bucketing.CHUNK, generator=gen,
                        device=dev).to(dtype)
        cases[str(dtype).split(".")[1]] = (x, seg, n_tensors)
    rag = torch.sort(torch.tensor([0, 2, 3, 9], device=dev)[torch.randint(
        0, 4, (3000,), generator=gen, device=dev)]).values.int()
    cases["ragged_f32"] = (torch.randn(3000 * bucketing.CHUNK, generator=gen,
                                       device=dev), rag, 11)
    errs = {}
    for name, (x, s, n) in cases.items():
        got = batched_norm.batched_sumsq(x, s, n)
        want = ref.batched_sumsq(x, s, n)
        torch.cuda.synchronize()
        abs_err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        print(f"batched_sumsq {name}: {x.numel() // bucketing.CHUNK} chunks "
              f"x {n} segments, max abs err {abs_err:.3e}, max rel err "
              f"{rel:.3e} (rtol 2e-3)", flush=True)
        if not rel <= 2e-3:
            fail(f"batched_sumsq {name} disagrees with its plain version")
        errs[name] = (abs_err, rel)

    x, s, n = cases["float32"]
    # the yardstick computes the same norms from the unpacked tensors
    leaves = tree_leaves(bucketing.unpack(list(x.split(plan.bucket_sizes)),
                                          plan))
    ms = time_ms(lambda: batched_norm.batched_sumsq(x, s, n))
    plain = time_ms(lambda: ref.batched_sumsq(x, s, n))
    library = time_ms(lambda: torch._foreach_norm(leaves))
    bf16_ms = time_ms(lambda: batched_norm.batched_sumsq(
        *cases["bfloat16"][:2], n))
    b_ms, b_by = bound_ms(x.numel() * 4 + s.numel() * 4 + n * 4,
                          2 * x.numel())
    b16_ms, _ = bound_ms(x.numel() * 2 + s.numel() * 4 + n * 4,
                         2 * x.numel())
    print(f"batched_sumsq f32 {n_chunks} chunks: kernel {ms * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, torch._foreach_norm "
          f"{library * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}); "
          f"bf16: kernel {bf16_ms * 1e3:.1f} us, bound {b16_ms * 1e3:.1f} us",
          flush=True)
    return {"name": "batched_sumsq", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/batched_norm.cu",
            "replaces": "src/repro/kernels/batched_norm.py:44",
            "launches": None, "max_abs_err": errs["float32"][0],
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library, "library": "torch._foreach_norm",
            "shape": [n_chunks * bucketing.CHUNK], "segments": n,
            "dtype": "float32", "bf16_ms": bf16_ms, "bf16_bound_ms": b16_ms}


def run_slice(dev):
    """Full-width ResNet-50 through the port's entry points, as
    examples/train_resnet_imagenet.py drives the JAX package."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn, prototype_imagenet
    from repro_torch.kernels import batched_norm
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_eval_step, make_train_step

    cfg = get_config("resnet50")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH) / 4, warmup_steps=STEPS // 8,
        total_steps=STEPS, decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    train_step = make_train_step(model, opt, sched, smoothing=0.1)
    batch_fn = make_batch_fn(cfg, InputShape("in", "train", 0, BATCH),
                             device=dev)
    state0 = init_state(model, seed=100000, device=dev)

    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    batched_norm.batched_sumsq.launches = 0
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state0, timed_step, batch_fn,
                                    steps=STEPS, log_every=1, seed=100000)
    launches = batched_norm.batched_sumsq.launches
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in history]
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"losses not all finite: {losses}")
    if launches != 2 * STEPS:
        fail(f"batched_sumsq launched {launches} times in {STEPS} steps; "
             f"the path must launch it twice a step (params, grads)")
    if not sink.find("run_stop"):
        fail("loop.train did not reach run_stop")
    ev = make_eval_step(model)(state.params, prototype_imagenet(
        cfg, batch=BATCH, step=10 ** 6, seed=100000, device=dev),
        state.bn_state)
    if not (math.isfinite(float(ev["loss"])) and 0 <= float(ev["acc"]) <= 1):
        fail(f"eval step gave {ev}")
    med = statistics.median(times)
    print(f"slice: losses {[round(v, 4) for v in losses]}", flush=True)
    print(f"slice: step times ms {[round(t * 1e3, 2) for t in times]}; "
          f"median {med * 1e3:.2f} ms, {BATCH / med:.1f} images/s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; batched_sumsq launches "
          f"{launches}", flush=True)
    return state0, batch_fn, launches


def check_in_context(dev, state0, batch_fn):
    """One step from one state and batch with the norm kernel and one with
    the per-tensor norms: LARS must give the same params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    model = build_model(get_config("resnet50"))
    sched = make_schedule(ScheduleConfig(base_lr=1.0, total_steps=STEPS))
    batch = batch_fn(0)
    torch.backends.cudnn.deterministic = True
    try:
        out = {k: make_train_step(model, lars.OptConfig(use_kernel=k),
                                  sched)(state0, batch)[0].params
               for k in (True, False)}
    finally:
        torch.backends.cudnn.deterministic = False
    worst, moved = 0.0, 0.0
    for (_, a), (_, b) in zip(tree_flatten(out[True]),
                              tree_flatten(out[False])):
        scale = b.abs().max().item()
        worst = max(worst, (a - b).abs().max().item() / max(scale, 1e-30))
    for (_, a), (_, b) in zip(tree_flatten(out[True]),
                              tree_flatten(state0.params)):
        moved = max(moved, (a - b).abs().max().item())
    print(f"context: kernel vs per-tensor norms, worst param difference "
          f"{worst:.3e} of the tensor's max (limit 1e-5); largest update "
          f"{moved:.3e}", flush=True)
    if not worst <= 1e-5 or moved == 0.0:
        fail("the step with the norm kernel disagrees with the plain step")


def run_cli():
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "resnet50", "--reduced", "--steps", "2", "--batch", "8"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(SRC)))
    print(out.stdout[-2000:], end="", flush=True)
    if out.returncode != 0 or "run_stop" not in out.stdout:
        fail(f"CLI exited {out.returncode}: {out.stderr[-3000:]}")


def main():
    import torch
    phase("card")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import backend
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    dev = backend.resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("build")
    t = time.time()
    built = backend.build()
    print(f"built {sorted(built) or 'nothing (current)'} in "
          f"{time.time() - t:.1f} s", flush=True)

    phase("kernels")
    k1 = check_batched_sumsq(dev)

    phase("slice")
    state0, batch_fn, k1["launches"] = run_slice(dev)

    phase("context")
    check_in_context(dev, state0, batch_fn)

    phase("cli")
    run_cli()

    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
