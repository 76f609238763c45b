#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``src/repro_torch``) on NVIDIA
cards: the quickest proof that the port still builds, is right and trains.
One card is enough; with two or more it also drives the multi-card ring
phases.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. card     needs CUDA; prints the card's name and power limit
  2. build    compiles every CUDA kernel from the checkout (one nvcc per
              source, all started together; sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the training and serving paths give it (K5 also at
              a GQA, a windowed, an MLA and a peaked-softmax shape); times
              the kernel, the plain version and a library yardstick beside
              the bound
  4. slice    full-width ResNet-50 (224², 1000 classes, width 64), batch 64,
              6 LARS steps (poly2, label smoothing 0.1, bf16 compute, fp32
              masters, OptConfig(use_kernel=True)) through make_train_step +
              loop.train, comm='xla'; K1 must be launched twice a step
  5. context  one step with the norm kernel and one without, from one state
              and batch: the new params agree to 1e-5
  6. zero1    the same model and recipe as the ZeRO-1 explicit-DP step on a
              one-rank NCCL group (psum schedule, 4 MB buckets: 16, gather
              ahead, in-backward reduce-scatter, fused update): K2 must be
              launched once a step (one call over every bucket's p, g and
              m shards) and K1 once (one call over every bucket's p and g
              shards); an eval through make_params_reader
  7. zero1 context  one ZeRO-1 step (K1 + K2) and one replicated comm='xla'
              step (per-tensor norms, no kernel) from one state and batch:
              the masters agree to 1e-5 of each tensor's max
  8. durability  the zero1 path's step (K1 + K2) through loop.train at
              full width: a checkpoint after 2 steps with its CommPlan
              (verified, sha256, loaded back bit for bit; payload MB, save
              and load ms), reshard_buffers of the masters and momentum 4 MB
              / 1 -> 4 shards -> 1 MB plan -> 1 shard -> 4 MB bit-equal, an
              elastic resume from a 1 MB-plan checkpoint and a step; a
              guarded nan@2 run of 6 steps (one guard_skip) against the
              uninjected run, masters bit for bit under
              torch.use_deterministic_algorithms (or 1e-5 of the max, the
              op named, where one has no deterministic form), spike@3:1e4
              (a guard_rollback, finite losses); 3 traced steps (forward,
              backward, update, rs[b0..15] and ag[b0..15] in each step
              window of a valid Chrome JSON); the step ms unguarded,
              guarded and traced, interleaved, and a rollback snapshot's
              ms. K1 and K2 must read one launch a committed step call
              (none on a skipped one)
  9. cli      python -m repro_torch.launch.train --reduced on the card, as
              the replicated step and as ZeRO-1 (--comm ring --sharding
              zero1 --update-kernel); then on the ZeRO-1 run with
              --ckpt-every 1: kill@3 (SIGKILL) and a --resume-elastic rerun
              from step 3, sigterm@3 (drained, step 4 saved once, exit 0),
              stall@2:3 with --step-timeout-s 1 (watchdog_restore), and
              corrupt@2 with --metrics and --trace (the load falls back to
              step 1, every tag line in the JSONL, a valid Chrome trace)
 10. serve    full-width qwen1.5-0.5b (24 layers, d 1024, 16 heads of 64,
              vocab 151,936; params from pinit) with flash_attention=True:
              serve.decode.generate on 8 prompts of 2048 tokens, 32 greedy
              tokens, cache_len 2088; the flash kernel (K5) must be launched
              24 times (once a layer, in the prefill); prints prefill ms,
              decode ms a token, tokens/s and peak memory
 11. serve context  from the same params and prompts: the K5 prefill's last
              logits against the chunked path's (no kernel), and one decode
              step from the K5 cache against the chunked full forward over
              prompt + that token, both within 3e-2 of the logit max
 12. serve cli  python -m repro_torch.serve.decode --reduced --flash-attention
              on the card
 13. lm_train  full-width qwen1.5-0.5b (params from pinit; remat on, the
              chunked attention: flash_attention stays off in training),
              batch 2 x seq 4096 of lcg tokens, 5 LARS steps (poly2 with
              warm-up, label smoothing 0.1, OptConfig(use_kernel=True))
              through make_train_step + loop.train, then one eval: the
              smoothed cross-entropy kernel (K4) must be launched once
              forward and once backward a step and once for the eval, K1
              twice a step; prints step ms, tokens/s, peak memory, losses
 14. lm_train context  one step with the K4 loss and two with a loss built
              on K4's plain version, from one state and batch: losses to
              1e-5 relative, K4's gradient at the step's logits to rtol
              1e-5 / atol 1e-7, the plain steps bit for bit, new params to
              5e-2 of each tensor's largest update (bf16 gradients: not
              1e-5 of its max, the function says why)
 15. ring     on two or more cards (min(count, 4) ranks, one card each,
              over NCCL: this script under torch.distributed.run with
              --ring-rank), full-width ResNet-50, batch 64 a card, the slice's
              recipe, CommConfig(use_kernel=True, update_kernel=True), 3
              steps each through make_train_step + loop.train: ring
              replicated, zero1, zero2 and zero3 (per_group) on (data n,
              model 1), and on four cards ring, hierarchical, 2d_torus and
              dbtree on (pod 2, data 2). The ring-step kernel (K3) must fold
              16 x (ranks - 1) times a step along each ring axis (48 on data
              4; 32 for ring and 2d_torus, 16 for hierarchical on the pod
              mesh, 0 for dbtree), K1 twice a replicated step and once a
              sharded one, K2 once a sharded step; prints step ms
              (median after the first step), images/s over all cards and
              peak memory per rank
 16. ring context  one packed bf16 gradient through the ring all-reduce and
              every schedule's reduce-scatter form, with K3 and with the
              plain fold: bit-equal (counted apart for the forms that fold
              through K3: ring, hierarchical, 2d_torus); with f32 wire, every schedule and rung
              against the replicated psum step from one state and batch:
              masters within 1e-5 of each tensor's max
 17. lm_ring  on four cards (this script under torch.distributed.run with
              --lm-ring-rank, one rank a card, NCCL): the card's link
              (alpha, beta of a ring exchange), HBM and bf16 matmul rates
              measured (launch/hw.measure) and held within 2x of
              launch/hw.py's; full-width qwen1.5-0.5b (remat, the chunked
              attention), batch 2 x seq 4096 a card, lcg tokens, LARS poly2,
              OptConfig(use_kernel=True), 4 MB buckets (224, 222 split
              spans): psum replicated (the anchor), ring replicated with
              K3, ring zero1 with K3 and K2, ring zero3 per_group with K3
              and K2, each one warm-up step on a copy of its state and 2
              timed steps through make_train_step + loop.train; K3 672
              folds a ring step, K1 2 a replicated step and 1 a sharded
              one, K2 1 a sharded step, K4 1 + 1 (2 + 1 under zero3's
              checkpointed loss); every configuration's masters within
              5e-2 of the anchor's largest update; prints step ms,
              tokens/s over the cards and peak memory a rank; ring zero1's
              state saved (every rank's rows gathered, rank 0 writing).
              Then bucket_mb='auto' with backward_profile='measured' on
              ring zero1, for the LM and for ResNet-50 (batch 64 a card):
              the chosen bucket size, the simulated and the measured step
              time, and obs.drift's measured / predicted per span kind
              over 3 traced steps; the profile must be the measured one
 18. lm_ring resume  the four-card ring zero1 checkpoint resumed on one
              card (elastic.load_resharded, 4 -> 1 shards over the LM's
              split-leaf plan): masters bit-equal to the gathered rows
              (sha256), then one step with a finite loss (K1, K2, K4)
On one card the ring phases print that they need two or more cards and
were not run, and K3's launches_by_path has "ring": null; with fewer than
four, lm_ring and its resume are not run and every kernel's
launches_by_path has "lm_ring" and "lm_resume" null. The kernels
phase also holds K1's multi-buffer form (the sharded step's one call)
against its plain version at the 4 MB and 0.25 MB plans' shards, K2's
(the sharded step's one update call) against its plain version and, bit
for bit, against its per-bucket launches at the 4 MB plan on 1 and 4
shards and the 0.25 MB plan on 3 (every rank), timing it at 1 and 4
shards beside the per-bucket launches and one launch over the shards
concatenated, K1's and K2's one call at the four-card LM step's shard
site (qwen1.5-0.5b's 224 buckets on 4 shards, rank 0: two launches
inside each call), K4, forward and backward, against its plain version (at the path's shape in
f32 and bf16, at T 16 x V 333, and with IGNORE labels), beside
F.cross_entropy, and K3, bit for bit, at the ring's chunk rows (the
path's largest and smallest on 4 and 2 ranks, bf16 and f32, every k, by
the wrapper and by the fold the ring binds once a bucket), the
reference's shapes, ragged rows, misaligned views and in place, beside
torch.add; the cli phase also trains the reduced LM. Every
kernel's launch count is set to 0 just before each path (slice, zero1,
durability, serve, lm_train, each ring and lm_ring configuration and
autotune run, the lm_ring resume) and read just after: a kernel the path
runs must show its count, every other kernel 0, and the JSON
line's launches_by_path holds these readings.
Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, which must be set
# before it first runs: the durability phase replays runs bit for bit under
# torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s, f32
#: operations/s outside the tensor cores (K1 and K2 square and add in f32;
#: K5 on f32 inputs), and the bf16 dense tensor-core rate (K5 on bf16
#: inputs: the least time any kernel could take for that work)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

BATCH, STEPS = 64, 6

#: K5 shapes: (name, B, S, H, K, Dk, Dv, window, dtype, q scale), all
#: causal. "path" is the serving prefill's (qwen1.5-0.5b, 8 x 2048 tokens);
#: then the same in f32, qwen3-14b's GQA heads without and with a window,
#: MLA's dims, and the path's heads with q x 8 (a peaked softmax: large
#: corrections of the running max, P near 0 or 1)
FLASH_SHAPES = (("path", 8, 2048, 16, 16, 64, 64, 0, "bfloat16", 1),
                ("path_f32", 8, 2048, 16, 16, 64, 64, 0, "float32", 1),
                ("gqa", 2, 1024, 40, 8, 128, 128, 0, "bfloat16", 1),
                ("gqa_window", 2, 1024, 40, 8, 128, 128, 256, "bfloat16", 1),
                ("mla", 2, 1024, 16, 16, 192, 128, 0, "bfloat16", 1),
                ("peaked", 2, 2048, 16, 16, 64, 64, 0, "bfloat16", 8))
#: K5's route for each input dtype
FLASH_ROUTES = {"bfloat16": "tensor cores: mma.sync m16n8k16 bf16, P split "
                            "into bf16 hi + lo, cp.async K/V tiles",
                "float32": "CUDA cores: f32 FMA"}
#: (rtol, atol) of K5 against its plain version: f32 sums in another order;
#: in bf16 that may flip the output's rounding by one ulp (2^-7 relative)
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-5)}

#: the ring phases: steps a configuration, and their time limit
RING_STEPS = 3
RING_TIMEOUT_S = 420

#: K3's ragged (n, length) pairs: the reference's own ring-kernel test
#: (tests/test_comm.py), through the ring's zero-padded chunk view
RING_RAGGED = ((2, 1000), (3, 5000), (4, 4096), (8, 33000))

#: the serving path: 8 requests, 2048-token prompts, 32 new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
SERVE_CACHE = SERVE_PROMPT + SERVE_NEW + 8
#: K4 shapes: (name, T, V, dtype, IGNORE labels). "path" is the LM
#: training step's loss (2 x 4096 tokens of qwen1.5-0.5b's vocabulary, f32
#: logits); then the same in bf16, the reference test's ragged (16, 333),
#: and 1,024 path-width rows with every third label IGNORE
XENT_SHAPES = (("path", 8192, 151_936, "float32", False),
               ("path_bf16", 8192, 151_936, "bfloat16", False),
               ("ragged", 16, 333, "float32", False),
               ("ignore", 1024, 151_936, "float32", True))
#: (rtol, atol) of K4 against its plain version: the forward at the
#: reference's own tolerances (test_kernels.py); the backward against
#: autograd of the plain version, and one bf16 ulp where dx is bf16. The
#: backward's atol is per unit of the row's upstream gradient g (see
#: ``_dx_close``)
XENT_FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
XENT_BWD_TOL = {"float32": (1e-5, 1e-7), "bfloat16": (1e-2, 1e-7)}
#: f32 operations a logit: max, subtract, exp, add to the sum-exp, add to
#: the plain sum (forward); subtract, exp, two subtractions, multiply
#: (backward)
XENT_OPS = 5

#: the LM training path: the assigned train_4k sequence, its 256-sequence
#: global batch cut to one card's share
LM_BATCH, LM_SEQ, LM_STEPS = 2, 4096, 5
LM_LR = 4.0
#: K4 loss vs the plain version's, as the ResNet context checks hold
#: theirs; the new params against the update (check_lm_train_in_context
#: says why not against the tensor's max): about four times the 1.3e-2
#: measured on the H100
LM_CONTEXT_TOL = 1e-5
LM_UPDATE_TOL = 5e-2

#: the durability phase: steps of each run, the interleaved timing rounds,
#: snapshot timings, and the spike's magnitude (a grad-norm far past the
#: detector's 10x EMA)
DUR_STEPS, DUR_ROUNDS, DUR_SNAPSHOTS = 6, 8, 5
DUR_SPIKE = "spike@3:1e4"
#: the determinism rule's fallback: where an op of the path has no
#: deterministic form, a replayed run is held to 1e-5 of a tensor's max,
#: the gate check_zero1_in_context uses
DUR_TOL = 1e-5


#: the four-card LM phase (lm_ring): full-width qwen1.5-0.5b, batch
#: LM_BATCH x LM_SEQ a card, 4 MB bf16 buckets (224 of them, 222 split
#: spans), each configuration (schedule, sharding, gather) one warm-up
#: step on a copy of its state, then LM_RING_STEPS timed steps; psum
#: replicated is the anchor the others' masters are held against
LM_RING_CONFIGS = (("psum", "replicated", None),
                   ("ring", "replicated", None),
                   ("ring", "zero1", None),
                   ("ring", "zero3", "per_group"))
LM_RING_STEPS = 2
LM_RING_BUCKETS = 224
LM_RING_TIMEOUT_S = 600
LM_CKPT_TAG = "lm_zero1"
#: the card's constants measured in the phase against launch/hw.py's: a
#: figure more than this factor off fails
HW_TOL = 2.0

#: K5 prefill vs chunked prefill, and decode vs the full forward: two bf16
#: paths that round in different places, held to the reference's own bound
#: for decode against the full forward (tests/test_serve.py)
SERVE_TOL = 3e-2


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


def device_ms(fn, iters: int = 50):
    """Device time per call with the host's cost hidden: a sleep kernel
    holds the stream while the host queues ``iters`` calls, then CUDA
    events time them back to back on the device. None where the device
    caught up with the host before the last call was queued (the time
    would hold host gaps)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * iters)      # ~1 ms a call at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    hidden = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if hidden else None


def host_us(fn, iters: int = 20000) -> float:
    """Host time per call in microseconds, for calls that do no device
    work."""
    for _ in range(100):
        fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters * 1e6


def bound_ms(bytes_moved: int, ops: int, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _zero(*wrappers):
    for w in wrappers:
        w.launches = 0


def _counters():
    """Every kernel's wrapper, under the key of its entry in the kernels
    line; each adds one to its own ``launches`` where it launches."""
    from repro_torch.comm import ring_kernel
    from repro_torch.kernels import batched_norm, lars_update
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import smoothed_xent as sx
    return {"k1": batched_norm.batched_sumsq,
            "k2": lars_update.lars_packed_update,
            "k3": ring_kernel.ring_add_step,
            "k4": sx.smoothed_xent_rows_forward,
            "k4_bwd": sx.smoothed_xent_rows_backward,
            "k5": fa.flash_attention}


def _read_path(path: str, want: dict) -> dict:
    """Every kernel's launches, read just after a path's run (its counts
    were set to 0 just before it); fails unless each equals ``want``, where
    a kernel it does not name must not have launched."""
    got = {key: w.launches for key, w in _counters().items()}
    want = {key: want.get(key, 0) for key in got}
    if got != want:
        fail(f"{path}: launches {got}; the path must launch {want}")
    return got


def _one_rank():
    """A one-rank shard axis with no process group, for the kernel
    checks."""
    from repro_torch.launch.mesh import Axis
    return Axis("data", 1, 0, (0,), None)


def _shard_case(plan, n_shards, k, dev, gen):
    """Rank-k bucket shards of p, g, m at ``plan``'s shapes, the shard
    segment maps of each bucket and of all (the call site's), and the
    trust ratios from K1 (as the ZeRO-1 path makes them)."""
    import torch
    from repro_torch.core import bucketing, lars
    sizes = bucketing.shard_sizes(plan, n_shards)
    draw = lambda s: [s * torch.randn(c, generator=gen, device=dev)
                      for c in sizes]
    p, g, m = draw(1.0), draw(0.01), draw(0.001)
    segs, seg_all = lars._shard_maps(plan, n_shards, k, dev)
    trust = lars.shard_trust_ratios(p, g, seg_all, plan, lars.OptConfig(),
                                    shard_axis=_one_rank())
    return p, g, m, segs, seg_all, trust


#: K2's call site, (name, bucket_mb, shards): (a) the main path's, the
#: full-width 4 MB plan on one shard; (b) the 0.25 MB plan on 3 shards
#: (tensors split across buckets, padding chunks, 211 buckets: two
#: launches in the one call); (c) the 4 MB plan on 4 shards, a four-card
#: rank's shards, measured on one card. Every rank k of each
K2_SITES = (("a", 4.0, 1), ("b", 0.25, 3), ("c", 4.0, 4))
#: rounds of K2's timings, the variants in turns within each round
K2_ROUNDS = 3


def check_lars_update(dev):
    """K2 at the sharded step's call site, at K2_SITES' shapes with real
    segment maps and trust values from K1: the one call over every
    bucket's shards (``lars_packed_update_multi``, in place) against its
    plain version (rtol 1e-5, atol 1e-6), bit for bit against the
    per-bucket launches it replaces, in place, and equal across two calls;
    each per-bucket launch also against its plain version, in place and
    twice. Times, in turns at (a) and (c): the one launch, the 16
    per-bucket launches, the single-buffer launch over the shards
    concatenated, and the plain version; the three launch forms again on
    the device alone (``device_ms``); and K1 at its call site on (a)'s
    shards both ways: the one call of the step (``batched_sumsq_multi``)
    and the 32 per-bucket calls it replaced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.kernels import batched_norm, lars_update, ref
    from repro_torch.models import resnet

    pd = resnet.resnet_pd(get_config("resnet50"))[0]
    plan = bucketing.make_plan(pd)
    if plan.n_buckets != 16:
        fail(f"the full-width plan has {plan.n_buckets} buckets, not 16")
    gen = torch.Generator(device=dev).manual_seed(1)
    lr = torch.tensor(0.37, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, wd=5e-5)
    worst_abs, worst_rel = 0.0, 0.0

    def close(got, want, what):
        nonlocal worst_abs, worst_rel
        for x, y in zip(got, want):
            if not torch.allclose(x, y, rtol=1e-5, atol=1e-6):
                fail(f"{what} disagrees with its plain version (rtol 1e-5, "
                     f"atol 1e-6)")
            d = (x - y).abs()
            worst_abs = max(worst_abs, d.max().item())
            worst_rel = max(worst_rel, (d / y.abs().clamp_min(1e-30))
                            .max().item())

    def check(p, g, m, trust, seg, what):
        what = f"lars_packed_update {what}"
        got = lars_update.lars_packed_update(p, g, m, trust, seg, **kw)
        want = ref.lars_packed_update(p, g, m, trust, seg, **kw)
        again = lars_update.lars_packed_update(p, g, m, trust, seg, **kw)
        pin, min_ = p.clone(), m.clone()
        lars_update.lars_packed_update(pin, g, min_, trust, seg,
                                       inplace=True, **kw)
        torch.cuda.synchronize()
        close(got, want, what)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{what}: two calls differ")
        if not (torch.equal(pin, got[0]) and torch.equal(min_, got[1])):
            fail(f"{what}: in place differs")
        return got

    def check_multi(p, g, m, segs, seg_all, trust, what):
        what = f"lars_packed_update_multi {what}"
        per = [check(p[b], g[b], m[b], trust, segs[b], f"{what} bucket {b}")
               for b in range(len(p))]
        clone = lambda xs: [x.clone() for x in xs]
        runs = []
        for _ in range(2):
            pc, mc = clone(p), clone(m)
            out = lars_update.lars_packed_update_multi(pc, g, mc, trust,
                                                       seg_all, **kw)
            if not (all(x is y for x, y in zip(out[0], pc))
                    and all(x is y for x, y in zip(out[1], mc))):
                fail(f"{what}: not in place")
            runs.append(out)
        want = ref.lars_packed_update_multi(clone(p), g, clone(m), trust,
                                            seg_all, **kw)
        torch.cuda.synchronize()
        for b, (p2, m2) in enumerate(per):
            got = (runs[0][0][b], runs[0][1][b])
            if not (torch.equal(got[0], p2) and torch.equal(got[1], m2)):
                fail(f"{what}: bucket {b} differs from its own launch")
            if not (torch.equal(got[0], runs[1][0][b])
                    and torch.equal(got[1], runs[1][1][b])):
                fail(f"{what}: two calls differ")
            close(got, (want[0][b], want[1][b]), f"{what} bucket {b}")

    timed = {}
    n_checked = 0
    for name, mb, n in K2_SITES:
        splan = plan if mb == 4.0 else bucketing.make_plan(pd, bucket_mb=mb)
        if mb != 4.0 and not any(s.elem_offset for s in splan.slots):
            fail(f"the {mb} MB plan splits no tensor")
        for k in range(n):
            p, g, m, segs, seg_all, trust = _shard_case(splan, n, k, dev, gen)
            check_multi(p, g, m, segs, seg_all, trust,
                        f"({name}) {mb} MB plan, rank {k} of {n}")
            n_checked += 1
            if name != "b" and k == 0:
                timed[name] = (p, g, m, segs, seg_all, trust)
    print(f"lars_packed_update_multi: {n_checked} calls at (a) 4 MB on 1 "
          f"shard, (b) 0.25 MB on 3 and (c) 4 MB on 4 (every rank): bit-"
          f"equal to the per-bucket launches, in place and repeat calls "
          f"equal; with every per-bucket launch, max abs err "
          f"{worst_abs:.3e}, max rel err {worst_rel:.3e} (rtol 1e-5, atol "
          f"1e-6)", flush=True)

    def variants(p, g, m, segs, seg_all, trust):
        flat = [torch.cat(x) for x in (p, g, m)]

        def per_bucket():
            for b in range(len(p)):
                lars_update.lars_packed_update(p[b], g[b], m[b], trust,
                                               segs[b], inplace=True, **kw)
        return {"one_launch": (lambda: lars_update.lars_packed_update_multi(
                    p, g, m, trust, seg_all, **kw), 50),
                "per_bucket_16_launches": (per_bucket, 50),
                "single_buffer_one_launch": (
                    lambda: lars_update.lars_packed_update(
                        *flat, trust, seg_all, inplace=True, **kw), 50),
                "plain": (lambda: ref.lars_packed_update_multi(
                    p, g, m, trust, seg_all, **kw), 10)}

    def bounds(p, seg_all, trust):
        elems, chunks = sum(x.numel() for x in p), seg_all.numel()
        one = bound_ms(5 * 4 * elems + 4 * chunks + 4 * trust.numel() + 4,
                       6 * elems)
        per = bound_ms(5 * 4 * elems + 4 * chunks
                       + len(p) * (4 * trust.numel() + 4), 6 * elems)
        return elems, one, per

    sites = {}
    for name, case in timed.items():
        fns = variants(*case)
        rounds = {key: [] for key in fns}
        for _ in range(K2_ROUNDS):
            for key, (fn, iters) in fns.items():
                rounds[key].append(time_ms(fn, iters=iters))
        elems, (b_ms, b_by), (b16, _) = bounds(case[0], case[4], case[5])
        dev_only = {key: device_ms(fns[key][0]) for key in
                    ("one_launch", "per_bucket_16_launches",
                     "single_buffer_one_launch")}
        med = {key: statistics.median(v) for key, v in rounds.items()}
        sites[name] = dict(med, rounds=rounds, device_ms=dev_only,
                           bound_ms=b_ms, bound_by=b_by,
                           per_bucket_bound_ms=b16, elements=elems)
        us = lambda key: "/".join(f"{t * 1e3:.1f}" for t in rounds[key])
        dus = lambda key: ("host-paced" if dev_only[key] is None
                           else f"{dev_only[key] * 1e3:.1f}")
        print(f"lars_packed_update at call site ({name}), {elems} elements "
              f"in {len(case[0])} shards, us in {K2_ROUNDS} rounds in "
              f"turns: one launch {us('one_launch')}, the 16 per-bucket "
              f"launches {us('per_bucket_16_launches')}, single-buffer "
              f"launch {us('single_buffer_one_launch')}, plain "
              f"{us('plain')}; device alone (host hidden): one launch "
              f"{dus('one_launch')}, the 16 launches "
              f"{dus('per_bucket_16_launches')}, single-buffer "
              f"{dus('single_buffer_one_launch')}; bound {b_ms * 1e3:.1f} "
              f"us ({b_by}), the 16 launches' {b16 * 1e3:.1f}; no single "
              f"PyTorch call computes it (no library time)", flush=True)

    p, g, _, segs, seg_all, _ = timed["a"]

    def k1_per_bucket():
        # the call site before: two calls a bucket and an add each
        sq = torch.zeros(2, plan.n_tensors, device=dev)
        for b in range(plan.n_buckets):
            sq[0] += batched_norm.batched_sumsq(p[b], segs[b], plan.n_tensors)
            sq[1] += batched_norm.batched_sumsq(g[b], segs[b], plan.n_tensors)

    k1_ms = time_ms(lambda: batched_norm.batched_sumsq_multi(
        (p, g), seg_all, plan.n_tensors), iters=50)
    k1_32 = time_ms(k1_per_bucket, iters=50)
    k1_plain = time_ms(lambda: ref.batched_sumsq_multi(
        (p, g), seg_all, plan.n_tensors), iters=20)
    elems, chunks = plan.n_chunks * bucketing.CHUNK, plan.n_chunks
    k1_b, _ = bound_ms(2 * 4 * elems + 4 * chunks + 2 * 4 * plan.n_tensors,
                       2 * 2 * elems)
    k1_32_b, _ = bound_ms(2 * (4 * elems + 4 * chunks) + 2 * plan.n_buckets
                          * 4 * plan.n_tensors, 2 * 2 * elems)
    print(f"batched_sumsq at the ZeRO-1 call site, one step (the 16 p and g "
          f"shards): one launch (batched_sumsq_multi) {k1_ms * 1e3:.1f} us, "
          f"bound {k1_b * 1e3:.1f} us; the 32 per-bucket launches it "
          f"replaced {k1_32 * 1e3:.1f} us, bound {k1_32_b * 1e3:.1f} us; "
          f"plain {k1_plain * 1e3:.1f} us", flush=True)
    a, c = sites["a"], sites["c"]
    entry = {"name": "lars_packed_update", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/lars_update.cu",
             "replaces": "src/repro/kernels/lars_update.py:32",
             "launches": None, "max_abs_err": worst_abs,
             "max_rel_err": worst_rel, "ms": a["one_launch"],
             "plain_ms": a["plain"], "bound_ms": a["bound_ms"],
             "bound_by": a["bound_by"], "library_ms": None,
             "library": "none: no single PyTorch call computes it",
             "timed": "the sharded step's call site, full-width 4 MB plan "
                      "on one shard: one launch (lars_packed_update_multi) "
                      "over the 16 bucket shards, in place; median of "
                      f"{K2_ROUNDS} rounds in turns",
             "per_bucket_16_launches_ms": a["per_bucket_16_launches"],
             "per_bucket_bound_ms": a["per_bucket_bound_ms"],
             "single_buffer_one_launch_ms": a["single_buffer_one_launch"],
             "rounds_ms": a["rounds"], "device_ms": a["device_ms"],
             "four_card_rank": {
                 "shape": "4 MB plan, rank 0 of 4 shards",
                 "elements": c["elements"], "ms": c["one_launch"],
                 "per_bucket_16_launches_ms": c["per_bucket_16_launches"],
                 "single_buffer_one_launch_ms":
                     c["single_buffer_one_launch"],
                 "plain_ms": c["plain"], "bound_ms": c["bound_ms"],
                 "per_bucket_bound_ms": c["per_bucket_bound_ms"],
                 "rounds_ms": c["rounds"], "device_ms": c["device_ms"]},
             "shape": [a["elements"]], "segments": plan.n_tensors,
             "dtype": "float32"}
    k1_site = {"zero1_site": {
        "ms": k1_ms, "per_bucket_32_launches_ms": k1_32,
        "plain_ms": k1_plain, "bound_ms": k1_b,
        "per_bucket_bound_ms": k1_32_b,
        "library": "none: no single call sums squares by segment across "
                   "buffers"}}
    return entry, k1_site


def check_batched_sumsq(dev):
    """K1 at the training path's shape (ResNet-50's plan) in f32 and bf16,
    plus a ragged case with empty segments; timings at the f32 shape. Its
    multi-buffer form at the sharded step's call site: every bucket's p
    and g shards at rank k, every k, of the 4 MB plan on one shard and of
    the 0.25 MB plan (2 x 211 buffers: two pass-1 launches in one call)
    on one and three, f32 and bf16, and bit-equal across two calls."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, lars
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

    pd = resnet.resnet_pd(get_config("resnet50"))[0]
    multi_abs, multi_rel, n_multi = 0.0, 0.0, 0
    for mb, n_shards in ((4.0, 1), (0.25, 1), (0.25, 3)):
        mplan = bucketing.make_plan(pd, bucket_mb=mb)
        sizes = bucketing.shard_sizes(mplan, n_shards)
        for k in range(n_shards):
            _, seg_all = lars._shard_maps(mplan, n_shards, k, dev)
            for dtype in (torch.float32, torch.bfloat16):
                rows = [[(sc * torch.randn(c, generator=gen, device=dev))
                         .to(dtype) for c in sizes] for sc in (1.0, 0.01)]
                got = batched_norm.batched_sumsq_multi(rows, seg_all,
                                                       n_tensors)
                again = batched_norm.batched_sumsq_multi(rows, seg_all,
                                                         n_tensors)
                want = ref.batched_sumsq_multi(rows, seg_all, n_tensors)
                torch.cuda.synchronize()
                d = (got - want).abs()
                rel = (d / want.abs().clamp_min(1e-30)).max().item()
                what = (f"batched_sumsq_multi {mb} MB plan, {n_shards} "
                        f"shards, rank {k}, {dtype}")
                if not rel <= 2e-3:
                    fail(f"{what} disagrees with its plain version (max "
                         f"rel err {rel:.3e}, rtol 2e-3)")
                if not torch.equal(got, again):
                    fail(f"{what}: two calls differ")
                multi_abs = max(multi_abs, d.max().item())
                multi_rel, n_multi = max(multi_rel, rel), n_multi + 1
                del rows
    print(f"batched_sumsq_multi: {n_multi} calls (p and g shards of every "
          f"bucket; 4 MB plan on 1 shard, 0.25 MB plan on 1 and 3, every "
          f"rank, f32 and bf16): max abs err {multi_abs:.3e}, max rel err "
          f"{multi_rel:.3e} (rtol 2e-3); two calls bit-equal", flush=True)

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
            "dtype": "float32", "bf16_ms": bf16_ms, "bf16_bound_ms": b16_ms,
            "multi_max_abs_err": multi_abs, "multi_max_rel_err": multi_rel}


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
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state0, timed_step, batch_fn,
                                    steps=STEPS, log_every=1, seed=100000)
    # K1 twice a step (params, grads); no other kernel
    counts = _read_path("slice", {"k1": 2 * STEPS})
    launches = counts["k1"]
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in history]
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"losses not all finite: {losses}")
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
    return state0, batch_fn, counts


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


def _zero1_step(model, sched, mesh, **kw):
    """The ZeRO-1 step of the zero1 path; ``kw``: ``make_train_step``'s
    ``guard`` and ``tracer``."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.train.step import make_train_step
    comm = CommConfig(strategy="psum", sharding="zero1", gather="ahead",
                      overlap=True, update_kernel=True, bucket_mb=4)
    return make_train_step(model, lars.OptConfig(kind="lars",
                                                 weight_decay=5e-5,
                                                 use_kernel=True),
                           sched, smoothing=0.1, mesh=mesh, comm=comm, **kw)


def run_zero1(dev, mesh):
    """The ZeRO-1 explicit-DP step at full width on a one-rank NCCL group,
    through make_train_step + loop.train, as the CLI drives it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn, prototype_imagenet
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_eval_step

    cfg = get_config("resnet50")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH) / 4, warmup_steps=STEPS // 8,
        total_steps=STEPS, decay="poly2"))
    step = _zero1_step(model, sched, mesh)
    plan = step.bucket_plan
    if (plan.n_buckets, step.n_shards, step.gather) != (16, 1, "ahead"):
        fail(f"unexpected ZeRO-1 plan: {plan.n_buckets} buckets, "
             f"{step.n_shards} shards, gather {step.gather!r}")
    batch_fn = make_batch_fn(cfg, InputShape("in", "train", 0, BATCH),
                             device=dev, mesh=mesh)
    state0 = init_state(model, seed=100000, device=dev, sharded_plan=plan,
                        n_shards=step.n_shards, mesh=mesh)
    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state0, timed_step, batch_fn,
                                    steps=STEPS, log_every=1, seed=100000)
    # K2 and K1 once a step; no other kernel (one rank: no fold)
    counts = _read_path("zero1", {"k1": STEPS, "k2": STEPS})
    k1, k2 = counts["k1"], counts["k2"]
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in history]
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"zero1 losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail("zero1: loop.train did not reach run_stop")
    ev = make_eval_step(model)(
        loop.make_params_reader(step)(state),
        prototype_imagenet(cfg, batch=BATCH, step=10 ** 6, seed=100000,
                           device=dev), state.bn_state)
    if not (math.isfinite(float(ev["loss"])) and 0 <= float(ev["acc"]) <= 1):
        fail(f"zero1 eval step gave {ev}")
    med = statistics.median(times)
    print(f"zero1: losses {[round(v, 4) for v in losses]}; eval loss "
          f"{float(ev['loss']):.4f}", flush=True)
    print(f"zero1: step times ms {[round(t * 1e3, 2) for t in times]}; "
          f"median {med * 1e3:.2f} ms, {BATCH / med:.1f} images/s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches lars_packed_update "
          f"{k2}, batched_sumsq {k1}", flush=True)
    return counts


def check_zero1_in_context(dev, mesh, batch_fn):
    """One ZeRO-1 step (K1 + K2) and one replicated comm='xla' step
    (per-tensor norms, no kernel) from one state and batch: the masters
    read back from the shards must agree with the replicated params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train import state as st
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    model = build_model(get_config("resnet50"))
    sched = make_schedule(ScheduleConfig(base_lr=1.0, total_steps=STEPS))
    zero = _zero1_step(model, sched, mesh)
    plan = zero.bucket_plan
    s0 = st.init_state(model, seed=7, device=dev)
    packed = lambda tree: st.local_shards(st.init_packed_shards(tree, plan),
                                          1, 0)
    z0 = st.TrainState(0, s0.params, packed(s0.mom), s0.bn_state,
                       packed(s0.params))
    batch = batch_fn(0)
    torch.backends.cudnn.deterministic = True
    try:
        want = make_train_step(model, lars.OptConfig(use_kernel=False),
                               sched)(s0, batch)[0].params
        z1 = zero(z0, batch)[0]
    finally:
        torch.backends.cudnn.deterministic = False
    got = st.full_params_from_shards(z1.shards, plan)
    worst, moved = 0.0, 0.0
    for (_, a), (_, b), (_, c) in zip(tree_flatten(got), tree_flatten(want),
                                      tree_flatten(s0.params)):
        worst = max(worst, (a - b).abs().max().item()
                    / max(b.abs().max().item(), 1e-30))
        moved = max(moved, (a - c).abs().max().item())
    print(f"zero1 context: ZeRO-1 masters vs the replicated step's params, "
          f"worst difference {worst:.3e} of the tensor's max (limit 1e-5); "
          f"largest update {moved:.3e}", flush=True)
    if not worst <= 1e-5 or moved == 0.0:
        fail("the ZeRO-1 step disagrees with the replicated step")


def _counting(step, tally):
    """``step`` that adds one to ``tally[0]`` for every call the guard let
    commit (every call of an unguarded step): K1 and K2 launch once in
    each such call of the zero1 step and in no other."""
    def call(*args):
        out = step(*args)
        if float(out[1].get("skipped", 0.0)) == 0.0:
            tally[0] += 1
        return out
    call.__dict__.update(step.__dict__)
    return call


def _tensors(tree) -> list:
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree) if isinstance(tree, dict) else list(tree)


def _bit_equal(a, b) -> bool:
    """Every tensor of two trees (or sequences) equal, bit for bit."""
    import torch
    la, lb = _tensors(a), _tensors(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and bool(torch.equal(x, y))
        for x, y in zip(la, lb))


def _worst_rel(a, b) -> float:
    """Largest difference over buffers, relative to each buffer's max."""
    return max((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
               for x, y in zip(a, b))


def _state_bit_equal(a, b) -> bool:
    return a.step == b.step and all(
        _bit_equal(x, y) for x, y in ((a.params, b.params), (a.mom, b.mom),
                                      (a.bn_state, b.bn_state),
                                      (a.shards, b.shards)))


def run_durability(dev, mesh, batch_fn, tmp):
    """Durability and observability on the full-width ZeRO-1 step (K1, K2)
    through loop.train: a checkpoint round trip, the n→m relayout and an
    elastic resume, a guarded nan@2 run against its oracle and a spike
    rollback, a traced run, and the guard's, the tracer's and a snapshot's
    cost. Returns every kernel's launches (K1 and K2 once a committed step
    call, 0 on a skipped one)."""
    import hashlib

    import torch
    from repro_torch import comm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import bucketing
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic, guard, loop
    from repro_torch.train import state as st

    model = build_model(get_config("resnet50"))
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH) / 4, warmup_steps=STEPS // 8,
        total_steps=STEPS, decay="poly2"))
    committed = [0]
    step = _counting(_zero1_step(model, sched, mesh), committed)
    plan = step.bucket_plan
    fresh = lambda: st.init_state(   # noqa: E731
        model, seed=100000, device=dev, **st.sharded_state_kwargs(step))
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    reg = obs_metrics.default_registry()

    # 1. checkpoint round trip after 2 steps, with the CommPlan
    d1 = os.path.join(tmp, "ckpt")
    with reg.use_sink(sink):
        s2, _ = loop.train(fresh(), step, batch_fn, steps=2, log_every=0,
                           ckpt_dir=d1, ckpt_every=2,
                           comm_plan=step.comm_plan, seed=100000)
    tag = ckpt.step_tag(2)
    ent = ckpt.verify(d1, tag)
    with open(os.path.join(d1, ent["file"]), "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != ent["sha256"]:
            fail("durability: the manifest's sha256 is not the payload's")
    torch.cuda.synchronize()
    t = time.perf_counter()
    ckpt.save(s2, d1, tag="timed", comm_plan=step.comm_plan, mesh=mesh)
    save_ms = (time.perf_counter() - t) * 1e3
    template = fresh()
    t = time.perf_counter()
    back = ckpt.load(template, d1, tag=tag, mesh=mesh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    if not _state_bit_equal(back, s2):
        fail("durability: the checkpoint did not load back bit for bit")
    if ckpt.load_comm_plan(d1, tag=tag) != step.comm_plan:
        fail("durability: the CommPlan did not load back equal")
    mib = ckpt.read_manifest(d1)["entries"][tag]["bytes"] / 2 ** 20
    print(f"durability: checkpoint after 2 steps: {mib:.1f} MiB payload, save "
          f"{save_ms:.1f} ms, load {load_ms:.1f} ms; every tensor of "
          f"params, momentum, BN and shards bit-equal; sha256 and CommPlan "
          f"match", flush=True)

    # 2. n→m relayout of the full-width masters and momentum, then an
    # elastic resume from a 1 MB-plan checkpoint into the 4 MB step
    plan1 = bucketing.make_plan(model.param_pd, bucket_mb=1.0)
    chain = ((plan, 1), (plan, 4), (plan1, 4), (plan1, 1), (plan, 1))
    times = []
    for name in ("shards", "mom"):
        bufs = list(getattr(s2, name))
        for (pa, na), (pb, nb) in zip(chain, chain[1:]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            bufs = elastic.reshard_buffers(bufs, pa, na, pb, nb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        if not _bit_equal(bufs, getattr(s2, name)):
            fail(f"durability: {name} 4 MB/1 -> 4 MB/4 -> 1 MB/4 -> 1 MB/1 "
                 f"-> 4 MB/1 is not bit-equal")
    relay = lambda b: elastic.reshard_buffers(b, plan, 1, plan1, 1)  # noqa
    s1mb = st.TrainState(s2.step, s2.params, tuple(relay(list(s2.mom))),
                         s2.bn_state, tuple(relay(list(s2.shards))))
    d2 = os.path.join(tmp, "ckpt_1mb")
    cp1 = comm.plan_for(CommConfig(strategy="psum", bucket_mb=1.0,
                                   sharding="zero1", update_kernel=True),
                        mesh, model.param_pd)
    ckpt.save(s1mb, d2, tag=tag, comm_plan=cp1, mesh=mesh)
    template = fresh()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = elastic.load_resharded(d2, template, plan, 1, mesh=mesh)
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t) * 1e3
    if not (_bit_equal(r.shards, s2.shards) and _bit_equal(r.mom, s2.mom)):
        fail("durability: load_resharded from the 1 MB plan is not bit-equal")
    r, m = step(r, batch_fn(r.step))
    if r.step != 3 or not math.isfinite(float(m["loss"])):
        fail(f"durability: the resumed step gave step {r.step}, loss "
             f"{float(m['loss'])}")
    print(f"durability: reshard_buffers at full width (16 buckets <-> "
          f"{plan1.n_buckets}, 1 <-> 4 shards) {min(times):.1f}-"
          f"{max(times):.1f} ms a relayout, bit-equal; load_resharded from "
          f"the 1 MB plan {resume_ms:.1f} ms, then a step: loss "
          f"{float(m['loss']):.4f}", flush=True)
    del s1mb, r, back, template

    # 3. guarded nan@2 against the uninjected run, bit for bit under the
    # determinism rule; then a spike and its rollback
    gstep = _counting(_zero1_step(model, sched, mesh, guard=True),
                      committed)

    def guarded(faults):
        mem = obs_metrics.MemorySink()
        with reg.use_sink(mem):
            s, hist = loop.train(fresh(), gstep, batch_fn, steps=DUR_STEPS,
                                 log_every=1, faults=faults, seed=100000,
                                 guard=guard.GuardConfig())
        return s, hist, mem

    det_op, before = None, torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True)
        a, _, mem_a = guarded("nan@2")
        o, _, mem_o = guarded(None)
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        det_op = str(e).splitlines()[0]
        torch.use_deterministic_algorithms(before)
        a, _, mem_a = guarded("nan@2")
        o, _, mem_o = guarded(None)
    finally:
        torch.use_deterministic_algorithms(before)
    skips = len(mem_a.find("guard_skip"))
    if skips != 1 or mem_o.find("guard_skip") or not (a.step == o.step
                                                      == DUR_STEPS):
        fail(f"durability: nan@2 gave {skips} guard_skip, steps {a.step} / "
             f"{o.step}")
    if det_op is None:
        if not _bit_equal(a.shards, o.shards):
            fail("durability: the guarded nan@2 run's masters are not the "
                 "oracle's bit for bit (deterministic algorithms on)")
        how = "bit for bit (torch.use_deterministic_algorithms)"
    else:
        worst = _worst_rel(a.shards, o.shards)
        if not worst <= DUR_TOL:
            fail(f"durability: nan@2 masters {worst:.3e} of the max from "
                 f"the oracle's (limit {DUR_TOL}; {det_op})")
        how = (f"{worst:.3e} of the max (limit {DUR_TOL}): no deterministic "
               f"form for: {det_op}")
    with reg.use_sink(obs_metrics.MemorySink()) as mem_s:
        s, hist = loop.train(fresh(), gstep, batch_fn, steps=DUR_STEPS,
                             log_every=1, faults=DUR_SPIKE, seed=100000,
                             guard=guard.GuardConfig())
    losses = [h["loss"] for h in hist if "loss" in h]
    if not (mem_s.find("guard_rollback") and mem_s.find("run_stop")
            and all(math.isfinite(v) for v in losses)):
        fail(f"durability: {DUR_SPIKE}: rollbacks "
             f"{len(mem_s.find('guard_rollback'))}, losses {losses}")
    print(f"durability: guarded nan@2, {DUR_STEPS} steps: 1 guard_skip, "
          f"masters equal to the uninjected run {how}; {DUR_SPIKE}: "
          f"{len(mem_s.find('guard_rollback'))} guard_rollback, finite "
          f"losses, run_stop", flush=True)
    del a, o, s

    # 4. the tracer: 3 traced steps through the loop, the Chrome JSON
    tracer = obs_trace.Tracer()
    tstep = _counting(_zero1_step(model, sched, mesh, tracer=tracer), committed)
    loop.train(fresh(), tstep, batch_fn, steps=3, log_every=0,
               tracer=tracer, seed=100000)
    path = obs_trace.export_chrome(tracer, os.path.join(tmp, "trace.json"))
    spans = obs_trace.spans_from_chrome(obs_trace.load_chrome(path))
    want = {"forward", "backward", "update"} | {
        f"{k}[b{i}]" for k in ("rs", "ag") for i in range(plan.n_buckets)}
    for i in range(3):
        mine = [sp for sp in spans if sp.step == i]
        win = [sp for sp in mine if sp.name == "step"]
        names = {sp.name for sp in mine} - {"step"}
        if len(win) != 1 or names != want or not all(
                win[0].t0 <= sp.t0 <= sp.t1 <= win[0].t1 for sp in mine):
            fail(f"durability: traced step {i}: spans {sorted(names)}, "
                 f"want {sorted(want)}, each inside its window")

    # 5. the guard's and the tracer's cost, interleaved; a snapshot's cost
    variants = {"unguarded": (step, None), "guarded": (gstep, None),
                "traced": (tstep, tracer)}
    states = {k: fresh() for k in variants}
    ms = {k: [] for k in variants}
    for r_i in range(DUR_ROUNDS):
        for k, (fn, tr) in variants.items():
            batch = batch_fn(r_i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if tr is not None:
                tr.begin_step()
            args = (guard.neutral_inputs(),) if k == "guarded" else ()
            states[k], _ = fn(states[k], batch, *args)
            if tr is not None:
                tr.end_step(100 + r_i)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t) * 1e3)
    snaps = []
    for _ in range(DUR_SNAPSHOTS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        snap = st.host_snapshot(states["unguarded"])
        torch.cuda.synchronize()
        snaps.append((time.perf_counter() - t) * 1e3)
    nbytes = sum(x.numel() * x.element_size() for x in
                 _tensors(snap.shards) + _tensors(snap.mom)
                 + _tensors(snap.params) + _tensors(snap.bn_state))
    del snap, states
    med = {k: statistics.median(v[1:]) for k, v in ms.items()}
    print(f"durability: step ms, {DUR_ROUNDS} interleaved rounds (median "
          f"after the first): unguarded {med['unguarded']:.2f}, guarded "
          f"{med['guarded']:.2f}, traced {med['traced']:.2f}; all "
          + "; ".join(f"{k} {[round(x, 2) for x in v]}"
                      for k, v in ms.items()), flush=True)
    print(f"durability: a rollback snapshot (device copy, "
          f"{nbytes / 2 ** 20:.1f} MiB) {statistics.median(snaps):.3f} ms "
          f"(median of {DUR_SNAPSHOTS})", flush=True)
    counts = _read_path("durability", {"k1": committed[0],
                                       "k2": committed[0]})
    print(f"durability: {committed[0]} committed step calls: launches "
          f"batched_sumsq {counts['k1']}, lars_packed_update {counts['k2']}",
          flush=True)
    return counts


def _ring_rows(dev, gen, L, n, dtype):
    """A bucket of ``L`` elements as the ring cuts it for ``n`` ranks
    (``_as_chunks(pad_to=CHUNK)``) and a received partial of one row."""
    import torch
    from repro_torch.comm import primitives as prim
    from repro_torch.core.bucketing import CHUNK
    x = torch.randn(L, generator=gen, device=dev).to(dtype)
    chunks = prim._as_chunks(x, n, pad_to=CHUNK)
    recv = torch.randn(chunks.shape[1], generator=gen, device=dev).to(dtype)
    return recv, chunks


def check_ring_add(dev):
    """K3 against its plain version, bit for bit, through the wrapper and
    through the fold ``kernel_step_fn`` binds once a chunks, at the ring's
    shapes: the ResNet-50 path's chunk rows (the largest and the smallest
    of its 16 buckets on 4 and 2 ranks, bf16 and f32, every k), the reference
    test's shapes ((4, 2·1024) f32 at k 0 and 3; bf16 ones + 0.5), its
    ragged (n, length) pairs through ``_as_chunks(pad_to=CHUNK)``, views
    off the 16-byte grid and the fold in place. Times one fold at the
    largest row (through ``kernel_step_fn`` bound to its chunks, as the
    ring folds, and through the public wrapper) and the 48 folds of a
    four-rank ring step (the same two ways), beside the plain version,
    ``torch.add(..., out=)`` and the bound; then splits a bound fold's
    host time: the bare C call (c = 0: no launch), ``data_ptr()``, and
    the C call with its launch from precomputed arguments."""
    import torch
    from repro_torch.comm import ring_kernel as rk
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.core.bucketing import CHUNK
    from repro_torch.kernels import ref
    from repro_torch.models import resnet

    plan = bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0])
    if plan.n_buckets != 16:
        fail(f"the full-width plan has {plan.n_buckets} buckets, not 16")
    gen = torch.Generator(device=dev).manual_seed(4)
    n_checked, worst = 0, 0.0
    # the chunks the last kernel_step_fn was bound to, and that adapter:
    # the k of one chunks fold through one adapter, as in the ring
    bound = [None, None]

    def check(recv, chunks, k, what, out=None):
        nonlocal n_checked, worst
        want = ref.ring_add_step(recv, chunks, k)    # before any in place
        buf = recv.clone()
        snap = chunks.clone()
        got = rk.ring_add_step(recv, chunks, k, out=out)
        if bound[0] is not chunks:
            bound[:] = [chunks, rk.kernel_step_fn()]
        before = rk.ring_add_step.launches
        bound[1](buf, chunks, k)
        if rk.ring_add_step.launches != before + 1:
            fail(f"ring_add_step {what}: the bound fold did not launch once")
        torch.cuda.synchronize()
        for name, x in (("the wrapper", got), ("the bound fold", buf)):
            if x.dtype != want.dtype:
                fail(f"ring_add_step {what}, {name}: dtype {x.dtype}")
            worst = max(worst, (x.float() - want.float()).abs().max().item())
            if not torch.equal(x, want):
                fail(f"ring_add_step {what} k={k}, {name}, is not bit-equal "
                     f"to its plain version")
        if not torch.equal(chunks, snap):
            fail(f"ring_add_step {what}: chunks were written")
        n_checked += 1

    f32, bf16 = torch.float32, torch.bfloat16
    sizes = {"largest": max(plan.bucket_sizes),
             "smallest": min(plan.bucket_sizes)}
    for name, L in sizes.items():
        for n in (4, 2):
            for dtype in (bf16, f32):
                recv, chunks = _ring_rows(dev, gen, L, n, dtype)
                for k in range(n):
                    check(recv, chunks, k, f"{name} bucket, n {n}, {dtype}")
    recv, chunks = _ring_rows(dev, gen, 4 * 2 * CHUNK, 4, f32)
    for k in (0, 3):
        check(recv, chunks, k, "reference (4, 2048) f32")
    ones = torch.ones((2, CHUNK), dtype=bf16, device=dev)
    half = torch.full((CHUNK,), 0.5, dtype=bf16, device=dev)
    check(half, ones, 1, "reference bf16")
    if not bool((rk.ring_add_step(half, ones, 1) == 1.5).all()):
        fail("ring_add_step: 0.5 + 1 is not 1.5 in bf16")
    for n, length in RING_RAGGED:
        recv, chunks = _ring_rows(dev, gen, length, n, f32)
        for k in range(n):
            check(recv, chunks, k, f"ragged ({n}, {length})")
    c = 3 * CHUNK
    for dtype in (bf16, f32):
        chunks = torch.randn(2 * c + 1, generator=gen,
                             device=dev).to(dtype)[1:].view(2, c)
        for shift in (1, 2):       # offset like the rows, then apart
            recv = torch.randn(c + shift, generator=gen,
                               device=dev).to(dtype)[shift:]
            out = torch.empty(c + 1, dtype=dtype, device=dev)[1:]
            check(recv, chunks, 1, f"misaligned by {shift}, {dtype}",
                  out=out)
        held = torch.randn(c, generator=gen, device=dev).to(dtype)
        check(held, chunks, 0, f"in place, {dtype}", out=held)
    print(f"ring_add_step: {n_checked} folds, each through the wrapper and "
          f"the bound fold, bit-equal to the plain version "
          f"(max abs err {worst:.1e}): the path's largest and smallest chunk "
          f"rows on 4 and 2 ranks in bf16 and f32 at every k, the reference "
          f"shapes, ragged {list(RING_RAGGED)}, misaligned views, in place",
          flush=True)
    if worst != 0.0:
        fail("ring_add_step is not bit-equal to its plain version")

    # one fold at the largest row of a four-rank ring, in the wire dtype
    recv, chunks = _ring_rows(dev, gen, sizes["largest"], 4, bf16)
    out = recv.clone()
    bound_fold = rk.kernel_step_fn()
    ms = time_ms(lambda: bound_fold(out, chunks, 1), iters=200, warmup=20)
    # a bucket's first fold: a new adapter checks in full and binds
    first_ms = time_ms(lambda: rk.kernel_step_fn()(out, chunks, 1),
                       iters=200, warmup=20)
    wrapper = time_ms(lambda: rk.ring_add_step(recv, chunks, 1, out=out),
                      iters=200, warmup=20)
    plain = time_ms(lambda: ref.ring_add_step(recv, chunks, 1), iters=200,
                    warmup=20)
    library = time_ms(lambda: torch.add(recv, chunks[1], out=out),
                      iters=200, warmup=20)
    cr = recv.numel()
    b_ms, b_by = bound_ms(3 * cr * 2, cr)
    r32, c32 = _ring_rows(dev, gen, sizes["largest"], 4, f32)
    f32_fold = rk.kernel_step_fn()
    f32_ms = time_ms(lambda: f32_fold(r32, c32, 1), iters=200, warmup=20)
    f32_b, _ = bound_ms(3 * cr * 4, cr)
    del r32, c32, f32_fold
    # where a bound fold's host time goes, at the same row: the typed
    # entry called bare (c = 0 returns before any launch), data_ptr(),
    # and the call with its launch from arguments computed beforehand
    fn = rk._inplace_entry(bf16)
    o_ptr, row_ptr = out.data_ptr(), chunks[1].data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    bare_us = host_us(lambda: fn(o_ptr, row_ptr, 0, stream))
    ptr_us = host_us(out.data_ptr)
    raw = time_ms(lambda: fn(o_ptr, row_ptr, cr, stream), iters=200,
                  warmup=20)
    # the 48 folds of one four-rank ring step: 16 buckets x k 0, 1, 2, in
    # place into fresh receives as the ring does (115 MB: past the L2)
    rows = [_ring_rows(dev, gen, L, 4, bf16) for L in plan.bucket_sizes]
    outs = [torch.empty_like(r) for r, _ in rows]

    def step(fold):
        for (r, ch), o in zip(rows, outs):
            for k in range(3):
                fold(r, ch, k, o)

    def ring_step():
        # the ring's own path: one kernel_step_fn a bucket, bound on its
        # first fold, in place into the receive buffer
        for (_, ch), o in zip(rows, outs):
            fold = rk.kernel_step_fn()
            for k in range(3):
                fold(o, ch, k)

    s_ms = time_ms(ring_step, iters=20, warmup=3)
    s_wrapper = time_ms(lambda: step(lambda r, ch, k, o: rk.ring_add_step(
        r, ch, k, out=o)), iters=20, warmup=3)
    s_plain = time_ms(lambda: step(lambda r, ch, k, o: ref.ring_add_step(
        r, ch, k)), iters=20, warmup=3)
    s_lib = time_ms(lambda: step(lambda r, ch, k, o: torch.add(
        r, ch[k], out=o)), iters=20, warmup=3)
    s_elems = 3 * sum(r.numel() for r, _ in rows)
    s_b, _ = bound_ms(3 * s_elems * 2, s_elems)
    print(f"ring_add_step bf16 at the largest row (4 ranks, {cr} elements): "
          f"kernel_step_fn's bound fold {ms * 1e3:.2f} us (a bucket's first "
          f"fold, checked and bound, {first_ms * 1e3:.2f} us), the wrapper "
          f"{wrapper * 1e3:.2f} us, plain {plain * 1e3:.2f} us, torch.add "
          f"{library * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}); f32 "
          f"bound fold {f32_ms * 1e3:.2f} us, bound {f32_b * 1e3:.2f} us; a "
          f"four-rank step's 48 folds: through kernel_step_fn "
          f"{s_ms * 1e3:.1f} us, the wrapper {s_wrapper * 1e3:.1f} us, plain "
          f"{s_plain * 1e3:.1f} us, torch.add {s_lib * 1e3:.1f} us, bound "
          f"{s_b * 1e3:.1f} us", flush=True)
    print(f"ring_add_step, a bound fold's host time: bare C call (no "
          f"launch) {bare_us:.2f} us, data_ptr() {ptr_us:.2f} us, C call "
          f"with its launch {raw * 1e3:.2f} us; the fold's Python checks "
          f"the rest of {ms * 1e3:.2f} us", flush=True)
    return {"name": "ring_add_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ring_add.cu",
            "replaces": "src/repro/comm/ring_kernel.py:38",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "timed": "kernel_step_fn's fold, bound to its chunks",
            "first_fold_ms": first_ms, "wrapper_ms": wrapper,
            "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library,
            "library": "torch.add(recv, chunks[k], out=out)",
            "shape": [4, cr], "dtype": "bfloat16", "f32_ms": f32_ms,
            "f32_bound_ms": f32_b, "folds_checked": n_checked,
            "host_split_us": {"bare_call": bare_us, "data_ptr": ptr_us,
                              "call_and_launch": raw * 1e3},
            "step_48_folds": {"step_fn_ms": s_ms, "wrapper_ms": s_wrapper,
                              "plain_ms": s_plain, "library_ms": s_lib,
                              "bound_ms": s_b}}


def _visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention over S tokens
    computes: sum over q of min(q + 1, window)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _flash_case(dev, gen, name, B, S, H, K, Dk, Dv, window, dt, q_scale):
    """K5 at one shape, causal, q multiplied by ``q_scale``: checked against
    its plain version, then timed beside the plain version, SDPA on the
    same inputs and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((B * n, S, d), generator=gen, device=dev)
               .to(dtype) for n, d in ((H, Dk), (K, Dk), (K, Dv)))
    q = (q.float() * q_scale).to(dtype)
    kw = dict(causal=True, window=window, n_q_heads=H, n_kv_heads=K)
    got = fa.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[dt]
    err = (got.float() - want.float()).abs()
    if not bool((err <= atol + rtol * want.float().abs()).all()):
        fail(f"flash_attention {name} disagrees with its plain version "
             f"(rtol {rtol}, atol {atol}): max abs err "
             f"{err.max().item():.3e}")
    if not torch.equal(fa.flash_attention(q, k, v, **kw), got):
        fail(f"flash_attention {name}: two calls differ")
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=20,
                 warmup=3)
    plain = time_ms(lambda: ref.flash_attention(q, k, v, **kw), iters=5,
                    warmup=1)
    qs, ks, vs = (x.view(B, -1, S, x.shape[-1]) for x in (q, k, v))
    sdpa = dict(enable_gqa=K != H)
    if window:
        i = torch.arange(S, device=dev)
        sdpa["attn_mask"] = (i[None] <= i[:, None]) & (
            i[None] > i[:, None] - window)
    else:
        sdpa["is_causal"] = True
    library = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, **sdpa), iters=20, warmup=3)
    ops = 2 * B * H * _visible_pairs(S, window) * (Dk + Dv)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + got.numel())
    b_ms, b_by = bound_ms(nbytes, ops, BF16_OPS_PER_S
                          if dtype == torch.bfloat16 else F32_OPS_PER_S)
    print(f"flash_attention {name} (B {B}, S {S}, H {H}, K {K}, Dk {Dk}, "
          f"Dv {Dv}, window {window}, {dt}, q x {q_scale}): max abs err "
          f"{err.max().item():.3e} (rtol {rtol}, atol {atol}); kernel "
          f"{ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, sdpa "
          f"{library * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}: "
          f"{ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
    return {"shape": [B, S, H, K, Dk, Dv], "window": window, "dtype": dt,
            "q_scale": q_scale,
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain,
            "library_ms": library, "bound_ms": b_ms, "bound_by": b_by}


def check_flash_attention(dev):
    """K5 against its plain version at ``FLASH_SHAPES`` (the serving
    prefill's shape first), each timed beside its plain version,
    ``scaled_dot_product_attention`` and the bound."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {case[0]: _flash_case(dev, gen, *case) for case in FLASH_SHAPES}
    path = rows["path"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:87",
            "launches": None, "max_abs_err": path["max_abs_err"],
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": path["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "shape": path["shape"], "dtype": path["dtype"],
            "routes": FLASH_ROUTES, "shapes": rows}


def _dx_close(got, want, g, rtol, atol):
    """K4's gradient against autograd of the plain version, with the atol
    in dx's own scale: ``dx = g·(p - (1-ε)·[v = y] - ε/V)``, so a row's
    limit is ``atol·g[t] + rtol·|want|``. The step hands the kernel
    g = 1/n_valid (1.2e-4 at 8,192 tokens), where a typical element is
    about 1e-10: a fixed atol of 1e-7 would hold nothing but the target
    column. Returns (ok, max abs err, max err per unit of g)."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol * g[:, None] + rtol * want.float().abs()).all())
    err_max = err.max().item()
    err.div_(g.clamp(min=1e-30)[:, None])
    return ok, err_max, err[g > 0].max().item()


def _xent_case(dev, gen, name, T, V, dt, ignore):
    """K4 at one shape, forward and backward: checked against the plain
    version (the backward against its autograd), then each timed beside
    the plain version, F.cross_entropy on the same inputs and the bound.
    The loss's gradient is what the LM step hands the kernel: 1/n_valid
    on valid rows, 0 on IGNORE rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import smoothed_xent as sx

    dtype = getattr(torch, dt)
    x = (4.0 * torch.randn((T, V), generator=gen, device=dev)).to(dtype)
    labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                           dtype=torch.int32)
    if ignore:
        labels[::3] = -1
    valid = labels >= 0
    g = valid.float() / valid.sum().clamp(min=1)
    eps = 0.1

    nll, lse = sx.smoothed_xent_rows_forward(x, labels, eps)
    dx = sx.smoothed_xent_rows_backward(x, labels, lse, g, eps)
    xp = x.detach().requires_grad_()
    want = ref.smoothed_xent_rows(xp, labels, smoothing=eps)
    (want_dx,) = torch.autograd.grad(want, xp, g, retain_graph=True)
    torch.cuda.synchronize()
    rtol, atol = XENT_FWD_TOL[dt]
    err = (nll - want.detach()).abs()
    errs = {"forward": err.max().item()}
    if not bool((err <= atol + rtol * want.detach().abs()).all()):
        fail(f"smoothed_xent_rows {name} forward disagrees with its plain "
             f"version (rtol {rtol}, atol {atol}): max abs err "
             f"{errs['forward']:.3e}")
    rtol, atol = XENT_BWD_TOL[dt]
    ok, errs["backward"], per_g = _dx_close(dx, want_dx, g, rtol, atol)
    if not ok:
        fail(f"smoothed_xent_rows {name} backward disagrees with autograd of "
             f"its plain version (rtol {rtol}, atol {atol}·g): max abs err "
             f"{errs['backward']:.3e}, {per_g:.3e} per unit of g")
    del want_dx
    if bool(dx[~valid].any()):
        fail(f"smoothed_xent_rows {name}: a masked row's gradient is not 0")
    if not torch.equal(sx.smoothed_xent_rows_forward(x, labels, eps)[0],
                       nll):
        fail(f"smoothed_xent_rows {name}: two calls differ")
    del dx

    it = dict(iters=20, warmup=3) if T * V > 10 ** 8 else {}
    few = dict(iters=5, warmup=1) if T * V > 10 ** 8 else {}
    fwd_ms = time_ms(lambda: ops.smoothed_xent_rows(x, labels, eps), **it)
    bwd_ms = time_ms(lambda: sx.smoothed_xent_rows_backward(
        x, labels, lse, g, eps), **it)
    plain_fwd = time_ms(lambda: ref.smoothed_xent_rows(
        x, labels, smoothing=eps), **few)
    plain_bwd = time_ms(lambda: torch.autograd.grad(
        want, xp, g, retain_graph=True), **few)
    del want, xp
    xl = x.detach().requires_grad_()
    lib = F.cross_entropy(xl, labels.long(), reduction="none",
                          label_smoothing=eps, ignore_index=-1)
    lib_err = (lib.detach().float() - nll)[valid].abs().max().item()
    lib_fwd = time_ms(lambda: F.cross_entropy(
        x, labels.long(), reduction="none", label_smoothing=eps,
        ignore_index=-1), **it)
    gl = g.to(lib.dtype)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib, xl, gl, retain_graph=True), **few)
    del lib, xl
    es = x.element_size()
    n_read = int(g.count_nonzero())       # masked rows: x is not read
    f_ms, f_by = bound_ms(T * V * es + 3 * T * 4, XENT_OPS * T * V)
    b_ms, b_by = bound_ms((T + n_read) * V * es + 3 * T * 4,
                          XENT_OPS * n_read * V)
    print(f"smoothed_xent_rows {name} (T {T}, V {V}, {dt}, "
          f"{T - int(valid.sum())} IGNORE): max abs err forward "
          f"{errs['forward']:.3e}, backward {errs['backward']:.3e} "
          f"({per_g:.3e} per unit of g); "
          f"forward: kernel {fwd_ms * 1e3:.1f} us, plain {plain_fwd * 1e3:.1f}"
          f" us, F.cross_entropy {lib_fwd * 1e3:.1f} us, bound "
          f"{f_ms * 1e3:.1f} us ({f_by}); backward: kernel "
          f"{bwd_ms * 1e3:.1f} us, plain {plain_bwd * 1e3:.1f} us, "
          f"F.cross_entropy {lib_bwd * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us"
          f" ({b_by}); F.cross_entropy rows differ from the kernel's by "
          f"{lib_err:.3e}", flush=True)
    row = {"shape": [T, V], "dtype": dt, "ignore": int(T - valid.sum())}
    return ({**row, "max_abs_err": errs["forward"], "ms": fwd_ms,
             "plain_ms": plain_fwd, "library_ms": lib_fwd, "bound_ms": f_ms,
             "bound_by": f_by, "library_max_abs_diff": lib_err},
            {**row, "max_abs_err": errs["backward"],
             "max_err_per_unit_g": per_g, "ms": bwd_ms,
             "plain_ms": plain_bwd, "library_ms": lib_bwd, "bound_ms": b_ms,
             "bound_by": b_by})


def check_smoothed_xent(dev):
    """K4, forward and backward, at ``XENT_SHAPES`` (the LM training
    path's first): two entries of the kernels line."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    fwd, bwd = {}, {}
    for case in XENT_SHAPES:
        fwd[case[0]], bwd[case[0]] = _xent_case(dev, gen, *case)
        torch.cuda.empty_cache()
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/smoothed_xent.cu",
              "replaces": "src/repro/kernels/smoothed_xent.py:56",
              "launches": None}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "dtype")
    return ({"name": "smoothed_xent_rows", **common,
             **{k: fwd["path"][k] for k in keys},
             "library": "torch.nn.functional.cross_entropy(reduction="
                        "'none', label_smoothing=0.1)", "shapes": fwd},
            {"name": "smoothed_xent_rows_backward", **common,
             **{k: bwd["path"][k] for k in keys},
             "library": "the autograd backward of the same "
                        "F.cross_entropy call",
             "note": "the gradient of K4's function; the reference has no "
                     "backward kernel (XLA differentiates its jnp loss)",
             "shapes": bwd})


def run_lm_train(dev):
    """Full-width qwen1.5-0.5b trained through the port's entry points, as
    ``python -m repro.launch.train --arch qwen1.5-0.5b`` drives the JAX
    package (here at full width, batch 2 x seq 4096)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_eval_step, make_train_step

    cfg = get_config("qwen1.5-0.5b")
    if not cfg.remat or cfg.flash_attention:
        fail("lm_train: the config must train with remat and without the "
             "flash kernel")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                         total_steps=LM_STEPS,
                                         decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    train_step = make_train_step(model, opt, sched, smoothing=0.1)
    batch_fn = make_batch_fn(cfg, InputShape("train_4k", "train", LM_SEQ,
                                             LM_BATCH), device=dev)
    state0 = init_state(model, seed=0, device=dev)
    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(
            state0, timed_step, batch_fn, steps=LM_STEPS,
            eval_step=make_eval_step(model), eval_batch_fn=batch_fn,
            eval_every=LM_STEPS, log_every=1, seed=0)
    # K4 once forward and once backward a step and once forward for the
    # eval, K1 twice a step; no other kernel
    counts = _read_path("lm_train", {"k4": LM_STEPS + 1,
                                     "k4_bwd": LM_STEPS,
                                     "k1": 2 * LM_STEPS})
    fwd, bwd, k1 = counts["k4"], counts["k4_bwd"], counts["k1"]
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in history if "loss" in h]
    evals = [h["eval_loss"] for h in history if "eval_loss" in h]
    if len(losses) != LM_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"lm_train: losses not all finite: {losses}")
    if len(evals) != 1 or not math.isfinite(evals[0]):
        fail(f"lm_train: eval gave {evals}")
    if not sink.find("run_stop"):
        fail("lm_train: loop.train did not reach run_stop")
    q1, med, q3 = statistics.quantiles(times, n=4)
    print(f"lm_train: losses {[round(v, 4) for v in losses]}; eval loss "
          f"{evals[0]:.4f}", flush=True)
    print(f"lm_train: step times ms {[round(t * 1e3, 2) for t in times]}; "
          f"median {med * 1e3:.2f} ms (p25 {q1 * 1e3:.2f}, p75 "
          f"{q3 * 1e3:.2f}), {LM_BATCH * LM_SEQ / med:.0f} tokens/s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches K4 forward {fwd}, "
          f"backward {bwd}, K1 {k1}", flush=True)
    return model, state0, batch_fn(0), counts


def check_lm_train_in_context(dev, model, state0, batch):
    """One step with the K4 loss and two with the loss built on K4's plain
    version, from one state and batch; and K4's gradient against autograd
    of the plain version on that step's own logits.

    The new params cannot agree to 1e-5 of each tensor's max, the bound of
    the ResNet context checks (which compare steps with one loss and so
    one set of gradients). The LM step differentiates the bf16 compute
    copy: K4's dlogits, which differ from autograd's in the last f32 bits,
    round to bf16 differently here and there, and the flipped roundings
    spread through 24 layers of bf16 backward until the weight gradients
    differ by about one bf16 rounding in most elements. The two plain steps
    are bit-identical, so the spread is rounding, not nondeterminism. Held
    instead: the loss to 1e-5 relative, the gradient at the logits to the
    kernel's own bound, the plain steps bit for bit, and each tensor's new
    params to ``LM_UPDATE_TOL`` of its largest update element; the figure
    against the tensor's max is printed beside them."""
    import torch
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import smoothed_xent as sx
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    sched = make_schedule(ScheduleConfig(base_lr=LM_LR,
                                         total_steps=LM_STEPS))
    step = make_train_step(model, lars.OptConfig(use_kernel=True), sched,
                           smoothing=0.1)
    fwd, bwd = _counters()["k4"], _counters()["k4_bwd"]
    _zero(fwd, bwd)
    got, m = step(state0, batch)
    kernel = ops.smoothed_xent_rows
    ops.smoothed_xent_rows = lambda x, y, s: ref.smoothed_xent_rows(
        x, y, smoothing=s)
    try:
        want, wm = step(state0, batch)
        again, _ = step(state0, batch)
    finally:
        ops.smoothed_xent_rows = kernel
    torch.cuda.synchronize()
    if (fwd.launches, bwd.launches) != (1, 1):
        fail(f"lm_train context: K4 launched {fwd.launches} / "
             f"{bwd.launches} times for one kernel step and two plain steps")
    d_loss = abs(float(m["loss"]) - float(wm["loss"])) / abs(
        float(wm["loss"]))

    # the gradient at the step's own logits, as the loss hands it to K4
    with torch.no_grad():
        (logits, _), _ = model.forward_train(state0.params, batch)
    logits = logits.reshape(-1, logits.shape[-1])
    labels = batch["labels"].reshape(-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    g = valid.float() / valid.sum()
    _, lse = sx.smoothed_xent_rows_forward(logits, safe, 0.1)
    dx = sx.smoothed_xent_rows_backward(logits, safe, lse, g, 0.1)
    xp = logits.requires_grad_()
    (want_dx,) = torch.autograd.grad(
        ref.smoothed_xent_rows(xp, safe, smoothing=0.1), xp, g)
    rtol, atol = XENT_BWD_TOL["float32"]
    dx_ok, dx_err, dx_per_g = _dx_close(dx, want_dx, g, rtol, atol)
    del logits, xp, dx, want_dx

    rows = []
    for (n, a), (_, b), (_, c), (_, p0) in zip(
            tree_flatten(got.params), tree_flatten(want.params),
            tree_flatten(again.params), tree_flatten(state0.params)):
        d = (a - b).abs().max().item()
        upd = (b - p0).abs().max().item()
        rows.append((n, d / max(b.abs().max().item(), 1e-30),
                     d / max(upd, 1e-30), upd, torch.equal(b, c)))
    of_max = max(rows, key=lambda r: r[1])
    of_upd = max(rows, key=lambda r: r[2])
    print(f"lm_train context: K4 loss vs plain loss differ by {d_loss:.3e} "
          f"relative (limit {LM_CONTEXT_TOL}); dlogits by {dx_err:.3e} at "
          f"most, {dx_per_g:.3e} per unit of g (rtol {rtol}, atol "
          f"{atol}·g); two plain steps "
          f"{'bit-identical' if all(r[4] for r in rows) else 'DIFFER'}; new "
          f"params differ by {of_upd[2]:.3e} of the largest update "
          f"({of_upd[0]}; limit {LM_UPDATE_TOL}), by {of_max[1]:.3e} of the "
          f"tensor's max ({of_max[0]}; not held, see the docstring); "
          f"smallest largest-update {min(r[3] for r in rows):.3e}",
          flush=True)
    if not (d_loss <= LM_CONTEXT_TOL and dx_ok and all(r[4] for r in rows)
            and of_upd[2] <= LM_UPDATE_TOL
            and min(r[3] for r in rows) > 0.0):
        fail("the step with the K4 loss disagrees with the plain step")
    return {"loss_rel_diff": d_loss, "dlogits_max_abs_err": dx_err,
            "dlogits_max_err_per_unit_g": dx_per_g,
            "param_diff_of_update": [of_upd[0], of_upd[2]],
            "param_diff_of_max": [of_max[0], of_max[1]]}


def _ring_configs(n: int):
    """(mesh, schedule, sharding, gather) of the ring phase on ``n``
    cards: every rung over the data axis, and on four cards the ring
    family and dbtree on the (pod 2, data 2) mesh."""
    out = [("data", "ring", "replicated", None), ("data", "ring", "zero1",
                                                  None),
           ("data", "ring", "zero2", None), ("data", "ring", "zero3",
                                             "per_group")]
    if n == 4:
        out += [("pod", comm, "replicated", None)
                for comm in ("ring", "hierarchical", "2d_torus", "dbtree")]
    return out


def _folds_a_step(mesh, comm: str, n_buckets: int) -> int:
    """K3 launches a step: a ring reduce-scatter along an axis of m ranks
    folds m - 1 times a bucket. ring and 2d_torus reduce-scatter along
    every axis (the shard axis, then the shard's ring across the others);
    hierarchical only along the shard axis (a fused all-reduce across
    pods); psum and dbtree never fold through K3."""
    from repro_torch.comm.schedules import shard_axis
    if comm in ("ring", "2d_torus"):
        return n_buckets * sum(a.size - 1 for a in mesh.axes)
    if comm == "hierarchical":
        return n_buckets * (shard_axis(mesh.axes).size - 1)
    return 0


def _ring_run(model, mesh, comm, sharding, gather, say):
    """One configuration of the ring phase: ``RING_STEPS`` steps of
    full-width ResNet-50 (batch ``BATCH`` a card, the slice's recipe)
    through make_train_step + loop.train, K3 and K2 on; checks the
    launches of K3, K1 and K2 and the losses. Returns its row."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step

    dev, n = mesh.device, mesh.size
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH * n) / 4, warmup_steps=1,
        total_steps=RING_STEPS, decay="poly2"))
    step = make_train_step(
        model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                              use_kernel=True),
        sched, smoothing=0.1, mesh=mesh,
        comm=CommConfig(strategy=comm, sharding=sharding, gather=gather,
                        use_kernel=True, update_kernel=True, bucket_mb=4))
    plan = step.bucket_plan
    what = (f"{comm} {sharding}{'/' + gather if gather else ''} on "
            f"{dict(zip(mesh.axis_names, [a.size for a in mesh.axes]))}")
    if plan.n_buckets != 16 or step.sharding != sharding:
        fail(f"ring {what}: {plan.n_buckets} buckets, sharding "
             f"{step.sharding!r}")
    batch_fn = make_batch_fn(model.cfg, InputShape("in", "train", 0,
                                                   BATCH * n),
                             device=dev, mesh=mesh)
    state0 = init_state(model, seed=100000, device=dev,
                        **sharded_state_kwargs(step))
    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state0, timed_step, batch_fn,
                                    steps=RING_STEPS, log_every=1,
                                    seed=100000)
    nb = plan.n_buckets
    sharded = sharding != "replicated"
    counts = _read_path(f"ring {what}", {
        "k3": _folds_a_step(mesh, comm, nb) * RING_STEPS,
        "k1": (1 if sharded else 2) * RING_STEPS,
        "k2": (1 if sharded else 0) * RING_STEPS})
    a_step = {key: v / RING_STEPS for key, v in counts.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    peaks = [None] * n
    dist.all_gather_object(peaks, peak)
    del state, state0
    losses = [h["loss"] for h in history]
    if len(losses) != RING_STEPS or not all(math.isfinite(v)
                                            for v in losses):
        fail(f"ring {what}: losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail(f"ring {what}: loop.train did not reach run_stop")
    med = statistics.median(times[1:])      # the first step warms up
    say(f"ring: {what}: losses {[round(v, 4) for v in losses]}; step times "
        f"ms {[round(t * 1e3, 2) for t in times]}, median after the first "
        f"{med * 1e3:.2f} ms, {BATCH * n / med:.1f} images/s on {n} cards; "
        f"peak memory a "
        f"rank GiB {[round(p / 2 ** 30, 2) for p in peaks]}; launches a "
        f"step K3 {a_step['k3']:g}, K1 {a_step['k1']:g}, K2 "
        f"{a_step['k2']:g}")
    return {"mesh": dict(zip(mesh.axis_names, [a.size for a in mesh.axes])),
            "comm": comm, "sharding": sharding, "gather": gather,
            "step_ms": [t * 1e3 for t in times], "median_ms": med * 1e3,
            "images_per_s": BATCH * n / med,
            "peak_gib": [p / 2 ** 30 for p in peaks], "launches": counts,
            "k3_a_step": a_step["k3"], "losses": losses}


def _ring_bits(model, meshes, batch, say):
    """One packed bf16 gradient (this rank's, from one backward) through
    the ring all-reduce and every schedule's reduce-scatter form, with K3
    and with the plain fold: the outputs must be equal bit for bit. Only
    the ring all-reduce and the ring, hierarchical and 2d_torus forms fold
    through K3 (psum and dbtree ignore ``use_kernel``), so those are
    counted apart: returns (compared, of them through K3). The
    ring all-reduce pads its rows to CHUNK only with the kernel (and
    beyond two ranks the chunk cut sets the order of the sums), so its
    plain side is the same ring at ``pad_to=CHUNK``."""
    import torch
    from repro_torch.comm import get_reduce_scatter, get_schedule
    from repro_torch.comm import primitives as prim
    from repro_torch.comm import ring_kernel
    from repro_torch.core import bucketing
    from repro_torch.core.bucketing import CHUNK
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_flatten, tree_unflatten

    dev = next(iter(meshes.values())).device
    s0 = init_state(model, seed=7, device=dev)
    flat = tree_flatten(s0.params)
    leaves = [x.detach().requires_grad_() for _, x in flat]
    total, _ = make_loss_fn(model)(tree_unflatten([p for p, _ in flat],
                                                  leaves), batch,
                                   s0.bn_state)
    grads = tree_unflatten([p for p, _ in flat],
                           torch.autograd.grad(total, leaves))
    plan = bucketing.make_plan(model.param_pd)
    bufs = bucketing.pack(grads, plan, dtype=torch.bfloat16)
    del grads, leaves, total
    names = ("psum", "ring", "hierarchical", "2d_torus", "dbtree")
    compared = folded = 0
    for mname, mesh in meshes.items():
        axes = mesh.axes
        before = ring_kernel.ring_add_step.launches
        for b, buf in enumerate(bufs):
            got = get_schedule("ring")(buf.clone(), axes, use_kernel=True)
            want = buf.clone()
            for axis in reversed(axes):
                want = prim.ring_all_reduce(want, axis,
                                            step_fn=prim.default_step_fn,
                                            pad_to=CHUNK)
            pairs = [("ring", got, want)]
            for name in names:
                rs = get_reduce_scatter(name)
                pairs.append((f"{name} reduce-scatter",
                              rs(buf.clone(), axes, use_kernel=True),
                              rs(buf.clone(), axes, use_kernel=False)))
            for what, x, y in pairs:
                if x.dtype != torch.bfloat16 or not torch.equal(x, y):
                    fail(f"ring context: {what} on {mname}, bucket {b}: "
                         f"K3 and the plain fold differ")
                compared += 1
                folded += not what.startswith(("psum", "dbtree"))
        if ring_kernel.ring_add_step.launches == before:
            fail(f"ring context: K3 was not launched on {mname}")
    say(f"ring context: a packed bf16 gradient ({plan.n_buckets} buckets) "
        f"through the ring all-reduce and the reduce-scatter forms of "
        f"{list(names)} on {list(meshes)}: {compared} outputs bit-equal with "
        f"K3 and with the plain fold, {folded} of them folded through K3 "
        f"(psum and dbtree ignore use_kernel)")
    return compared, folded


def _ring_masters(model, meshes, batch, say):
    """With f32 wire, every schedule and rung (K1, K2 and K3 on) against
    the replicated psum step (per-tensor norms, no kernel) from one state
    and batch: the masters must agree to 1e-5 of each tensor's max, the
    bar of ``check_zero1_in_context``."""
    import torch
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.train import state as st
    from repro_torch.train.loop import make_params_reader
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    dev = next(iter(meshes.values())).device
    sched = make_schedule(ScheduleConfig(base_lr=1.0, total_steps=STEPS))
    s0 = st.init_state(model, seed=7, device=dev)
    worst_all, rows = 0.0, {}
    torch.backends.cudnn.deterministic = True
    try:
        for mname, mesh in meshes.items():
            comm = lambda **kw: CommConfig(wire_dtype="f32", bucket_mb=4,
                                           **kw)
            want = make_train_step(
                model, lars.OptConfig(use_kernel=False), sched, mesh=mesh,
                comm=comm(strategy="psum"))(s0, batch)[0].params
            for name in ("naive", "psum", "bucketed", "ring",
                         "hierarchical", "2d_torus", "dbtree"):
                rungs = (("replicated",) if name == "naive" else
                         ("replicated", "zero1", "zero2", "zero3"))
                for sharding in rungs:
                    step = make_train_step(
                        model, lars.OptConfig(use_kernel=True), sched,
                        mesh=mesh, comm=comm(strategy=name,
                                             sharding=sharding,
                                             use_kernel=True,
                                             update_kernel=True))
                    state = s0
                    if sharding != "replicated":
                        plan, n = step.bucket_plan, step.n_shards
                        i = mesh.axis(step.shard_axis).index
                        packed = lambda tree: st.local_shards(
                            st.init_packed_shards(tree, plan, n), n, i)
                        state = st.TrainState(
                            0, None if sharding == "zero3" else s0.params,
                            packed(s0.mom), s0.bn_state,
                            None if sharding == "zero2"
                            else packed(s0.params))
                    got = make_params_reader(step)(step(state, batch)[0])
                    worst = 0.0
                    for (_, a), (_, b) in zip(tree_flatten(got),
                                              tree_flatten(want)):
                        worst = max(worst, (a - b).abs().max().item()
                                    / max(b.abs().max().item(), 1e-30))
                    rows[f"{mname}/{name}/{sharding}"] = worst
                    worst_all = max(worst_all, worst)
                    if not worst <= 1e-5:
                        fail(f"ring context: {name} {sharding} on {mname}: "
                             f"masters {worst:.3e} of a tensor's max from "
                             f"the replicated psum step (limit 1e-5)")
                    del got, state
    finally:
        torch.backends.cudnn.deterministic = False
    say(f"ring context: f32 wire, {len(rows)} schedule x rung steps on "
        f"{list(meshes)} against the replicated psum step: masters within "
        f"{worst_all:.3e} of each tensor's max (limit 1e-5)")
    return worst_all, rows


def ring_rank():
    """One rank of the ring phases (``chip_smoke.py --ring-rank`` under
    torch.distributed.run, one card each): the ring phase's
    configurations, then the ring context. Rank 0 prints the lines and,
    last, ``ring-json: {...}``."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.models.registry import build_model

    base = make_local_mesh()
    n, rank = base.size, base.rank
    say = (lambda msg: print(msg, flush=True)) if rank == 0 else \
        (lambda msg: None)
    meshes = {"data": base}
    if n == 4:
        meshes["pod"] = make_mesh((2, 2), ("pod", "data"))
    model = build_model(get_config("resnet50"))
    rows = [_ring_run(model, meshes[m], comm, sharding, gather, say)
            for m, comm, sharding, gather in _ring_configs(n)]
    torch.cuda.empty_cache()
    batch = make_batch_fn(model.cfg, InputShape("in", "train", 0, BATCH * n),
                          device=base.device, mesh=base)(0)
    compared, folded = _ring_bits(model, meshes, batch, say)
    worst, masters = _ring_masters(model, meshes, batch, say)
    say("ring-json: " + json.dumps({"cards": n, "runs": rows,
                                    "bit_equal_outputs": compared,
                                    "bit_equal_through_k3": folded,
                                    "masters_worst": worst,
                                    "masters": masters}))
    base.destroy()


def _launch_ranks(args, n: int, timeout_s: float, what: str) -> str:
    """This script under ``torch.distributed.run`` on ``n`` cards, one
    rank each, with ``args``; rank 0's standard output. Fails if a rank
    fails or the run outlasts ``timeout_s`` (then every rank is killed)."""
    import signal
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(n), "--master-addr", "127.0.0.1", "--master-port", str(port),
           str(ROOT / "chip_smoke.py"), *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env=dict(os.environ, OMP_NUM_THREADS="4"))
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{what} did not end within {timeout_s} s")
    if proc.returncode != 0:
        for line in out.splitlines()[-20:]:
            print(line, flush=True)
        fail(f"{what} exited {proc.returncode}: {err[-4000:]}")
    return out


def run_ring():
    """The ring phases on min(count, 4) cards, one rank each over NCCL
    (``torch.distributed.run`` starts this script with ``--ring-rank``);
    None on one card."""
    import torch
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print(f"ring: not run: {n} card; the multi-card path needs >= 2 "
              f"(NCCL gives each rank a card of its own)", flush=True)
        return None
    torch.cuda.empty_cache()
    out = _launch_ranks(["--ring-rank"], n, RING_TIMEOUT_S,
                        "the ring phases")
    result = None
    for line in out.splitlines():     # rank 0's lines; not the ranks'
        if line.startswith("ring-json: "):        # MLPerf tag streams
            result = json.loads(line[len("ring-json: "):])
        elif line.startswith("ring"):
            print(line, flush=True)
    if result is None:
        fail("the ring phases printed no result")
    return result


def check_lm_shard_site(dev):
    """K1 and K2 at the four-card LM step's call site, measured on one
    card: rank 0's shards of full-width qwen1.5-0.5b's 4 MB plan on 4
    shards (224 buckets, ~116 M f32 elements a rank). K1's one call over
    the 448 p and g shards (``batched_sumsq_multi``: two pass-1 launches,
    the pointer table holds 256) against its plain version at rtol 2e-3;
    K2's one call over the 224 buckets (``lars_packed_update_multi``: two
    launches, 128 a table) against its plain version at rtol 1e-5 / atol
    1e-6 and equal across two calls. Times each beside its plain version
    and bound. Returns ({'lm_shard_site': ...} for K1, the same for K2)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.kernels import batched_norm, lars_update, ref
    from repro_torch.models.registry import build_model

    plan = bucketing.make_plan(
        build_model(get_config("qwen1.5-0.5b")).param_pd)
    if plan.n_buckets != LM_RING_BUCKETS:
        fail(f"the qwen1.5-0.5b 4 MB plan has {plan.n_buckets} buckets, "
             f"not {LM_RING_BUCKETS}")
    gen = torch.Generator(device=dev).manual_seed(3)
    p, g, m, _, seg_all, trust = _shard_case(plan, 4, 0, dev, gen)
    n_t = plan.n_tensors
    got = batched_norm.batched_sumsq_multi((p, g), seg_all, n_t)
    want = ref.batched_sumsq_multi((p, g), seg_all, n_t)
    torch.cuda.synchronize()
    k1_rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    if not k1_rel <= 2e-3:
        fail(f"batched_sumsq_multi at the LM shard site disagrees with its "
             f"plain version (max rel err {k1_rel:.3e}, rtol 2e-3)")
    lr = torch.tensor(0.37, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, wd=5e-5)
    clone = lambda xs: [x.clone() for x in xs]
    runs = [lars_update.lars_packed_update_multi(clone(p), g, clone(m),
                                                 trust, seg_all, **kw)
            for _ in range(2)]
    want2 = ref.lars_packed_update_multi(clone(p), g, clone(m), trust,
                                         seg_all, **kw)
    torch.cuda.synchronize()
    k2_abs = 0.0
    for b in range(plan.n_buckets):
        for x, x2, y in ((runs[0][0][b], runs[1][0][b], want2[0][b]),
                         (runs[0][1][b], runs[1][1][b], want2[1][b])):
            if not torch.equal(x, x2):
                fail(f"lars_packed_update_multi at the LM shard site: two "
                     f"calls differ (bucket {b})")
            if not torch.allclose(x, y, rtol=1e-5, atol=1e-6):
                fail(f"lars_packed_update_multi at the LM shard site "
                     f"disagrees with its plain version (bucket {b}, rtol "
                     f"1e-5, atol 1e-6)")
            k2_abs = max(k2_abs, (x - y).abs().max().item())
    del runs, want2
    elems, chunks = sum(x.numel() for x in p), seg_all.numel()
    k1_ms = time_ms(lambda: batched_norm.batched_sumsq_multi(
        (p, g), seg_all, n_t), iters=20, warmup=3)
    k1_plain = time_ms(lambda: ref.batched_sumsq_multi((p, g), seg_all, n_t),
                       iters=5, warmup=1)
    k1_b, k1_by = bound_ms(2 * 4 * elems + 4 * chunks + 2 * 4 * n_t,
                           2 * 2 * elems)
    k2_ms = time_ms(lambda: lars_update.lars_packed_update_multi(
        p, g, m, trust, seg_all, **kw), iters=20, warmup=3)
    k2_plain = time_ms(lambda: ref.lars_packed_update_multi(
        p, g, m, trust, seg_all, **kw), iters=5, warmup=1)
    k2_b, k2_by = bound_ms(5 * 4 * elems + 4 * chunks + 4 * n_t + 4,
                           6 * elems)
    # the device alone, the host's table packing hidden
    k1_dev = device_ms(lambda: batched_norm.batched_sumsq_multi(
        (p, g), seg_all, n_t), iters=10)
    k2_dev = device_ms(lambda: lars_update.lars_packed_update_multi(
        p, g, m, trust, seg_all, **kw), iters=10)
    dev_us = lambda t: "host-paced" if t is None else f"{t * 1e3:.1f} us"
    print(f"LM shard site (qwen1.5-0.5b 4 MB plan, {plan.n_buckets} "
          f"buckets, rank 0 of 4, {elems} elements): batched_sumsq_multi "
          f"over {2 * plan.n_buckets} shards {k1_ms * 1e3:.1f} us (device "
          f"alone {dev_us(k1_dev)}), plain "
          f"{k1_plain * 1e3:.1f} us, bound {k1_b * 1e3:.1f} us ({k1_by}), "
          f"max rel err {k1_rel:.3e} (rtol 2e-3); lars_packed_update_multi "
          f"over {plan.n_buckets} buckets {k2_ms * 1e3:.1f} us (device "
          f"alone {dev_us(k2_dev)}), plain "
          f"{k2_plain * 1e3:.1f} us, bound {k2_b * 1e3:.1f} us ({k2_by}), "
          f"max abs err {k2_abs:.3e} (rtol 1e-5, atol 1e-6), two calls "
          f"bit-equal", flush=True)
    site = lambda ms, dev, plain, b, by, err: {
        "shape": f"qwen1.5-0.5b 4 MB plan, rank 0 of 4: {plan.n_buckets} "
                 f"buckets, {elems} elements", "ms": ms, "device_ms": dev,
        "plain_ms": plain, "bound_ms": b, "bound_by": by, "max_err": err}
    return ({"lm_shard_site": site(k1_ms, k1_dev, k1_plain, k1_b, k1_by,
                                   k1_rel)},
            {"lm_shard_site": site(k2_ms, k2_dev, k2_plain, k2_b, k2_by,
                                   k2_abs)})


def _lm_sched():
    """The LM phases' schedule: LARS poly2 with a one-step warm-up."""
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    return make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                        total_steps=LM_STEPS, decay="poly2"))


def _lm_ring_state(state0, step, mesh):
    """The state ``step`` takes, from the replicated ``state0`` (fresh
    buffers: the sharded step updates its input in place): the packed
    master shards and zero momentum of this rank on a sharded rung, the
    params and a zero momentum replicated."""
    import torch
    from repro_torch.train import state as st
    from repro_torch.tree import tree_map
    if step.sharding == "replicated":
        return st.TrainState(0, tree_map(torch.clone, state0.params),
                             tree_map(torch.zeros_like, state0.params))
    plan, n = step.bucket_plan, step.n_shards
    i = mesh.axis(step.shard_axis).index
    return st.TrainState(
        0, None if step.sharding == "zero3"
        else tree_map(torch.clone, state0.params),
        st.local_shards(st.init_packed_momentum(plan, n, device=mesh.device),
                        n, i), None,
        None if step.sharding == "zero2"
        else st.local_shards(st.init_packed_shards(state0.params, plan, n),
                             n, i))


def _lm_ring_want(comm, sharding, nb, steps):
    """The launches a run of ``steps`` LM steps must read: K3 folds 3 a
    bucket a step on four cards' ring, K1 twice a replicated step and once
    a sharded one, K2 once a sharded step (update_kernel), K4 once forward
    and once backward; zero3's checkpointed loss runs its forward, K4
    included, again in the backward."""
    sharded = sharding != "replicated"
    return {"k3": (3 * nb if comm == "ring" else 0) * steps,
            "k1": (1 if sharded else 2) * steps,
            "k2": (1 if sharded else 0) * steps,
            "k4": (2 if sharding == "zero3" else 1) * steps,
            "k4_bwd": steps}


def _sha(tree) -> str:
    """sha256 over a tensor tree's bytes, leaves in flatten order."""
    import hashlib
    from repro_torch.tree import tree_flatten
    h = hashlib.sha256()
    for path, x in tree_flatten(tree):
        h.update(path.encode())
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _lm_ring_run(model, mesh, comm, sharding, gather, state0, batch_fn,
                 say, ckpt_dir=None):
    """One configuration of the lm_ring phase: one warm-up step on a copy
    of its state, then ``LM_RING_STEPS`` timed steps through loop.train.
    Checks the launches and the losses; with ``ckpt_dir``, saves the state
    there (every rank's rows gathered, rank 0 writing). Returns (row, the
    masters after the timed steps)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import checkpoint, loop
    from repro_torch.train.state import host_snapshot
    from repro_torch.train.step import make_train_step

    dev, n = mesh.device, mesh.size
    ring = comm == "ring"
    step = make_train_step(
        model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                              use_kernel=True), _lm_sched(), smoothing=0.1,
        mesh=mesh, comm=CommConfig(strategy=comm, sharding=sharding,
                                   gather=gather, use_kernel=ring,
                                   update_kernel=sharding != "replicated",
                                   bucket_mb=4))
    plan = step.bucket_plan
    what = f"{comm} {sharding}{'/' + gather if gather else ''}"
    if plan.n_buckets != LM_RING_BUCKETS or step.sharding != sharding:
        fail(f"lm_ring {what}: {plan.n_buckets} buckets, sharding "
             f"{step.sharding!r}")
    state = _lm_ring_state(state0, step, mesh)
    step(host_snapshot(state), batch_fn(0))       # the warm-up, on a copy
    times = []

    def timed_step(s, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(s, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state, timed_step, batch_fn,
                                    steps=LM_RING_STEPS, log_every=1,
                                    seed=0)
    counts = _read_path(f"lm_ring {what}", _lm_ring_want(
        comm, sharding, plan.n_buckets, LM_RING_STEPS))
    peak = torch.cuda.max_memory_allocated(dev)
    peaks = [None] * n
    dist.all_gather_object(peaks, peak)
    losses = [h["loss"] for h in history]
    if len(losses) != LM_RING_STEPS or not all(math.isfinite(v)
                                               for v in losses):
        fail(f"lm_ring {what}: losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail(f"lm_ring {what}: loop.train did not reach run_stop")
    masters = loop.make_params_reader(step)(state)
    row = {"comm": comm, "sharding": sharding, "gather": gather,
           "buckets": plan.n_buckets, "step_ms": [t * 1e3 for t in times],
           "median_ms": statistics.median(times) * 1e3,
           "tokens_per_s": LM_BATCH * LM_SEQ * n / statistics.median(times),
           "peak_gib": [p / 2 ** 30 for p in peaks], "launches": counts,
           "losses": losses}
    if ckpt_dir is not None:
        t = time.perf_counter()
        checkpoint.save(state, ckpt_dir, tag=LM_CKPT_TAG,
                        comm_plan=step.comm_plan, mesh=mesh)
        row["save_ms"] = (time.perf_counter() - t) * 1e3
        if mesh.rank == 0:
            row["masters_sha256"] = _sha(masters)
    del state
    say(f"lm_ring: {what} ({plan.n_buckets} buckets): losses "
        f"{[round(v, 4) for v in losses]}; step times ms "
        f"{[round(t * 1e3, 2) for t in times]} after a warm-up step, median "
        f"{row['median_ms']:.2f} ms, {row['tokens_per_s']:.0f} tokens/s on "
        f"{n} cards; peak memory a rank GiB "
        f"{[round(p / 2 ** 30, 2) for p in peaks]}; launches a step K3 "
        f"{counts['k3'] / LM_RING_STEPS:g}, K1 "
        f"{counts['k1'] / LM_RING_STEPS:g}, K2 "
        f"{counts['k2'] / LM_RING_STEPS:g}, K4 "
        f"{counts['k4'] / LM_RING_STEPS:g} + "
        f"{counts['k4_bwd'] / LM_RING_STEPS:g}"
        + (f"; saved in {row['save_ms']:.0f} ms" if ckpt_dir else ""))
    return row, masters


def _lm_ring_hw(mesh, say):
    """The card's constants measured now (``launch/hw.measure``: the link
    along the data axis, HBM, bf16 matmul) beside ``launch/hw.py``'s;
    fails if the link's alpha or beta or the HBM rate is more than
    ``HW_TOL`` times off the module's."""
    from repro_torch.launch import hw
    got = hw.measure(mesh)
    mod = hw.H100
    rows = {"alpha_s": (got["link"]["alpha"], mod.link_alpha),
            "beta_bytes_per_s": (got["link"]["beta"], mod.link_bw),
            "hbm_bytes_per_s": (got["hbm_bw"], mod.hbm_bw),
            "bf16_flops_per_s": (got["peak_flops_bf16"],
                                 mod.peak_flops_bf16)}
    say(f"lm_ring hw: measured / launch/hw.py: "
        + ", ".join(f"{k} {a:.4g} / {b:.4g}" for k, (a, b) in rows.items())
        + f"; link fit's largest relative residual "
          f"{got['link']['residual']:.3f} over "
          f"{[r[0] for r in got['link']['rows']]} bytes")
    for k in ("alpha_s", "beta_bytes_per_s", "hbm_bytes_per_s"):
        a, b = rows[k]
        if not (a > 0 and max(a / b, b / a) <= HW_TOL):
            fail(f"lm_ring hw: the measured {k} {a:.4g} is more than "
                 f"{HW_TOL}x off launch/hw.py's {b:.4g}")
    return {"measured": got, "module": {k: b for k, (_, b) in rows.items()}}


def _autotune_reading(model, mesh, batch_fn, name, say, want_fn, sched):
    """``bucket_mb='auto'`` with ``backward_profile='measured'`` on ring
    zero1 (K1, K2, K3 on): the chosen bucket size and the simulated step
    time, then 3 traced steps through loop.train: the measured step time
    (median of the last two) and obs.drift.compute's measured / predicted
    per span kind (the first step skipped). Fails if the profile fell back
    to the FLOPs model."""
    import torch
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.obs import drift as obs_drift
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import loop
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step

    sink, tracer = obs_metrics.MemorySink(), Tracer()
    with obs_metrics.default_registry().use_sink(sink):
        step = make_train_step(
            model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                                  use_kernel=True), sched, smoothing=0.1,
            mesh=mesh, comm=CommConfig(
                strategy="ring", sharding="zero1", bucket_mb="auto",
                backward_profile="measured", use_kernel=True,
                update_kernel=True), profile_batch=batch_fn(0),
            tracer=tracer)
    if sink.find("backward_profile_fallback") or \
            not sink.find("backward_profile_measured"):
        fail(f"autotune {name}: the measured profile was not used: "
             f"{[(e.name, e.value) for e in sink.events]}")
    tuned, prof = step.tuned, step.backward_profile
    state = init_state(model, 0, device=mesh.device,
                       **sharded_state_kwargs(step))
    times = []

    def timed_step(s, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(s, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(obs_metrics.MemorySink()):
        state, history = loop.train(state, timed_step, batch_fn, steps=3,
                                    log_every=1, seed=0, tracer=tracer)
    counts = _read_path(f"autotune {name}",
                        want_fn(step.bucket_plan.n_buckets, 3))
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        fail(f"autotune {name}: losses not all finite: {losses}")
    drifts = obs_drift.compute(tracer, step.comm_plan)
    kinds = {}
    for k in obs_drift.COMM_KINDS:
        ds = [d for d in drifts if d.kind == k]
        if ds:
            kinds[k] = {"spans": len(ds), "measured_s":
                        sum(d.measured_s for d in ds), "predicted_s":
                        sum(d.predicted_s for d in ds),
                        "rel_err": obs_drift.aggregate(ds)}
    if not kinds:
        fail(f"autotune {name}: no traced bucket comm span to score")
    # where the collectives start: each rs span's begin (the moment its
    # group's identity ran) in ms after the last step's backward span
    # begins, that span's length (it ends once the last shard is back),
    # and the measured profile's share of groups stamped in the backward's
    # last tenth
    last = tracer.steps[-1][1]
    bwd = next(sp for sp in last if sp.name == "backward")
    bwd_ms = (bwd.t1 - bwd.t0) * 1e3
    starts = sorted((sp.t0 - bwd.t0) * 1e3 for sp in last
                    if sp.name.startswith("rs["))
    late = sum(t >= 0.9 * prof.total_s for t in prof.cum_time_s) \
        / len(prof.cum_time_s)
    measured = statistics.median(times[1:])
    say(f"autotune {name} (ring zero1, bucket_mb='auto', measured "
        f"profile: {len(prof.cum_elems)} groups, backward "
        f"{prof.total_s * 1e3:.1f} ms, forward {prof.t_forward_s * 1e3:.1f}"
        f" ms): chose {tuned.bucket_mb:g} MB x {tuned.n_buckets} buckets "
        f"({tuned.sim.mode}); simulated step {tuned.sim.t_step_s * 1e3:.2f} "
        f"ms, measured {measured * 1e3:.2f} ms (traced; steps "
        f"{[round(t * 1e3, 2) for t in times]}); drift measured/predicted "
        f"per span kind: "
        + ", ".join(f"{k} {v['measured_s'] * 1e3:.3f} / "
                    f"{v['predicted_s'] * 1e3:.3f} ms over {v['spans']} "
                    f"spans (rel err {v['rel_err']:+.3f})"
                    for k, v in kinds.items())
        + f"; rs spans begin {starts[0]:.1f} / "
          f"{statistics.median(starts):.1f} / {starts[-1]:.1f} ms (first / "
          f"median / last) into a {bwd_ms:.1f} ms backward span; the "
          f"profile stamped {late:.3f} of its groups in the backward's "
          f"last tenth")
    del state
    return {"bucket_mb": tuned.bucket_mb, "buckets": tuned.n_buckets,
            "mode": tuned.sim.mode, "sim_step_ms": tuned.sim.t_step_s * 1e3,
            "sim_exposed_ms": tuned.sim.t_exposed_s * 1e3,
            "profile_backward_ms": prof.total_s * 1e3,
            "profile_forward_ms": prof.t_forward_s * 1e3,
            "measured_step_ms": measured * 1e3,
            "step_ms": [t * 1e3 for t in times], "drift": kinds,
            "rs_begin_ms": [starts[0], statistics.median(starts),
                            starts[-1]], "backward_span_ms": bwd_ms,
            "profile_groups_in_last_tenth": late,
            "launches": counts, "losses": losses}


def lm_ring_rank(ckpt_dir):
    """One rank of the lm_ring phase (``chip_smoke.py --lm-ring-rank DIR``
    under torch.distributed.run, one card each): the card's constants,
    the LM configurations (masters against the psum anchor's; ring zero1's
    state saved to DIR), then the autotune readings. Rank 0 prints the
    lines and, last, ``lm-ring-json: {...}``."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.tree import tree_flatten

    mesh = make_local_mesh()
    n, dev = mesh.size, mesh.device
    say = (lambda msg: print(msg, flush=True)) if mesh.rank == 0 else \
        (lambda msg: None)
    hw_row = _lm_ring_hw(mesh, say)
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    batch_fn = make_batch_fn(cfg, InputShape("train_4k", "train", LM_SEQ,
                                             LM_BATCH * n), device=dev,
                             mesh=mesh)
    state0 = init_state(model, seed=0, device=dev)
    p0 = [x for _, x in tree_flatten(state0.params)]
    rows, anchor, worst = [], None, ("", 0.0)
    for comm, sharding, gather in LM_RING_CONFIGS:
        save = ckpt_dir if (comm, sharding) == ("ring", "zero1") else None
        row, masters = _lm_ring_run(model, mesh, comm, sharding, gather,
                                    state0, batch_fn, say, save)
        got = tree_flatten(masters)
        if anchor is None:
            anchor = [(p, x, (x - a).abs().max().item())
                      for (p, x), a in zip(got, p0)]
        else:
            d = max(((p, (x - want).abs().max().item() / max(upd, 1e-30))
                     for (_, x), (p, want, upd) in zip(got, anchor)),
                    key=lambda t: t[1])
            row["masters_of_update"] = list(d)
            worst = max(worst, d, key=lambda t: t[1])
            say(f"lm_ring: {comm} {sharding}: masters within {d[1]:.3e} of "
                f"the largest update of the psum anchor's ({d[0]}; limit "
                f"{LM_UPDATE_TOL})")
            if not d[1] <= LM_UPDATE_TOL:
                fail(f"lm_ring {comm} {sharding}: masters {d[1]:.3e} of the "
                     f"anchor's largest update off ({d[0]}; limit "
                     f"{LM_UPDATE_TOL})")
        rows.append(row)
        del masters, got
        torch.cuda.empty_cache()
    if min(upd for _, _, upd in anchor) <= 0.0:
        fail("lm_ring: the psum anchor left a tensor unchanged")
    del anchor, state0, p0
    torch.cuda.empty_cache()
    sharded = lambda nb, steps: _lm_ring_want("ring", "zero1", nb, steps)
    tune = {"lm": _autotune_reading(model, mesh, batch_fn, "qwen1.5-0.5b",
                                    say, sharded, _lm_sched())}
    del model
    torch.cuda.empty_cache()
    rcfg = get_config("resnet50")
    rbatch = make_batch_fn(rcfg, InputShape("in", "train", 0, BATCH * n),
                           device=dev, mesh=mesh)
    tune["resnet50"] = _autotune_reading(
        build_model(rcfg), mesh, rbatch, "resnet50", say,
        lambda nb, steps: {"k3": 3 * nb * steps, "k1": steps, "k2": steps},
        make_schedule(ScheduleConfig(
            base_lr=linear_scaled_lr(16.0, BATCH * n) / 4, warmup_steps=1,
            total_steps=RING_STEPS, decay="poly2")))
    say("lm-ring-json: " + json.dumps({
        "cards": n, "runs": rows, "masters_worst_of_update": list(worst),
        "hw": hw_row, "autotune": tune}))
    mesh.destroy()


def run_lm_ring(ckpt_dir):
    """The lm_ring phase on four cards, one rank each over NCCL
    (``torch.distributed.run`` starts this script with ``--lm-ring-rank``);
    None with fewer than four cards."""
    import torch
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    if n < 4:
        print(f"lm_ring: not run: {n} card(s); the phase needs 4", flush=True)
        return None
    out = _launch_ranks(["--lm-ring-rank", str(ckpt_dir)], 4,
                        LM_RING_TIMEOUT_S, "the lm_ring phase")
    result = None
    for line in out.splitlines():
        if line.startswith("lm-ring-json: "):
            result = json.loads(line[len("lm-ring-json: "):])
        elif line.startswith(("lm_ring", "autotune")):
            print(line, flush=True)
    if result is None:
        fail("the lm_ring phase printed no result")
    return result


def run_lm_resume(dev, ckpt_dir, lm_ring):
    """The four-card ring zero1 LM's checkpoint resumed on this one card
    (``elastic.load_resharded``, 4 -> 1 shards over the LM's split-leaf
    plan): the masters bit-equal to the four ranks' gathered rows (sha256
    against rank 0's), then one step with a finite loss (K1, K2, K4)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint, elastic
    from repro_torch.train.loop import make_params_reader
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step

    want = next(r for r in lm_ring["runs"] if r["sharding"] == "zero1")
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    saved = checkpoint.load_comm_plan(str(ckpt_dir), tag=LM_CKPT_TAG)
    if saved.n_shards != 4 or saved.sharding != "zero1":
        fail(f"lm_ring resume: the saved plan has {saved.n_shards} shards, "
             f"sharding {saved.sharding!r}")
    mesh = make_local_mesh()
    try:
        step = make_train_step(
            model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                                  use_kernel=True), _lm_sched(),
            smoothing=0.1, mesh=mesh,
            comm=saved.comm_config(reautotune=True))
        template = init_state(model, 0, device=dev,
                              **sharded_state_kwargs(step))
        t = time.perf_counter()
        state = elastic.load_resharded(str(ckpt_dir), template,
                                       step.bucket_plan, 1, tag=LM_CKPT_TAG,
                                       old_comm_plan=saved, mesh=mesh)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t) * 1e3
        del template
        sha = _sha(make_params_reader(step)(state))
        if sha != want["masters_sha256"]:
            fail("lm_ring resume: the masters resumed on one card are not "
                 "bit-equal to the four ranks' gathered rows")
        batch = make_batch_fn(cfg, InputShape("train_4k", "train", LM_SEQ,
                                              LM_BATCH), device=dev)(
            state.step)
        _zero(*_counters().values())
        state, m = step(state, batch)
        torch.cuda.synchronize()
        counts = _read_path("lm_ring resume", {"k1": 1, "k2": 1, "k4": 1,
                                               "k4_bwd": 1})
        loss = float(m["loss"])
        if not math.isfinite(loss) or state.step != LM_RING_STEPS + 1:
            fail(f"lm_ring resume: step {state.step}, loss {loss}")
    finally:
        mesh.destroy()
    print(f"lm_ring resume: the ring zero1 checkpoint ({saved.n_shards} "
          f"shards, {len(saved.bucket_sizes)} buckets, saved in "
          f"{want['save_ms']:.0f} ms) resumed on one card (1 shard) in "
          f"{load_ms:.0f} ms: masters bit-equal to the gathered rows "
          f"(sha256); then step {state.step} on one card, loss {loss:.4f}",
          flush=True)
    return {"load_ms": load_ms, "loss": loss, "launches": counts}


def run_serve(dev):
    """Full-width qwen1.5-0.5b served through serve.decode.generate with
    the flash kernel in the prefill, as examples/serve_decode.py drives
    the JAX package (at full width here)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import generate
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              flash_attention=True)
    model = build_model(cfg)
    t = time.perf_counter()
    params = pinit.materialize(model.param_pd, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": tokens}
    # warm-up (cuBLAS handles, first launches); not timed, not counted
    generate(model, params, batch, max_new=2, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    _zero(*_counters().values())
    out = generate(model, params, batch, max_new=SERVE_NEW,
                   cache_len=SERVE_CACHE, timings=timings)
    torch.cuda.synchronize()
    # K5 once a layer, in the prefill; no other kernel
    counts = _read_path("serve", {"k5": cfg.n_layers})
    launches = counts["k5"]
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(out.shape) != (SERVE_BATCH, SERVE_NEW):
        fail(f"serve: generated shape {tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail("serve: a token outside the vocabulary")
    dec = timings["decode_ms"]
    q1, med, q3 = statistics.quantiles(dec, n=4)
    print(f"serve: {n_params / 1e6:.1f} M params, pinit {init_s:.2f} s; "
          f"prefill {timings['prefill_ms']:.2f} ms "
          f"({SERVE_BATCH * SERVE_PROMPT / timings['prefill_ms'] * 1e3:.0f}"
          f" prompt tokens/s); decode ms a token median {med:.3f} "
          f"(p25 {q1:.3f}, p75 {q3:.3f}, {len(dec)} steps), "
          f"{SERVE_BATCH * 1e3 / med:.1f} tokens/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; flash_attention launches {launches}",
          flush=True)
    print(f"serve: first request's tokens {out[0].tolist()}", flush=True)
    return model, params, batch, out, counts


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def check_serve_in_context(dev, model, params, batch, out):
    """The K5 prefill against the chunked one (no kernel), and one decode
    step from the K5 cache against the chunked full forward."""
    import dataclasses

    import torch
    from repro_torch.core.precision import cast_to_compute
    from repro_torch.models.registry import build_model

    plain = build_model(dataclasses.replace(model.cfg,
                                            flash_attention=False))
    p16 = cast_to_compute(params)
    k5_last, cache = model.forward_prefill(p16, batch, SERVE_CACHE)
    if not bool(torch.isfinite(k5_last).all()):
        fail("serve context: non-finite prefill logits")
    if not torch.equal(k5_last[:, -1].argmax(-1).int(), out[:, 0]):
        fail("serve context: the prefill's argmax is not generate's first "
             "token")
    ch_last, _ = plain.forward_prefill(p16, batch, SERVE_CACHE)
    d_prefill = _rel(k5_last, ch_last)
    del ch_last
    tok = out[:, :1]
    dl, _ = model.forward_decode(p16, cache, tok, SERVE_PROMPT)
    del cache
    if not bool(torch.isfinite(dl).all()):
        fail("serve context: non-finite decode logits")
    (full, _), _ = plain.forward_train(
        p16, {"tokens": torch.cat([batch["tokens"], tok], dim=1)})
    d_decode = _rel(dl[:, 0], full[:, -1])
    del full
    print(f"serve context: K5 prefill vs chunked prefill, last logits "
          f"differ by {d_prefill:.3e} of their max (limit {SERVE_TOL}); "
          f"decode step vs chunked full forward {d_decode:.3e} (limit "
          f"{SERVE_TOL})", flush=True)
    if not d_prefill <= SERVE_TOL:
        fail("the K5 prefill disagrees with the chunked prefill")
    if not d_decode < SERVE_TOL:
        fail("the decode step disagrees with the full forward")
    return {"prefill_vs_chunked": d_prefill, "decode_vs_full": d_decode}


def run_serve_cli():
    cmd = [sys.executable, "-m", "repro_torch.serve.decode", "--reduced",
           "--flash-attention"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(SRC)))
    print(out.stdout[-1500:], end="", flush=True)
    if out.returncode != 0 or "generated (4, 16) tokens" not in out.stdout:
        fail(f"serve CLI exited {out.returncode}: {out.stderr[-3000:]}")


def _cli(extra, rc=0):
    """``python -m repro_torch.launch.train --reduced`` + ``extra`` on the
    card; fails unless it exits with ``rc`` (a signal: negative)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           *extra]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(SRC)))
    print(out.stdout[-1500:], end="", flush=True)
    if out.returncode != rc or (rc == 0 and "run_stop" not in out.stdout):
        fail(f"CLI {extra} exited {out.returncode} (want {rc}): "
             f"{out.stderr[-3000:]}")
    return out.stdout


def run_cli():
    resnet = ["--arch", "resnet50", "--steps", "2", "--batch", "8"]
    lm = ["--arch", "qwen1.5-0.5b", "--seq", "128", "--batch", "8",
          "--steps", "3"]
    for extra in (resnet, resnet + ["--comm", "ring", "--sharding", "zero1",
                                    "--update-kernel"], lm):
        _cli(extra)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        run_cli_faults(Path(tmp))


def run_cli_faults(tmp: Path):
    """The CLI's durability flags on the reduced ZeRO-1 run: a SIGKILL and
    the resume from the last committed tag, a SIGTERM drain, a stall that
    the watchdog restores, and a corrupted checkpoint that the load falls
    back from, with the metrics JSONL and the Chrome trace."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import checkpoint as ckpt
    run = ["--arch", "resnet50", "--batch", "8", "--comm", "psum",
           "--sharding", "zero1", "--update-kernel", "--ckpt-every", "1"]
    d = str(tmp / "kill")
    _cli(run + ["--steps", "5", "--ckpt-dir", d, "--inject-fault", "kill@3"],
         rc=-9)
    if ckpt.latest_tag(d) != ckpt.step_tag(3):
        fail(f"cli kill@3: last committed tag {ckpt.latest_tag(d)}")
    out = _cli(run + ["--steps", "5", "--ckpt-dir", d, "--resume-elastic"])
    if "elastic resume: restored step 3" not in out:
        fail("cli kill@3: the rerun did not resume from step 3")
    d = str(tmp / "sigterm")
    out = _cli(run + ["--steps", "6", "--ckpt-dir", d,
                      "--inject-fault", "sigterm@3"])
    saves = [ln for ln in out.splitlines() if "checkpoint_saved" in ln]
    if "preempt_drain" not in out or "'preempted': True" not in out or \
            sum("'step': 4," in ln for ln in saves) != 1:
        fail("cli sigterm@3: no drain, or step 4 not saved exactly once")
    out = _cli(run + ["--steps", "4", "--ckpt-dir", str(tmp / "stall"),
                      "--inject-fault", "stall@2:3", "--step-timeout-s", "1"])
    if "watchdog_restore" not in out:
        fail("cli stall@2:3: no watchdog_restore")
    d, jl, tr = (str(tmp / "corrupt"), str(tmp / "m.jsonl"),
                 str(tmp / "t.json"))
    out = _cli(run + ["--steps", "2", "--ckpt-dir", d, "--inject-fault",
                      "corrupt@2", "--metrics", jl, "--trace", tr])
    mem = obs_metrics.MemorySink()
    with obs_metrics.default_registry().use_sink(mem):
        meta = ckpt.load_arrays(d)[0]
    if meta["step"] != 1 or [e.value["rejected_tag"] for e in
                             mem.find("checkpoint_fallback")] != [
                                 ckpt.step_tag(2)]:
        fail(f"cli corrupt@2: the load gave step {meta['step']}")
    tags = [ln.split(") ", 1)[1].split(":", 1)[0] for ln in out.splitlines()
            if ln.startswith(":::MLPv0.5.0 ")]
    with open(jl) as f:
        rows = [json.loads(ln)["name"] for ln in f]
    if tags != rows:
        fail(f"cli --metrics: JSONL names {rows} != stdout tags {tags}")
    spans = obs_trace.spans_from_chrome(obs_trace.load_chrome(tr))
    print(f"cli faults: kill@3 -> SIGKILL, resumed from step 3; sigterm@3 "
          f"drained and saved once; stall@2:3 restored by the watchdog; "
          f"corrupt@2 fell back to step 1; {len(rows)} tag lines in the "
          f"JSONL; {len(spans)} spans in a valid Chrome trace", flush=True)


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
    k2, k1_site = check_lars_update(dev)
    k1.update(k1_site)
    k5 = check_flash_attention(dev)
    k4, k4_bwd = check_smoothed_xent(dev)
    k3 = check_ring_add(dev)
    k1_lm, k2_lm = check_lm_shard_site(dev)
    k1.update(k1_lm)
    k2.update(k2_lm)

    # each path's launches of every kernel, read just after its run
    by_path = {}
    phase("slice")
    state0, batch_fn, by_path["slice"] = run_slice(dev)

    phase("context")
    check_in_context(dev, state0, batch_fn)
    del state0

    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh()
    try:
        phase("zero1")
        by_path["zero1"] = run_zero1(dev, mesh)

        phase("zero1 context")
        check_zero1_in_context(dev, mesh, batch_fn)

        phase("durability")
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            by_path["durability"] = run_durability(dev, mesh, batch_fn, tmp)
        # torch.use_deterministic_algorithms leaves a reference cycle
        # through the phase's frame (an import's traceback); free its states
        # before the later phases read their peak memory
        gc.collect()
    finally:
        mesh.destroy()

    phase("cli")
    run_cli()

    phase("serve")
    model, params, batch, out, by_path["serve"] = run_serve(dev)

    phase("serve context")
    k5["serve_context"] = check_serve_in_context(dev, model, params, batch,
                                                 out)
    del model, params

    phase("serve cli")
    run_serve_cli()

    phase("lm_train")
    model, state0, batch, by_path["lm_train"] = run_lm_train(dev)

    phase("lm_train context")
    k4["lm_train_context"] = check_lm_train_in_context(dev, model, state0,
                                                       batch)
    del model, state0, batch

    phase("ring, ring context")
    ring = run_ring()

    phase("lm_ring")
    torch.cuda.empty_cache()
    lm_ring = lm_resume = None
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        lm_ring = run_lm_ring(Path(tmp))
        if lm_ring is not None:
            phase("lm_ring resume")
            lm_resume = run_lm_resume(dev, Path(tmp), lm_ring)
    entries = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k4_bwd": k4_bwd,
               "k5": k5}
    # rank 0's counts, summed over the ring's configurations; null where
    # one card ran no ring
    by_path["ring"] = {key: None if ring is None else
                       sum(r["launches"][key] for r in ring["runs"])
                       for key in entries}
    # lm_ring: rank 0's counts over its configurations and autotune runs;
    # lm_resume: the one-card step from the four-card checkpoint; null
    # with fewer than four cards
    by_path["lm_ring"] = {key: None if lm_ring is None else
                          sum(r["launches"][key] for r in lm_ring["runs"])
                          + sum(t["launches"][key]
                                for t in lm_ring["autotune"].values())
                          for key in entries}
    by_path["lm_resume"] = {key: None if lm_resume is None else
                            lm_resume["launches"][key] for key in entries}
    if ring is not None:
        k3["ring"] = ring
    if lm_ring is not None:
        k3["lm_ring"] = dict(lm_ring, resume=lm_resume)
    for key, entry in entries.items():
        entry["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        entry["launches"] = sum(c[key] for c in by_path.values()
                                if c[key] is not None)

    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] in (["--ring-rank"], ["--lm-ring-rank"]):
        # a rank that fails must not wait at exit on collectives the
        # others will never join: leave at once, the launcher stops them
        try:
            if sys.argv[1] == "--ring-rank":
                ring_rank()
            else:
                lm_ring_rank(sys.argv[2])
        except SystemExit as e:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(e.code if isinstance(e.code, int) else 1)
        except BaseException:
            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
    else:
        main()
