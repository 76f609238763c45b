"""Training launcher of the port (the flags of ``repro.launch.train`` that
this slice covers, plus ``--device``).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
      --reduced --batch 8 --steps 2            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
      --reduced --batch 8 --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --seq 128 --batch 8 --steps 3 --device cpu   # LM, lcg tokens
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
      --reduced --seq 32 --batch 4 --steps 2 --device cpu  # + stub frames
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch resnet50 --reduced --batch 8 --steps 2 --comm ring \\
      --sharding zero1 --device cpu        # ZeRO-1 on two gloo ranks
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen1.5-0.5b --reduced --model-parallel 2 --comm xla \\
      --device cpu             # the (data 2, model 2) mesh on gloo
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
      --reduced --batch 8 --steps 6 --device cpu --comm psum \\
      --sharding zero1 --ckpt-dir /tmp/ck --ckpt-every 1 --guard \\
      --inject-fault nan@2 --metrics m.jsonl --trace t.json
  PYTHONPATH=src python -m repro_torch.launch.train ... --ckpt-dir /tmp/ck \\
      --resume-elastic                     # resume from the newest tag

An explicit schedule (``--comm naive|psum|bucketed|ring|hierarchical|
2d_torus|dbtree``) runs over the ``(data, model=1)`` mesh of every rank of
the job (``launch.mesh``: NCCL on the card, gloo on the CPU; one process
without ``torchrun``); ``--sharding zero1|zero2|zero3`` picks the rung.
Every ``--arch`` takes it but the MoE ones (qwen2-moe-a2.7b,
deepseek-v2-236b), which it refuses: the reference's explicit step runs
the model without a mesh, and its MoE layer runs only over one, so there
is no such step to port. As in the
reference, there is no flag for the ``(pod, data)`` mesh. ``--comm xla``
(the default) is the reference's GSPMD step: on one process the
single-device step, under a multi-rank launch the ``(data=world/M,
model=M)`` mesh of ``--model-parallel M`` (ROADMAP §1 items 6.2, 6.2b,
6.2c and 6.3's experts and MLA: the leaves of the dense decoder, the MoE
decoder's (its experts split, each rank routing its own tokens; MLA's
heads split, its latent whole on every rank), the
hybrid, the xLSTM, whisper and the VLM split over ``model``, LAMB and
``--guard`` over it too; ResNet-50 splits none and takes its BatchNorm
statistics over the data axes; at M = 1 pure data parallelism), each
rank on the rows of its data index. ``--ckpt-dir`` saves the reference's whole arrays there too
(the split leaves gathered), and ``--resume-elastic`` resumes them onto
this launch's ``(data, model)`` shape, which may differ from the saving
run's in M and in the data size, as the reference's global arrays do. An
explicit schedule treats every axis of that mesh as data parallel, as the
reference's does. ``make_train_step`` refuses what the model axis does
not split: MLA's and the xLSTM's heads that M does not divide (items
6.3c, 6.2d), ``fsdp`` over more than one data rank (item 6.3) and a leaf
that M does not divide, which the reference cannot place either
(whisper-base's and internvl2-2b's published vocabularies over model >
1, say); with a MoE
config the CLI and the forward refuse a ``--seq`` that M does not
divide, which the reference cannot shard either. On four cards:
  python -m torch.distributed.run --nproc-per-node 4 -m \
      repro_torch.launch.train --arch whisper-base --comm ring \
      --sharding zero1 --steps 3

Durability and observability (the reference's flags and defaults):
checkpoints (``--ckpt-dir``, ``--ckpt-every``, ``--keep-last-k``),
``--resume-elastic`` (the saved CommPlan drives the packing layout; n→m
shards), the step watchdog (``--step-timeout-s``, ``--max-step-retries``),
``--inject-fault``, the numerical guard (``--guard``, ``--rollback-ring``,
``--rollback-every``, ``--rewarmup-steps``), ``--trace`` (Chrome JSON) and
``--metrics`` (JSONL mirror of the tag stream). After ``--trace`` the
traced bucket comm spans are scored against the CommPlan's predicted
timeline (``obs.drift``: ``obs.drift.span`` rows and the
``obs.drift.<schedule>.rel_err`` gauge, or ``obs.drift.no_spans``).

``--bucket-mb auto`` sizes the buckets with the autotuner
(``comm.autotune``, the card's constants of ``launch/hw.py``);
``--backward-profile measured`` feeds it one profiled warm-up backward
instead of the FLOPs model. The deprecated ``--shard-update`` and
``--no-gather-ahead`` map onto ``--sharding zero1`` and ``--gather
at_end``, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
    make_schedule
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.common import dp_axes
from repro_torch.models.moe import uneven_tokens
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train.faults import FaultInjector, FaultSpecError, \
    parse_faults
from repro_torch.train.guard import GuardConfig
from repro_torch.train.state import init_state, sharded_state_kwargs
from repro_torch.train.step import explicit_moe, make_eval_step, \
    make_train_step

#: the explicit-DP schedules, as the reference's CLI offers them
SCHEDULES = ("naive", "bucketed", "psum", "ring", "hierarchical",
             "2d_torus", "dbtree")

WHERE = "repro_torch/launch/train.py"


def _bucket_mb(v: str):
    """``--bucket-mb``: a size in MB or ``auto``."""
    return v if v == "auto" else float(v)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized variant of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", default="lcg", choices=["lcg", "uniform"],
                    help="LM token distribution (data/synthetic.token_batch)")
    ap.add_argument("--optimizer", default="lars",
                    choices=["lars", "sgdm", "lamb"])
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches a step; --comm xla only")
    ap.add_argument("--comm", default="xla", choices=["xla", *SCHEDULES],
                    help="'xla': the GSPMD step (one device, or the "
                         "(data, model) mesh of every rank); else an "
                         "explicit-DP schedule over every rank")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="M",
                    help="the mesh's model axis: (data=world/M, model=M)")
    ap.add_argument("--bucket-mb", default=4.0, type=_bucket_mb,
                    help="bucket size in MB, or 'auto' (the autotuner)")
    ap.add_argument("--backward-profile", default="model",
                    choices=["model", "measured"],
                    help="the autotuner's backward-time model: the FLOPs "
                         "model, or one profiled warm-up backward "
                         "(with --bucket-mb auto)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="post-backward collectives instead of issuing "
                         "each bucket's collective inside the backward")
    ap.add_argument("--sharding", default=None,
                    choices=["replicated", "zero1", "zero2", "zero3"],
                    help="'zero1' reduce-scatters the grads, updates this "
                         "rank's fp32 master shards and all-gathers the "
                         "params; 'zero2' keeps the replicated params as "
                         "masters (fp32 step-end gather); 'zero3' keeps "
                         "none and gathers each bucket group in the "
                         "forward")
    ap.add_argument("--gather", default=None,
                    choices=["ahead", "at_end", "per_group"],
                    help="zero1: at the start of the next step ('ahead', "
                         "default) or at the end of this one; zero3: "
                         "gather again in the backward ('per_group', "
                         "default) or keep the forward's ('ahead')")
    ap.add_argument("--update-kernel", action="store_true",
                    help="fused LARS update kernel on the zero1 shards")
    ap.add_argument("--shard-update", action="store_true",
                    help="DEPRECATED: use --sharding zero1")
    ap.add_argument("--no-gather-ahead", action="store_true",
                    help="DEPRECATED: use --gather at_end")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: linear-scaling rule from batch size")
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--decay", default="poly2")
    ap.add_argument("--smoothing", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=5e-5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (the run "
                         "fails without one unless --device cpu is given)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume-elastic", action="store_true",
                    help="resume from --ckpt-dir onto THIS mesh, resharding "
                         "the ZeRO masters/momentum n->m if the rank count "
                         "changed; the saved CommPlan drives the packing "
                         "layout")
    ap.add_argument("--keep-last-k", type=int, default=0, metavar="K",
                    help="retention: prune step-tagged checkpoints beyond "
                         "the newest K (0 = keep everything)")
    ap.add_argument("--step-timeout-s", type=float, default=0.0,
                    help="step watchdog budget: a step exceeding this is "
                         "abandoned, the last good checkpoint restored, "
                         "and the step retried with backoff (0 = off; each "
                         "step then runs on a copy of the state)")
    ap.add_argument("--max-step-retries", type=int, default=3)
    ap.add_argument("--inject-fault", default=None, metavar="SPEC",
                    help="fault injection (train/faults.py): comma-separated "
                         "kind@step[:arg] — e.g. kill@7, sigterm@5, "
                         "stall@3:2.5, corrupt@4:manifest, nan@3, spike@6:50")
    ap.add_argument("--guard", action="store_true",
                    help="numerical-integrity guard (train/guard.py): NaN "
                         "sentinel with skip-update, divergence detector, "
                         "in-memory rollback ring escalating to checkpoint "
                         "restore")
    ap.add_argument("--rollback-ring", type=int, default=2, metavar="N",
                    help="guard rollback ring capacity: N snapshots of the "
                         "state (device copies; 0 = skip straight to "
                         "checkpoint restore)")
    ap.add_argument("--rollback-every", type=int, default=1, metavar="K",
                    help="guard snapshot cadence in steps")
    ap.add_argument("--rewarmup-steps", type=int, default=0, metavar="R",
                    help="LR re-warmup window after a guard recovery, "
                         "composed with the run schedule (0 = off, the "
                         "trajectory-preserving setting)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="attach the step-timeline tracer and write a "
                         "Chrome-trace JSON (chrome://tracing / Perfetto) "
                         "at exit, and score the traced bucket comm spans "
                         "against the CommPlan's prediction (obs.drift)")
    ap.add_argument("--metrics", default=None, metavar="OUT.jsonl",
                    help="mirror every metrics event (the MLPerf tag "
                         "stream + obs.* rows) to a JSONL file")
    args = ap.parse_args(argv)
    # the deprecated boolean flags: noted and mapped onto the policy enum,
    # as the reference does; the notes go out once the sinks are attached
    args.notes = []
    if args.shard_update:
        args.notes.append(("launch_deprecated", "--shard-update is "
                           "deprecated; use --sharding zero1"))
        if args.sharding is None:
            args.sharding = "zero1"
        elif args.sharding == "replicated":
            ap.error("--shard-update conflicts with --sharding replicated "
                     "— drop the deprecated flag")
    if args.no_gather_ahead:
        args.notes.append(("launch_deprecated", "--no-gather-ahead is "
                           "deprecated; use --gather at_end"))
        if args.gather is None:
            args.gather = "at_end"
        elif args.gather == "ahead":
            ap.error("--no-gather-ahead conflicts with --gather ahead — "
                     "drop the deprecated flag")
    if args.backward_profile == "measured" and args.bucket_mb != "auto":
        args.notes.append(("launch_note", "--backward-profile measured only "
                           "affects the bucket autotuner; add --bucket-mb "
                           "auto or the profile is unused"))
    if args.sharding in ("zero1", "zero2", "zero3") \
            and args.comm in ("xla", "naive"):
        ap.error(f"--sharding {args.sharding} needs an explicit-DP schedule "
                 f"(--comm {{bucketed,psum,ring,hierarchical,2d_torus,"
                 f"dbtree}}), not {args.comm!r}")
    world = int(os.environ.get("WORLD_SIZE", 1))
    m = args.model_parallel
    arch = get_config(args.arch)
    if m < 1 or world % m:
        ap.error(f"--model-parallel {m} does not divide the job's {world} "
                 f"rank(s)")
    if args.comm != "xla" and arch.moe is not None:
        ap.error(str(explicit_moe(f"--comm {args.comm}", args.arch)))
    if arch.moe is not None and args.seq >= m and args.seq % m:
        ap.error(str(uneven_tokens(f"--seq {args.seq} with {args.arch}",
                                   args.seq, m)))
    if args.grad_accum > 1 and args.comm != "xla":
        ap.error(f"--grad-accum {args.grad_accum} is a --comm xla option: "
                 f"the explicit schedules do not accumulate. The reference's "
                 f"explicit path never reads grad_accum and silently trains "
                 f"at the full per-rank batch; the port refuses instead")
    if args.resume_elastic and not args.ckpt_dir:
        ap.error("--resume-elastic needs --ckpt-dir")
    try:
        faults = parse_faults(args.inject_fault)
    except FaultSpecError as e:
        ap.error(str(e))
    if any(f.kind == "spike" for f in faults) and not args.guard:
        ap.error("spike@s:mag rides in through the guarded step's "
                 "loss_scale input — add --guard")
    return _run(args)


def _run(args):
    reg = obs_metrics.default_registry()
    sink = (reg.add_sink(obs_metrics.JsonlSink(args.metrics))
            if args.metrics else None)
    for name, note in getattr(args, "notes", ()):
        reg.event(name, note, where=WHERE)
    saved_plan = None
    if args.resume_elastic:
        try:
            saved_plan = ckpt.load_comm_plan(args.ckpt_dir)
        except ckpt.CheckpointError:
            saved_plan = None        # a replicated run: plain restore
    mesh = None
    try:
        schedule = saved_plan.schedule if saved_plan is not None \
            else args.comm
        m = getattr(args, "model_parallel", 1)
        if schedule != "xla" or m > 1 \
                or int(os.environ.get("WORLD_SIZE", 1)) > 1:
            from repro_torch.launch.mesh import make_local_mesh
            mesh = make_local_mesh(m, device=args.device)
        return _train(args, mesh, reg, saved_plan)
    finally:
        if mesh is not None:
            mesh.destroy()
        if sink is not None:
            reg.remove_sink(sink)


def _train(args, mesh, reg, saved_plan):
    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    lr = args.lr if args.lr is not None else linear_scaled_lr(0.1, args.batch)
    warmup = args.warmup if args.warmup is not None else args.steps // 10
    sched = make_schedule(ScheduleConfig(
        base_lr=lr, warmup_steps=warmup, total_steps=args.steps,
        decay=args.decay))
    opt = lars.OptConfig(kind=args.optimizer, momentum=args.momentum,
                         weight_decay=args.weight_decay)
    shape = InputShape("cli", "train", args.seq, args.batch)
    # the GSPMD step's batch lies over the data axes, an explicit step's
    # over every axis
    xla = (saved_plan.schedule if saved_plan is not None
           else args.comm) == "xla"
    batch_fn = make_batch_fn(
        cfg, shape, seed=args.seed, kind=args.data, device=device,
        mesh=mesh, axes=dp_axes(mesh) if xla and mesh is not None else None)
    comm = CommConfig(strategy=args.comm, bucket_mb=args.bucket_mb,
                      overlap=not args.no_overlap,
                      update_kernel=args.update_kernel,
                      backward_profile=args.backward_profile,
                      sharding=args.sharding, gather=args.gather)
    if saved_plan is not None:
        # the committed plan wins over the CLI's comm flags: the resumed
        # run keeps the checkpoint's packing semantics
        comm = saved_plan.comm_config(reautotune=True)
        reg.event(
            "elastic_resume_plan",
            f"resuming elastically from {args.ckpt_dir}: CommPlan "
            f"schedule={saved_plan.schedule} "
            f"bucket={saved_plan.bucket_mb:g}MB "
            f"(requested {saved_plan.requested_bucket_mb!r}), saved on mesh "
            f"{dict(zip(saved_plan.mesh_axes, saved_plan.mesh_sizes))} "
            f"with n_shards={saved_plan.n_shards}", where=WHERE)
    guard_cfg = None
    if args.guard:
        guard_cfg = GuardConfig(ring_capacity=args.rollback_ring,
                                snapshot_every=max(args.rollback_every, 1),
                                rewarmup_steps=args.rewarmup_steps)
        reg.event("guard_armed",
                  f"numerical guard on: ring={args.rollback_ring} "
                  f"snapshots every {max(args.rollback_every, 1)} step(s), "
                  f"rewarmup={args.rewarmup_steps}", where=WHERE)
    tracer = obs_trace.Tracer() if args.trace else None
    train_step = make_train_step(
        model, opt, sched, smoothing=args.smoothing, mesh=mesh, comm=comm,
        grad_accum=args.grad_accum,
        profile_batch=(batch_fn(0) if comm.backward_profile == "measured"
                       else None),
        tracer=tracer, guard=args.guard, donate=xla)
    if getattr(train_step, "tuned", None) is not None:
        t = train_step.tuned
        reg.event("autotune_plan",
                  f"autotuned bucket plan: {t.bucket_mb:g}MB x "
                  f"{t.n_buckets} buckets ({t.sim.mode}), predicted overlap "
                  f"eff {t.sim.overlap_eff:.2f}", where=WHERE)
    eval_step = (make_eval_step(model, mesh=mesh if xla else None)
                 if args.eval_every else None)
    state = init_state(model, args.seed, device=device,
                       opt_kind=args.optimizer,
                       **sharded_state_kwargs(train_step))
    if args.resume_elastic:
        from repro_torch.train import elastic
        new_n = getattr(train_step, "n_shards", 1) \
            if train_step.sharding != "replicated" else 1
        state = elastic.load_resharded(
            args.ckpt_dir, state, getattr(train_step, "bucket_plan", None),
            new_n, old_comm_plan=saved_plan, mesh=mesh,
            param_pd=getattr(train_step, "param_pd", None))
        old_n = saved_plan.n_shards if saved_plan is not None else 1
        reg.event("elastic_resume",
                  f"elastic resume: restored step {int(state.step)}, "
                  f"resharded {old_n} -> {new_n} shards", where=WHERE)
    state, history = loop.train(
        state, train_step, batch_fn, steps=args.steps, eval_step=eval_step,
        eval_batch_fn=batch_fn, eval_every=args.eval_every, seed=args.seed,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        keep_last_k=args.keep_last_k, step_timeout_s=args.step_timeout_s,
        max_step_retries=args.max_step_retries,
        comm_plan=getattr(train_step, "comm_plan", None),
        faults=FaultInjector(parse_faults(args.inject_fault)),
        tracer=tracer, guard=guard_cfg)
    if tracer is not None:
        path = obs_trace.export_chrome(tracer, args.trace)
        reg.event("trace_written",
                  {"path": path, "steps": len(tracer.steps),
                   "spans": len(tracer.spans())}, where=WHERE)
        comm_plan = getattr(train_step, "comm_plan", None)
        if comm_plan is not None:
            from repro_torch.obs import drift as obs_drift
            drifts = obs_drift.compute(tracer, comm_plan)
            if drifts:
                obs_drift.emit(drifts, comm_plan, registry=reg)
            else:
                reg.event("obs.drift.no_spans",
                          {"schedule": comm_plan.schedule,
                           "note": "no traced bucket comm spans to score "
                                   "(xla path, or zero completed steps)"},
                          where=WHERE)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
