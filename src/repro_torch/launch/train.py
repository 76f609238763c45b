"""Training launcher of the port (the flags of ``repro.launch.train`` that
this slice covers, plus ``--device``).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
      --reduced --batch 8 --steps 2            # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \\
      --reduced --batch 8 --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --seq 128 --batch 8 --steps 3 --device cpu   # LM, lcg tokens
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch resnet50 --reduced --batch 8 --steps 2 --comm ring \\
      --sharding zero1 --device cpu        # ZeRO-1 on two gloo ranks

An explicit schedule (``--comm naive|psum|bucketed|ring|hierarchical|
2d_torus|dbtree``) runs over the ``(data, model=1)`` mesh of every rank of
the job (``launch.mesh``: NCCL on the card, gloo on the CPU; one process
without ``torchrun``); ``--sharding zero1|zero2|zero3`` picks the rung.
As in the reference, there is no flag for the ``(pod, data)`` mesh.

The reference's flags for parts not ported yet are accepted by name and
exit with the ROADMAP item that will bring them.
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
from repro_torch.models.registry import build_model
from repro_torch.train import loop
from repro_torch.train.state import init_state, sharded_state_kwargs
from repro_torch.train.step import make_eval_step, make_train_step

#: the explicit-DP schedules, as the reference's CLI offers them
SCHEDULES = ("naive", "bucketed", "psum", "ring", "hierarchical",
             "2d_torus", "dbtree")

#: reference flag -> ROADMAP §1 item that ports it
_NOT_PORTED = {
    "--model-parallel": 6, "--backward-profile": 7,
    "--shard-update": 7, "--no-gather-ahead": 7,
    "--ckpt-dir": 8, "--ckpt-every": 8, "--resume-elastic": 8,
    "--keep-last-k": 8, "--step-timeout-s": 8, "--max-step-retries": 8,
    "--inject-fault": 8, "--guard": 8, "--rollback-ring": 8,
    "--rollback-every": 8, "--rewarmup-steps": 8, "--trace": 8,
    "--metrics": 8,
}


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
                    help="'xla': the replicated single-device step; else "
                         "an explicit-DP schedule over every rank")
    ap.add_argument("--bucket-mb", default=4.0, type=float,
                    help="bucket size in MB ('auto', the autotuner, is "
                         "ROADMAP §1 item 7)")
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
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported to repro_torch yet "
                     f"(ROADMAP §1 item {item})")
    if args.sharding in ("zero1", "zero2", "zero3") \
            and args.comm in ("xla", "naive"):
        ap.error(f"--sharding {args.sharding} needs an explicit-DP schedule "
                 f"(--comm {{bucketed,psum,ring,hierarchical,2d_torus,"
                 f"dbtree}}), not {args.comm!r}")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.comm == "xla" and world > 1:
        ap.error(f"--comm xla is the single-device step: under a "
                 f"{world}-rank launch every rank would train its own "
                 f"unsynchronised replica. Use an explicit schedule such as "
                 f"--comm psum; the reference's GSPMD --comm xla over every "
                 f"rank comes with the model axis (ROADMAP §1 item 6)")
    if args.grad_accum > 1 and args.comm != "xla":
        ap.error(f"--grad-accum {args.grad_accum} is a --comm xla option: "
                 f"the explicit schedules do not accumulate. The reference's "
                 f"explicit path never reads grad_accum and silently trains "
                 f"at the full per-rank batch; the port refuses instead")
    return _run(args)


def _run(args):
    mesh = None
    if args.comm != "xla":
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(device=args.device)
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            mesh.destroy()


def _train(args, mesh):
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
    batch_fn = make_batch_fn(cfg, shape, seed=args.seed, kind=args.data,
                             device=device, mesh=mesh)
    comm = CommConfig(strategy=args.comm, bucket_mb=args.bucket_mb,
                      overlap=not args.no_overlap,
                      update_kernel=args.update_kernel,
                      sharding=args.sharding, gather=args.gather)
    train_step = make_train_step(model, opt, sched, smoothing=args.smoothing,
                                 mesh=mesh, comm=comm,
                                 grad_accum=args.grad_accum)
    eval_step = make_eval_step(model) if args.eval_every else None
    state = init_state(model, args.seed, device=device,
                       opt_kind=args.optimizer,
                       **sharded_state_kwargs(train_step))
    state, history = loop.train(
        state, train_step, batch_fn, steps=args.steps, eval_step=eval_step,
        eval_batch_fn=batch_fn, eval_every=args.eval_every, seed=args.seed)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
