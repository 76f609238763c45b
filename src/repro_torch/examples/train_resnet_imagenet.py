"""The paper's experiment, end to end at laptop scale: ResNet-50 (reduced)
on prototype-ImageNet with the full recipe — LARS, warm-up, tuned decay,
label smoothing, per-process BN, bucketed-overlap gradient all-reduce —
and MLPerf-style logging exactly like the paper's Appendix 1. The torch
twin of ``examples/train_resnet_imagenet.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_resnet_imagenet \\
      [--steps 200] [--device cpu]

``--comm bucketed`` (the default) and ``naive`` run the explicit
data-parallel step over every rank of the job (``launch.mesh``; one
process without ``torchrun``), each bucket's all-reduce started inside
the backward once its group's gradients exist; ``xla`` is the
single-device step. The kernel flags stay off, as in the reference.
"""
import argparse
from types import SimpleNamespace

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
    make_schedule
from repro_torch.data.synthetic import make_batch_fn, prototype_imagenet
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.registry import build_model
from repro_torch.train import loop
from repro_torch.train.state import init_state
from repro_torch.train.step import make_eval_step, make_train_step

#: the eval batch (prototype_imagenet), as in the reference
EVAL_BATCH = 128


def setup(steps: int = 200, batch: int = 64, comm: str = "bucketed",
          device=None):
    """The run's pieces: cfg, mesh (None for 'xla'), model, lr, sched, opt,
    train_step, eval_step, batch_fn, eval_batch_fn, eval_every and the
    initial state."""
    dev = resolve_device(device)
    cfg = get_config("resnet50").reduced()
    # the port's 'xla' step is the one-device step: it takes no mesh
    mesh = make_local_mesh(device=device) if comm != "xla" else None
    if mesh is not None:
        dev = mesh.device
    model = build_model(cfg)

    lr = linear_scaled_lr(16.0, batch) / 4   # toy-task tuned
    sched = make_schedule(ScheduleConfig(
        base_lr=lr, warmup_steps=steps // 8, total_steps=steps,
        decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5)
    train_step = make_train_step(model, opt, sched, smoothing=0.1,
                                 mesh=mesh, comm=comm, bucket_mb=4.0)
    eval_step = make_eval_step(model)
    batch_fn = make_batch_fn(cfg, InputShape("in", "train", 0, batch),
                             device=dev, mesh=mesh)

    def eval_batch_fn(step):
        return prototype_imagenet(cfg, batch=EVAL_BATCH, step=step,
                                  device=dev)

    state = init_state(model, seed=100000, device=dev)   # paper's seed tag
    return SimpleNamespace(
        cfg=cfg, mesh=mesh, device=dev, model=model, lr=lr, sched=sched,
        opt=opt, train_step=train_step, eval_step=eval_step,
        batch_fn=batch_fn, eval_batch_fn=eval_batch_fn,
        eval_every=max(steps // 4, 1), state=state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--comm", default="bucketed",
                    choices=["bucketed", "naive", "xla"])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (the run "
                         "fails without one unless --device cpu is given)")
    args = ap.parse_args(argv)

    run = setup(args.steps, args.batch, args.comm, args.device)
    try:
        state, history = loop.train(
            run.state, run.train_step, run.batch_fn, steps=args.steps,
            eval_step=run.eval_step, eval_batch_fn=run.eval_batch_fn,
            eval_every=run.eval_every, log_every=20)
    finally:
        if run.mesh is not None:
            run.mesh.destroy()
    evals = [h for h in history if "eval_acc" in h]
    if evals:
        print(f"\nfinal eval accuracy: {evals[-1]['eval_acc']:.3f} "
              f"(paper, full scale: 0.75082)")
    return history


if __name__ == "__main__":
    main()
