"""The paper's central claim, reproduced at small scale: plain SGD-momentum
degrades as the batch (and linearly-scaled lr) grows; LARS + warm-up +
label smoothing holds accuracy. Prints a mini Table-I. The torch twin of
``examples/large_batch_ablation.py``; the reference's one-device mesh
``jax.make_mesh((1, 1))`` is the port's one-device ``comm='xla'`` step.

  PYTHONPATH=src python -m repro_torch.examples.large_batch_ablation \\
      [--steps 60] [--device cpu]
"""
import argparse
from types import SimpleNamespace

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
    make_schedule
from repro_torch.data.synthetic import make_batch_fn, prototype_imagenet
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.state import init_state
from repro_torch.train.step import make_eval_step, make_train_step

#: the table's batches and recipes, and the eval batch, as in the reference
BATCHES = (16, 64, 256)
RECIPES = (("sgdm (no warmup/smooth)", dict(opt="sgdm", warmup=False,
                                            smoothing=0.0)),
           ("LARS+warmup+smoothing", dict(opt="lars", warmup=True,
                                          smoothing=0.1)))
EVAL_BATCH = 64


def setup(model, device, *, batch, steps, opt, warmup, smoothing):
    """One table cell's pieces: lr, sched, opt, step and batch_fn."""
    lr = linear_scaled_lr(16.0, batch) / 4   # toy-task tuned
    sched = make_schedule(ScheduleConfig(
        base_lr=lr, warmup_steps=int(steps * 0.15) if warmup else 0,
        total_steps=steps, decay="poly2"))
    opt_cfg = lars.OptConfig(kind=opt)
    step = make_train_step(model, opt_cfg, sched, smoothing=smoothing)
    bf = make_batch_fn(model.cfg, InputShape("t", "train", 0, batch),
                       device=device)
    return SimpleNamespace(lr=lr, sched=sched, opt=opt_cfg, step=step,
                           batch_fn=bf)


def run(cfg, model, device, *, batch, steps, opt, warmup, smoothing):
    cell = setup(model, device, batch=batch, steps=steps, opt=opt,
                 warmup=warmup, smoothing=smoothing)
    s = init_state(model, 0, device=device)
    for _ in range(steps):
        s, m = cell.step(s, cell.batch_fn(s.step))
    ev = make_eval_step(model)
    accs = [float(ev(s.params, prototype_imagenet(
        cfg, batch=EVAL_BATCH, step=10_000 + k, device=device),
        s.bn_state)["acc"]) for k in range(4)]
    return float(np.mean(accs)), float(m["loss"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (the run "
                         "fails without one unless --device cpu is given)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("resnet50").reduced()
    model = build_model(cfg)

    print(f"{'batch':>6} {'recipe':>22} {'eval_acc':>9} {'loss':>7}")
    rows = []
    for batch in BATCHES:
        for name, kw in RECIPES:
            acc, loss = run(cfg, model, device, batch=batch,
                            steps=args.steps, **kw)
            rows.append((batch, name, acc, loss))
            print(f"{batch:>6} {name:>22} {acc:>9.3f} {loss:>7.3f}",
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
