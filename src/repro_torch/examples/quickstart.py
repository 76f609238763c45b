"""Quickstart: train a tiny LM with the paper's full recipe (LARS + warm-up
+ poly decay + label smoothing + bf16 compute / fp32 masters) on synthetic
data. The torch twin of ``examples/quickstart.py``: the reduced
qwen1.5-0.5b, the one-device step, its loss's per-row NLL through the
smoothed cross-entropy kernel (K4, forward and backward) on the card.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
from types import SimpleNamespace

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train import loop
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step

#: the run's length, as in the reference
STEPS = 60


def setup(device=None):
    """The run's pieces: cfg, model, sched, opt, train_step, batch_fn and
    the initial state. The reference's ``make_local_mesh()`` with its
    default ``comm='xla'`` is the port's one-device step (no mesh)."""
    dev = resolve_device(device)
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=2.0, warmup_steps=6,
                                         total_steps=STEPS, decay="poly2"))
    opt = lars.OptConfig(kind="lars")
    train_step = make_train_step(model, opt, sched, smoothing=0.1)
    batch_fn = make_batch_fn(cfg, InputShape("quick", "train", 64, 8),
                             device=dev)
    state = init_state(model, seed=0, device=dev)
    return SimpleNamespace(cfg=cfg, device=dev, model=model, sched=sched,
                           opt=opt, train_step=train_step,
                           batch_fn=batch_fn, state=state)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (the run "
                         "fails without one unless --device cpu is given)")
    args = ap.parse_args(argv)
    run = setup(args.device)
    state, history = loop.train(run.state, run.train_step, run.batch_fn,
                                steps=STEPS, log_every=10)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK: learning' if last < first else 'NOT learning?'})")
    return history


if __name__ == "__main__":
    main()
