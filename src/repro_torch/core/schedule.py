"""Learning-rate control (paper §III-A.1): gradual warm-up [Goyal et al.]
plus the decay-pattern family the paper searched over.

A transcription of ``repro.core.schedule`` in float32 torch ops, in the same
order of operations, so the two agree bit for bit (cosine: within one ulp,
``torch.cos`` and ``jnp.cos`` round differently). The rate is computed on
the CPU from the host's step counter: no device work, no sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    base_lr: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 1000
    decay: str = "poly2"          # const | step | linear | poly2 | cosine
    # step-decay knobs (He et al. style /10 at milestones)
    step_milestones: tuple = (0.5, 0.75, 0.9)
    step_factor: float = 0.1
    end_lr: float = 0.0001


def make_schedule(cfg: ScheduleConfig) -> Callable:
    """Returns lr(step) -> 0-d float32 CPU tensor."""
    if cfg.decay not in ("const", "step", "linear", "poly2", "cosine"):
        raise ValueError(cfg.decay)

    def lr(step):
        step = torch.as_tensor(step, dtype=_F32)
        warm = max(cfg.warmup_steps, 1)
        warm_lr = cfg.base_lr * (step + 1) / warm
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.decay == "const":
            dec = torch.tensor(cfg.base_lr, dtype=_F32)
        elif cfg.decay == "linear":
            dec = cfg.base_lr * (1 - t) + cfg.end_lr * t
        elif cfg.decay == "poly2":
            # the paper's best-found family: polynomial of power 2
            dec = (cfg.base_lr - cfg.end_lr) * (1 - t) ** 2 + cfg.end_lr
        elif cfg.decay == "cosine":
            dec = (cfg.end_lr + (cfg.base_lr - cfg.end_lr)
                   * 0.5 * (1 + torch.cos(math.pi * t)))
        else:   # step
            f = torch.ones((), dtype=_F32)
            for ms in cfg.step_milestones:
                f = torch.where(t >= ms, f * cfg.step_factor, f)
            dec = cfg.base_lr * f
        return torch.where(step < cfg.warmup_steps, warm_lr, dec)
    return lr


def linear_scaled_lr(base_lr_256: float, global_batch: int) -> float:
    """Goyal et al. linear scaling rule: lr = base * batch/256."""
    return base_lr_256 * global_batch / 256.0
