"""Model registry: the uniform functional API over architecture families.

The port builds the conv family (ResNet-50) so far; the LM families are
ROADMAP §1 item 10.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import cast_to_compute
from repro_torch.models import resnet as rn


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_pd: Any                      # descriptor tree
    bn_state_pd: Any = None            # resnet only
    train_fn: Callable = None

    def forward_train(self, params, batch, bn_state=None):
        return self.train_fn(params, batch, bn_state)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "conv":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the LM families are "
            f"ROADMAP §1 item 10")
    params_pd, state_pd = rn.resnet_pd(cfg)

    def train_fn(params, batch, bn_state):
        logits, new_state = rn.resnet_forward(
            cast_to_compute(params), bn_state, cfg, batch["images"],
            train=True)
        return (logits, torch.zeros((), device=logits.device)), new_state

    return Model(cfg=cfg, param_pd=params_pd, bn_state_pd=state_pd,
                 train_fn=train_fn)
