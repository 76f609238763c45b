"""Model registry: the uniform functional API over architecture families.

The port builds the conv family (ResNet-50: training) and the dense LM
family (GQA decoder: training, prefill and one-token decode). The other LM
families (MoE, MLA, hybrid, xLSTM, whisper, VLM) raise
``NotImplementedError``: ROADMAP §1 item 10.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import cast_to_compute
from repro_torch.models import resnet as rn
from repro_torch.models import transformer as tf


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_pd: Any                      # descriptor tree
    bn_state_pd: Any = None            # resnet only
    train_fn: Callable = None
    prefill_fn: Callable = None        # LM only, as are the two below
    decode_fn: Callable = None
    cache_pd_fn: Callable = None

    def forward_train(self, params, batch, bn_state=None):
        return self.train_fn(params, batch, bn_state)

    def forward_prefill(self, params, batch, cache_len):
        return self.prefill_fn(params, batch, cache_len)

    def forward_decode(self, params, cache, token, pos):
        return self.decode_fn(params, cache, token, pos)

    def cache_pd(self, batch: int, max_seq: int):
        return self.cache_pd_fn(batch, max_seq)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "conv":
        params_pd, state_pd = rn.resnet_pd(cfg)

        def train_fn(params, batch, bn_state):
            logits, new_state = rn.resnet_forward(
                cast_to_compute(params), bn_state, cfg, batch["images"],
                train=True)
            return (logits, torch.zeros((), device=logits.device)), \
                new_state

        return Model(cfg=cfg, param_pd=params_pd, bn_state_pd=state_pd,
                     train_fn=train_fn)

    pd = tf.lm_pd(cfg)   # raises for the families not ported yet

    # Each call casts the f32 masters to bf16, as the JAX package's do;
    # leaves already in bf16 pass through, so a caller that casts once
    # (serve.decode.generate) pays the cast once.
    def train_fn(params, batch, bn_state=None):
        logits, aux = tf.forward_train(cast_to_compute(params), cfg, batch)
        return (logits, aux), None

    def prefill_fn(params, batch, cache_len):
        return tf.forward_prefill(cast_to_compute(params), cfg, batch,
                                  cache_len)

    def decode_fn(params, cache, token, pos):
        return tf.forward_decode(cast_to_compute(params), cfg, cache, token,
                                 pos)

    def cache_pd_fn(batch, max_seq):
        return tf.cache_pd(cfg, batch, max_seq)

    return Model(cfg=cfg, param_pd=pd, train_fn=train_fn,
                 prefill_fn=prefill_fn, decode_fn=decode_fn,
                 cache_pd_fn=cache_pd_fn)
