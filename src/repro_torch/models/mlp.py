"""Dense FFN block: SwiGLU (LLaMA family). The GELU MLP (whisper) is
ROADMAP §1 item 10."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import dense_pd


def swiglu_pd(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    down_scale = f ** -0.5 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_gate": dense_pd(d, f),
        "w_up": dense_pd(d, f),
        "w_down": dense_pd(f, d, scale=down_scale),
    }


def silu(x):
    """x * sigmoid(x) with sigmoid as 1 / (1 + exp(-x)), one rounding to
    x's dtype after each operation: how XLA lowers ``jax.nn.silu``. In bf16
    ``torch.sigmoid`` (one rounding) differs from it in a third of the
    elements (ROADMAP §3)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu_apply(p, x):
    return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
