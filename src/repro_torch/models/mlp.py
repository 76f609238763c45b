"""Dense FFN blocks: SwiGLU (LLaMA family) and GELU (whisper), and the
activations the LM blocks share."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import PD, copy_in, dense_pd, reduce_out


def swiglu_pd(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dp = "data" if cfg.fsdp else None
    down_scale = f ** -0.5 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_gate": dense_pd(d, f, spec=(dp, "model")),
        "w_up": dense_pd(d, f, spec=(dp, "model")),
        "w_down": dense_pd(f, d, spec=("model", dp), scale=down_scale),
    }


def silu(x):
    """x * sigmoid(x) with sigmoid as 1 / (1 + exp(-x)), one rounding to
    x's dtype after each operation: how XLA lowers ``jax.nn.silu``. In bf16
    ``torch.sigmoid`` (one rounding) differs from it in a third of the
    elements (ROADMAP §3)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh form: x · ½(1 + tanh(√(2/π) ·
    (x + 0.044715 · x³))), x³ as (x · x) · x, the constants rounded to x's
    dtype and one rounding after each operation, as XLA computes it
    (``torch.nn.functional.gelu`` defaults to the erf form)."""
    k = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype).item()
    a = torch.tensor(0.044715, dtype=x.dtype).item()
    return x * (0.5 * (1.0 + torch.tanh(k * (x + a * (x * x * x)))))


def swiglu_apply(p, x, tp=None):
    """The SwiGLU MLP; over the model axis ``tp`` the rank holds d_ff/M
    columns of ``w_gate``/``w_up`` and rows of ``w_down``, whose partial
    output is all-reduced."""
    x = copy_in(x, tp)
    return reduce_out((silu(x @ p["w_gate"]) * (x @ p["w_up"]))
                      @ p["w_down"], tp)


def gelu_mlp_pd(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dp = "data" if cfg.fsdp else None
    return {
        "w_in": dense_pd(d, f, spec=(dp, "model")),
        "b_in": PD((f,), spec=("model",), init="zeros"),
        "w_out": dense_pd(f, d, spec=("model", dp), scale=f ** -0.5
                          / math.sqrt(2 * max(cfg.n_layers, 1))),
        "b_out": PD((d,), init="zeros"),
    }


def gelu_mlp_apply(p, x, tp=None):
    """``gelu(x W_in + b_in) W_out + b_out``, each bias added in x's dtype
    after its matmul's rounding, as the JAX package adds them. Over the
    model axis ``tp`` the rank holds d_ff/M columns of ``w_in`` and
    ``b_in`` and rows of ``w_out``; the partial ``h W_out`` is all-reduced
    and the replicated ``b_out`` added once, after the sum (before it, the
    sum would add it M times), so its gradient is every rank's alike."""
    h = gelu(copy_in(x, tp) @ p["w_in"] + p["b_in"])
    return reduce_out(h @ p["w_out"], tp) + p["b_out"]
