"""Language-model composition, dense decoder family.

Layer parameters are stacked along a leading layer axis, as in the JAX
package, so one descriptor tree and one set of weights mean the same model
in both. The JAX package scans the stack with ``lax.scan``; the port walks
it with a Python loop over views of the stacked leaves, and writes the
stacked (L, B, S, K, Dh) cache in place.

Three entry points, as the JAX package has them: ``forward_train`` (full
logits, differentiable; with ``cfg.remat`` each layer is recomputed in the
backward, as the JAX package wraps its layer scan in ``jax.checkpoint``),
``forward_prefill`` (logits of the last position + a filled cache) and
``forward_decode`` (one token against the cache).

Not ported yet (ROADMAP §1 item 10): MoE, MLA, the hybrid, xLSTM, whisper
and VLM families.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.common import PD, dense_pd, pd_stack, rms_norm
from repro_torch.tree import tree_map


def _check_dense(cfg):
    what = None
    if cfg.family != "dense":
        what = f"family {cfg.family!r}"
    elif cfg.moe is not None:
        what = "MoE"
    elif cfg.mla is not None:
        what = "MLA"
    if what:
        raise NotImplementedError(f"{what} (arch {cfg.arch_id}) "
                                  f"{attn.NOT_PORTED}")


# ---------------------------------------------------------------------------
# parameter descriptor trees


def _dense_layer_pd(cfg):
    d = cfg.d_model
    return {"ln1": PD((d,), init="ones"), "attn": attn.gqa_pd(cfg),
            "ln2": PD((d,), init="ones"), "mlp": mlpm.swiglu_pd(cfg)}


def lm_pd(cfg) -> Dict[str, Any]:
    _check_dense(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    tree: Dict[str, Any] = {"final_norm": PD((d,), init="ones"),
                            "embed": PD((V, d), scale=0.02)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_pd(d, V, scale=d ** -0.5)
    tree["layers"] = pd_stack(_dense_layer_pd(cfg), cfg.n_layers)
    return tree


def cache_pd(cfg, batch: int, max_seq: int):
    """Descriptor tree of what forward_prefill produces: stacked bf16
    (L, batch, max_seq, K, Dh) k and v."""
    _check_dense(cfg)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return pd_stack({"k": PD(shape, init="zeros", dtype=torch.bfloat16),
                     "v": PD(shape, init="zeros", dtype=torch.bfloat16)},
                    cfg.n_layers)


# ---------------------------------------------------------------------------
# shared pieces


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(torch.bfloat16)


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w.to(x.dtype)).float()


def _layer(layers, i: int):
    """Layer i's parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[i], layers)


# ---------------------------------------------------------------------------
# dense decoder


def _dense_block(p, x, positions, cfg, *, decode=False, cache=None,
                 pos=None, cache_len=0):
    """One decoder layer. Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if decode:
        a, new_cache = attn.gqa_decode(p["attn"], h, pos, cfg, cache)
    else:
        a, new_cache = attn.gqa_parallel(p["attn"], h, positions, cfg,
                                         cache_len=cache_len)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + mlpm.swiglu_apply(p["mlp"], h), new_cache


def _train_block(p, x, positions, cfg):
    return _dense_block(p, x, positions, cfg)[0]


def _dense_forward(params, cfg, x, positions, *, mode, cache=None, pos=None,
                   cache_len=0):
    """mode: train | prefill | decode. x: embedded inputs (B,S,d). Returns
    (x, cache); the decode cache is the given one, updated in place."""
    L = cfg.n_layers
    if mode == "train":
        # the stacked leaves unbound once: their backward is one stack of
        # the L layer gradients, not a zero-filled full-size gradient per
        # layer as slicing each layer out would give
        unbound = tree_map(lambda a: a.unbind(0), params["layers"])
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(L):
            p = tree_map(lambda t: t[i], unbound)
            if remat:
                # recomputed in the backward; a layer draws no random
                # numbers, so no RNG state needs keeping
                x = checkpoint(_train_block, p, x, positions, cfg,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _train_block(p, x, positions, cfg)
        return x, None
    if mode == "prefill":
        stacked = None
        for i in range(L):
            x, c = _dense_block(_layer(params["layers"], i), x, positions,
                                cfg, cache_len=cache_len)
            if stacked is None:
                stacked = {n: t.new_empty((L, *t.shape))
                           for n, t in c.items()}
            for n, t in c.items():
                stacked[n][i] = t
        return x, stacked
    for i in range(L):
        x, _ = _dense_block(_layer(params["layers"], i), x, None, cfg,
                            decode=True, cache=_layer(cache, i), pos=pos)
    return x, cache


# ---------------------------------------------------------------------------
# public entry points


def forward_train(params, cfg, batch):
    """batch: {'tokens': (B,S)}. Returns (logits (B,S,V) f32, aux 0)."""
    _check_dense(cfg)
    x = _embed(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, _ = _dense_forward(params, cfg, x, positions, mode="train")
    return _logits(params, cfg, x), torch.zeros((), device=x.device)


def forward_prefill(params, cfg, batch, cache_len: int):
    """Returns (last-position logits (B,1,V) f32, cache)."""
    _check_dense(cfg)
    x = _embed(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, cache = _dense_forward(params, cfg, x, positions, mode="prefill",
                              cache_len=cache_len)
    return _logits(params, cfg, x[:, -1:]), cache


def forward_decode(params, cfg, cache, token, pos: int):
    """token: (B,1) integers; pos: its index (Python int). Returns (logits
    (B,1,V) f32, cache); the cache is updated in place."""
    _check_dense(cfg)
    x = _embed(params, cfg, token)
    x, cache = _dense_forward(params, cfg, x, None, mode="decode",
                              cache=cache, pos=pos)
    return _logits(params, cfg, x), cache
