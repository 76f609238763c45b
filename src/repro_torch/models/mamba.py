"""Mamba2 block (a port of ``repro.models.mamba``): the chunked SSD
parallel form for training and prefill, the recurrent state update for
decode.

The parallel form follows the SSD "chunked" algorithm (Dao & Gu, 2024): an
intra-chunk quadratic term and a recurrent scan of the state over chunk
boundaries, every decay computed in log space and bounded by 1. The JAX
package scans the chunk boundaries with ``lax.scan``; the port walks them
with a Python loop, and writes each product of three operands as two, so
that no (chunk, chunk, state, head dim) intermediate is made. Decode
updates the cache's state and conv windows IN PLACE (the JAX package
returns an updated copy), so a served model's cache keeps its storage.

Over a model axis ``tp`` (ROADMAP §1 item 6.2b) the leaves split as the
reference's specs split them: the SSM heads (``in_x``, ``in_z``,
``in_dt``, ``dt_bias``, ``A_log``, ``D``, ``conv_x``, ``norm`` by their
d_inner or head dim; ``out`` by its rows) and each rank runs its own
heads, while ``in_B``, ``in_C``, ``conv_B`` and ``conv_C`` are whole on
every rank and their outputs enter the heads through ``copy_in``. The
gated RMSNorm over d_inner sums the rank's squares over the axis first;
``out``'s partial products end in ``reduce_out``. The caches' ``conv_x``
and ``state`` hold the rank's heads.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _fit
from repro_torch.models.common import PD, copy_in, dense_pd, reduce_out, \
    rms_norm, softplus
from repro_torch.models.mlp import silu


def _dims(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return di, nh, s.head_dim, s.d_state


def mamba_pd(cfg):
    d = cfg.d_model
    di, nh, hd, ds = _dims(cfg)
    s = cfg.ssm
    dp = "data" if cfg.fsdp else None
    return {
        "in_x": dense_pd(d, di, spec=(dp, "model")),
        "in_z": dense_pd(d, di, spec=(dp, "model")),
        "in_B": dense_pd(d, ds, spec=(dp, None)),
        "in_C": dense_pd(d, ds, spec=(dp, None)),
        "in_dt": dense_pd(d, nh, spec=(dp, "model")),
        "dt_bias": PD((nh,), spec=("model",), init="zeros"),
        "A_log": PD((nh,), spec=("model",), init="ones"),
        "D": PD((nh,), spec=("model",), init="ones"),
        "conv_x": PD((s.d_conv, di), spec=(None, "model"), scale=0.1),
        "conv_B": PD((s.d_conv, ds), scale=0.1),
        "conv_C": PD((s.d_conv, ds), scale=0.1),
        "norm": PD((di,), spec=("model",), init="ones"),
        "out": dense_pd(di, d, spec=("model", dp),
                        scale=di ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B,S,C); w: (W,C). The JAX package's
    Python sum of W products in x's dtype: each product and each partial
    sum rounded, in its order."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _local(p, cfg):
    """(d_inner, SSM heads) of the leaves ``p``: a rank's share over a
    model axis, the whole without one."""
    nh = p["A_log"].shape[-1]
    return nh * cfg.ssm.head_dim, nh


def mamba_parallel(p, x, cfg, *, return_cache: bool = False, tp=None):
    """x: (B,S,d) -> ((B,S,d), cache | None). A length that is not a
    multiple of ``cfg.ssm.chunk`` takes, with ``return_cache``, the largest
    chunk that divides it (exact: padding would decay the state on fake
    steps); without, zero padding at the end. The cache holds the last
    W - 1 raw inputs of each conv and the final state (B,nh,hd,ds) f32.
    ``tp``: the model axis (the module's docstring)."""
    _, _, hd, ds = _dims(cfg)
    di, nh = _local(p, cfg)
    cl = cfg.ssm.chunk
    B, S, _ = x.shape
    if S % cl:
        if return_cache:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, chunk=_fit(S, cl)))
            return mamba_parallel(p, x, cfg, return_cache=True, tp=tp)
        out, _ = mamba_parallel(p, F.pad(x, (0, 0, 0, (-S) % cl)), cfg,
                                tp=tp)
        return out[:, :S], None
    nc = S // cl

    xc = copy_in(x, tp)                  # the head-split projections' input
    xr, br, cr = xc @ p["in_x"], x @ p["in_B"], x @ p["in_C"]
    xin = silu(_causal_conv(xr, p["conv_x"]))
    Bm = copy_in(silu(_causal_conv(br, p["conv_B"])), tp)
    Cm = copy_in(silu(_causal_conv(cr, p["conv_C"])), tp)
    z = xc @ p["in_z"]
    dt = softplus(xc @ p["in_dt"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())                    # (nh,) negative

    xh = xin.reshape(B, nc, cl, nh, hd).float()
    Bc = Bm.reshape(B, nc, cl, ds).float()
    Cc = Cm.reshape(B, nc, cl, ds).float()
    dtc = dt.reshape(B, nc, cl, nh)
    seg = torch.cumsum(dtc * A, dim=2)                    # within-chunk

    # intra-chunk (quadratic within cl):
    # Y[i] += sum_{j<=i} C_i·B_j * exp(seg_i - seg_j) * dt_j * x_j
    CB = torch.einsum("bcis,bcjs->bcij", Cc, Bc)
    # clamp before exp: masked (i<j) entries would otherwise overflow
    decay = torch.exp(torch.clamp_max(
        seg[:, :, :, None, :] - seg[:, :, None, :, :], 0.0))
    mask = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    M = torch.where(mask[None, None, :, :, None],
                    CB[..., None] * decay * dtc[:, :, None, :, :], 0.0)
    y_intra = torch.einsum("bcijn,bcjnp->bcinp", M, xh)

    # chunk-final states (B,nc,nh,hd,ds)
    state_decay = torch.exp(seg[:, :, -1:, :] - seg)      # (B,nc,cl,nh)
    states = torch.einsum("bcjs,bcjnp->bcnps", Bc,
                          (state_decay * dtc)[..., None] * xh)

    # inter-chunk recurrence over chunk boundaries
    chunk_decay = torch.exp(seg[:, :, -1, :])             # (B,nc,nh)
    h = xh.new_zeros((B, nh, hd, ds))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # (B,nc,nh,hd,ds)

    y_inter = torch.einsum("bcis,bcnps->bcinp", Cc, h_prev) \
        * torch.exp(seg)[..., None]
    y = y_intra + y_inter + p["D"].float()[:, None] * xh
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm"], cfg.rms_eps, tp)
    out = reduce_out(y @ p["out"], tp)
    if not return_cache:
        return out, None
    W = cfg.ssm.d_conv
    if S < W - 1:
        raise ValueError(f"mamba_parallel: a cache needs at least {W - 1} "
                         f"tokens, got {S}")
    # copies: a view would keep each (B,S,·) projection alive
    tail = lambda t: t[:, S - (W - 1):].clone()
    cache = {"conv_x": tail(xr), "conv_B": tail(br), "conv_C": tail(cr),
             "state": h}
    return out, cache


def _conv_step(raw_new, buf, w):
    """One step of the causal conv: ``buf`` (B, W-1, C) holds the previous
    raw inputs and takes the new one IN PLACE; returns (B, 1, C), the
    window's products summed in f32 and rounded once, as a contraction."""
    window = torch.cat([buf, raw_new], dim=1)             # (B,W,C)
    y = (window.float() * w.float()).sum(dim=1, keepdim=True)
    buf.copy_(window[:, 1:])
    return y.to(raw_new.dtype)


def mamba_decode(p, x, cfg, cache, tp=None):
    """One-step recurrence. x: (B,1,d); cache: ``mamba_cache_pd``'s tree,
    its conv windows and state updated IN PLACE. Returns (out, cache).
    ``tp``: the model axis (the module's docstring)."""
    _, _, hd, ds = _dims(cfg)
    di, nh = _local(p, cfg)
    B = x.shape[0]
    xin = silu(_conv_step(x @ p["in_x"], cache["conv_x"], p["conv_x"]))
    Bm = silu(_conv_step(x @ p["in_B"], cache["conv_B"], p["conv_B"]))
    Cm = silu(_conv_step(x @ p["in_C"], cache["conv_C"], p["conv_C"]))
    Bm, Cm = Bm.float()[:, 0], Cm.float()[:, 0]           # (B,ds)
    z = x @ p["in_z"]
    dt = softplus(x @ p["in_dt"] + p["dt_bias"]).float()[:, 0]   # (B,nh)
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, nh, hd).float()

    h = cache["state"]                                    # (B,nh,hd,ds)
    h.mul_(torch.exp(dt * A)[..., None, None]).add_(
        (dt[..., None] * xh)[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bs,bnps->bnp", Cm, h) + p["D"].float()[:, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm"], cfg.rms_eps, tp)
    return reduce_out(y @ p["out"], tp), cache


def mamba_cache_pd(cfg, batch: int, dtype=torch.bfloat16):
    """One layer's cache descriptors: the conv windows in ``dtype``, the
    state in f32; ``conv_x`` and ``state`` split their heads over
    ``model`` (the reference's specs)."""
    di, nh, hd, ds = _dims(cfg)
    W = cfg.ssm.d_conv
    zeros = lambda *shape, dt=dtype, spec=("data",): PD(  # noqa: E731
        shape, spec=spec, init="zeros", dtype=dt)
    return {"conv_x": zeros(batch, W - 1, di, spec=("data", None, "model")),
            "conv_B": zeros(batch, W - 1, ds),
            "conv_C": zeros(batch, W - 1, ds),
            "state": zeros(batch, nh, hd, ds, dt=torch.float32,
                           spec=("data", "model"))}
