"""xLSTM blocks (Beck et al., arXiv:2405.04517; a port of
``repro.models.xlstm``): mLSTM (matrix memory, chunkwise-parallel linear
attention with exponential gating and a stabilizer state) and sLSTM
(scalar memory, a recurrence with block-diagonal head-recurrent weights).

mLSTM trains and prefills in a chunked parallel form (intra-chunk
quadratic term, then a (C, n, m) state scan over chunks) and decodes
recurrently; sLSTM is a true recurrence, one step a token. The JAX package
scans both with ``lax.scan``; the port walks them with Python loops. The
sLSTM step takes its four gates' recurrent products in one contraction
over the stacked weights. Decode updates the cache's states IN PLACE (the
JAX package returns an updated copy).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _fit
from repro_torch.models.common import PD, dense_pd, log_sigmoid, rms_norm
from repro_torch.models.mlp import gelu, silu

#: the sLSTM gates, in the order their pre-activations are stacked
GATES = ("i", "f", "z", "o")


# ---------------------------------------------------------------------------
# mLSTM


def mlstm_pd(cfg):
    d = cfg.d_model
    di = int(cfg.xlstm.proj_factor_m * d)
    return {
        "w_up": dense_pd(d, di),
        "w_z": dense_pd(d, di),
        "wq": dense_pd(di, di),
        "wk": dense_pd(di, di),
        "wv": dense_pd(di, di),
        "w_i": dense_pd(di, cfg.n_heads),
        "w_f": dense_pd(di, cfg.n_heads),
        "b_i": PD((cfg.n_heads,), init="zeros"),
        "b_f": PD((cfg.n_heads,), init="const", scale=3.0),
        "norm": PD((di,), init="ones"),
        "out": dense_pd(di, d, scale=di ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }


def _mlstm_heads(cfg):
    di = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    nh = cfg.n_heads
    return di, nh, di // nh


def _mlstm_qkv_gates(p, u, cfg, shape):
    """q and k (both scaled by hd^-0.5), v, the input gate and the log
    forget gate, f32, from the up-projection ``u``; q, k, v reshaped to
    ``shape + (nh, hd)``, the gates to ``shape + (nh,)``."""
    _, nh, hd = _mlstm_heads(cfg)
    q = (u @ p["wq"]).reshape(*shape, nh, hd).float() * hd ** -0.5
    k = (u @ p["wk"]).reshape(*shape, nh, hd).float() * hd ** -0.5
    v = (u @ p["wv"]).reshape(*shape, nh, hd).float()
    ig = (u @ p["w_i"] + p["b_i"]).float().reshape(*shape, nh)
    fg = log_sigmoid((u @ p["w_f"] + p["b_f"]).float()).reshape(*shape, nh)
    return q, k, v, ig, fg


def mlstm_parallel(p, x, cfg, *, return_cache: bool = False):
    """Chunkwise-parallel mLSTM. x: (B,S,d) -> ((B,S,d), cache | None). A
    length that is not a multiple of ``cfg.xlstm.chunk`` takes, with
    ``return_cache``, the largest chunk that divides it (exact: padding
    would decay the state on fake steps); without, zero padding at the
    end. The cache holds the final C (B,nh,hd,hd), n (B,nh,hd) and m
    (B,nh), f32."""
    di, nh, hd = _mlstm_heads(cfg)
    cl = cfg.xlstm.chunk
    B, S, _ = x.shape
    if S % cl:
        if return_cache:
            cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
                cfg.xlstm, chunk=_fit(S, cl)))
            return mlstm_parallel(p, x, cfg, return_cache=True)
        out, _ = mlstm_parallel(p, F.pad(x, (0, 0, 0, (-S) % cl)), cfg)
        return out[:, :S], None
    nc = S // cl

    u = x @ p["w_up"]
    z = x @ p["w_z"]
    q, k, v, ig, fg = _mlstm_qkv_gates(p, u, cfg, (B, nc, cl))
    b = torch.cumsum(fg, dim=2)                            # within-chunk

    # intra-chunk log weights D[i,j] = b_i - b_j + i_j  (i >= j)
    Dlog = b[:, :, :, None, :] - b[:, :, None, :, :] + ig[:, :, None, :, :]
    mask = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    Dlog = torch.where(mask[None, None, :, :, None], Dlog, -math.inf)

    C = q.new_zeros((B, nh, hd, hd))
    n = q.new_zeros((B, nh, hd))
    m = q.new_full((B, nh), -math.inf)
    hs = []
    for c in range(nc):
        qi, ki, vi, bi, igi, Di = (q[:, c], k[:, c], v[:, c], b[:, c],
                                   ig[:, c], Dlog[:, c])
        # stabilizer per query position
        m_i = torch.maximum(m[:, None] + bi, Di.amax(dim=2))   # (B,cl,nh)
        inter_w = torch.exp(m[:, None] + bi - m_i)             # (B,cl,nh)
        Dw = torch.exp(Di - m_i[:, :, None, :])                # (B,i,j,nh)
        qk = torch.einsum("binp,bjnp->bijn", qi, ki) * Dw
        num = (torch.einsum("bijn,bjnp->binp", qk, vi)
               + inter_w[..., None] * torch.einsum("binp,bnpv->binv", qi, C))
        den = (qk.sum(dim=2)
               + inter_w * torch.einsum("binp,bnp->bin", qi, n))
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # chunk-end state update
        b_end = bi[:, -1]                                      # (B,nh)
        scale = b_end[:, None] - bi + igi                      # (B,cl,nh)
        m_new = torch.maximum(m + b_end, scale.amax(dim=1))
        decay = torch.exp(m + b_end - m_new)
        wk = torch.exp(scale - m_new[:, None])[..., None] * ki  # (B,cl,nh,hd)
        C = decay[..., None, None] * C \
            + torch.einsum("bjnp,bjnv->bnpv", wk, vi)
        n = decay[..., None] * n + wk.sum(dim=1)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, di).to(x.dtype)
    h = rms_norm(h, p["norm"], cfg.rms_eps) * silu(z)
    out = h @ p["out"]
    return out, ({"C": C, "n": n, "m": m} if return_cache else None)


def mlstm_decode(p, x, cfg, cache):
    """One step. x: (B,1,d); cache: ``mlstm_cache_pd``'s tree, C, n and m
    updated IN PLACE. Returns (out, cache)."""
    di, nh, hd = _mlstm_heads(cfg)
    B = x.shape[0]
    u = x @ p["w_up"]
    z = x @ p["w_z"]
    q, k, v, ig, fg = _mlstm_qkv_gates(p, u[:, 0], cfg, (B,))
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(fg + m, ig)
    fw = torch.exp(fg + m - m_new)[..., None]
    iw = torch.exp(ig - m_new)[..., None]
    C.mul_(fw[..., None]).add_(iw[..., None]
                               * (k[..., None] * v[..., None, :]))
    n.mul_(fw).add_(iw * k)
    m.copy_(m_new)
    num = torch.einsum("bnp,bnpv->bnv", q, C)
    den = torch.einsum("bnp,bnp->bn", q, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(B, 1, di).to(x.dtype)
    h = rms_norm(h, p["norm"], cfg.rms_eps) * silu(z)
    return h @ p["out"], cache


def mlstm_cache_pd(cfg, batch: int):
    di, nh, hd = _mlstm_heads(cfg)
    return {"C": PD((batch, nh, hd, hd), init="zeros"),
            "n": PD((batch, nh, hd), init="zeros"),
            "m": PD((batch, nh), init="const", scale=-1e30)}


# ---------------------------------------------------------------------------
# sLSTM


def slstm_pd(cfg):
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    df = int(cfg.xlstm.proj_factor_s * d)
    p = {}
    for g in GATES:
        p[f"w_{g}"] = dense_pd(d, d)
        p[f"r_{g}"] = PD((nh, hd, hd), scale=hd ** -0.5)
        p[f"b_{g}"] = (PD((d,), init="const", scale=3.0) if g == "f"
                       else PD((d,), init="zeros"))
    p["norm"] = PD((d,), init="ones")
    p["ffn_up"] = dense_pd(d, df)
    p["ffn_down"] = dense_pd(df, d,
                             scale=df ** -0.5 / math.sqrt(2 * cfg.n_layers))
    return p


def _slstm_inputs(p, x):
    """The gates' input pre-activations, f32: x (..., d) -> (..., 4, d),
    in ``GATES`` order; and their recurrent weights stacked, f32: (nh, hd,
    4 · hd)."""
    d = x.shape[-1]
    w = torch.cat([p[f"w_{g}"].float() for g in GATES], dim=1)
    b = torch.cat([p[f"b_{g}"].float() for g in GATES])
    xg = (x.float() @ w + b).reshape(*x.shape[:-1], len(GATES), d)
    r = torch.stack([p[f"r_{g}"].float() for g in GATES], dim=2)
    return xg, r.reshape(r.shape[0], r.shape[1], -1)


def _slstm_step(r, carry, xg):
    """One time step. carry: (c, n, h, m), each (B, d) f32; xg: (B, 4, d)
    input pre-activations; r: the stacked recurrent weights."""
    c, n, h, m = carry
    B, d = c.shape
    nh, hd = r.shape[0], r.shape[1]
    rec = torch.einsum("bnp,npq->bnq", h.reshape(B, nh, hd), r)
    pre = xg + rec.reshape(B, nh, len(GATES), hd).transpose(1, 2) \
        .reshape(B, len(GATES), d)
    it, ft, zt, ot = pre.unbind(1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    logf = log_sigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(logf + m - m_new)
    c = f * c + i * zt
    n = f * n + i
    h = ot * c / n.clamp_min(1e-6)
    return c, n, h, m_new


def _slstm_out(p, h, cfg):
    h = rms_norm(h, p["norm"], cfg.rms_eps)
    return h + gelu(h @ p["ffn_up"]) @ p["ffn_down"]


def slstm_parallel(p, x, cfg, *, return_cache: bool = False):
    """Sequential scan over time (sLSTM has a true recurrence). x: (B,S,d)
    -> ((B,S,d), cache | None); the cache holds the final c, n, h, m (B,
    d) f32."""
    B, S, d = x.shape
    xg, r = _slstm_inputs(p, x)                            # (B,S,4,d)
    zeros = xg.new_zeros((B, d))
    carry = (zeros, zeros, zeros, xg.new_full((B, d), -1e30))
    hs = []
    for t in range(S):
        carry = _slstm_step(r, carry, xg[:, t])
        hs.append(carry[2])
    out = _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype), cfg)
    cache = dict(zip("cnhm", carry)) if return_cache else None
    return out, cache


def slstm_decode(p, x, cfg, cache):
    """One step. x: (B,1,d); cache: ``slstm_cache_pd``'s tree, updated IN
    PLACE. Returns (out, cache)."""
    xg, r = _slstm_inputs(p, x[:, 0])                      # (B,4,d)
    new = _slstm_step(r, tuple(cache[k] for k in "cnhm"), xg)
    for k, t in zip("cnhm", new):
        cache[k].copy_(t)
    return _slstm_out(p, new[2][:, None].to(x.dtype), cfg), cache


def slstm_cache_pd(cfg, batch: int):
    d = cfg.d_model
    mk = lambda init, scale=0.0: PD((batch, d), init=init, scale=scale)
    return {"c": mk("zeros"), "n": mk("zeros"), "h": mk("zeros"),
            "m": mk("const", -1e30)}


def block_kind(cfg, layer_idx: int) -> str:
    pat = cfg.xlstm.pattern
    return pat[layer_idx % len(pat)]
