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

Over a model axis ``tp`` (ROADMAP §1 item 6.2b) the leaves split as the
reference's specs split them, and each rank runs its own heads (a rank's
columns hold whole heads: ``transformer.tp_axis`` refuses head counts the
axis does not divide). mLSTM: ``w_up``, ``w_z``, ``wq``, ``wk`` and
``wv`` by columns, ``norm`` by d_inner and ``out`` by rows; the
up-projection is gathered (``wq``, ``wk``, ``wv`` and the replicated
gates ``w_i``, ``w_f`` read all of it), the norm over d_inner sums the
rank's squares over the axis, and ``out``'s partial products end in
``reduce_out``. sLSTM: the four gates' input weights by columns of d,
the recurrent weights, biases and ``norm`` whole, the FFN's up and down
projections by columns and rows; the recurrence is block-diagonal by
head, so a rank steps its heads alone, and their outputs are gathered
before the norm over the whole d. A replicated leaf that a rank reads only
its heads' share of enters through ``copy_in``, so its gradient is summed
over the axis. The caches are whole on every rank (the reference's specs
replicate them over ``model``): a rank's heads are gathered after the
prefill and after each decode step.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _fit
from repro_torch.models.common import PD, copy_in, dense_pd, gather_out, \
    log_sigmoid, reduce_out, rms_norm
from repro_torch.models.mlp import gelu, silu

#: the sLSTM gates, in the order their pre-activations are stacked
GATES = ("i", "f", "z", "o")


# ---------------------------------------------------------------------------
# mLSTM


def mlstm_pd(cfg):
    d = cfg.d_model
    di = int(cfg.xlstm.proj_factor_m * d)
    col = (None, "model")
    return {
        "w_up": dense_pd(d, di, spec=col),
        "w_z": dense_pd(d, di, spec=col),
        "wq": dense_pd(di, di, spec=col),
        "wk": dense_pd(di, di, spec=col),
        "wv": dense_pd(di, di, spec=col),
        "w_i": dense_pd(di, cfg.n_heads),
        "w_f": dense_pd(di, cfg.n_heads),
        "b_i": PD((cfg.n_heads,), init="zeros"),
        "b_f": PD((cfg.n_heads,), init="const", scale=3.0),
        "norm": PD((di,), spec=("model",), init="ones"),
        "out": dense_pd(di, d, spec=("model", None),
                        scale=di ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }


def _mlstm_heads(cfg):
    di = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    nh = cfg.n_heads
    return di, nh, di // nh


def _heads(tp, nh: int) -> slice:
    """The heads of a rank over the model axis ``tp`` (all without one)."""
    if tp is None:
        return slice(0, nh)
    k = nh // tp.size
    return slice(tp.index * k, (tp.index + 1) * k)


def _replicated(p, names, tp):
    """The replicated leaves ``names`` of ``p`` through ``copy_in``: a
    rank reads its heads' share, so their gradients sum over ``tp``."""
    return {n: copy_in(p[n], tp) for n in names}


def _mlstm_qkv_gates(p, u, cfg, shape, tp=None):
    """q and k (both scaled by hd^-0.5), v, the input gate and the log
    forget gate, f32, from the (whole) up-projection ``u``; q, k, v
    reshaped to ``shape + (nh, hd)``, the gates to ``shape + (nh,)``, nh
    the rank's heads over ``tp``."""
    _, nh, hd = _mlstm_heads(cfg)
    sl = _heads(tp, nh)
    n = sl.stop - sl.start
    g = _replicated(p, ("w_i", "w_f", "b_i", "b_f"), tp)
    q = (u @ p["wq"]).reshape(*shape, n, hd).float() * hd ** -0.5
    k = (u @ p["wk"]).reshape(*shape, n, hd).float() * hd ** -0.5
    v = (u @ p["wv"]).reshape(*shape, n, hd).float()
    ig = (u @ g["w_i"] + g["b_i"]).float().reshape(*shape, nh)[..., sl]
    fg = log_sigmoid((u @ g["w_f"] + g["b_f"]).float()).reshape(
        *shape, nh)[..., sl]
    return q, k, v, ig, fg


def _up(p, x, tp):
    """The up-projection (whole over ``tp``: gathered, and read by
    column-split products, so its gradient is summed back) and the rank's
    columns of the gate z."""
    xc = copy_in(x, tp)
    return copy_in(gather_out(xc @ p["w_up"], tp), tp), xc @ p["w_z"]


def mlstm_parallel(p, x, cfg, *, return_cache: bool = False, tp=None):
    """Chunkwise-parallel mLSTM. x: (B,S,d) -> ((B,S,d), cache | None). A
    length that is not a multiple of ``cfg.xlstm.chunk`` takes, with
    ``return_cache``, the largest chunk that divides it (exact: padding
    would decay the state on fake steps); without, zero padding at the
    end. The cache holds the final C (B,nh,hd,hd), n (B,nh,hd) and m
    (B,nh), f32. ``tp``: the model axis (the module's docstring)."""
    _, nh, hd = _mlstm_heads(cfg)
    cl = cfg.xlstm.chunk
    B, S, _ = x.shape
    if S % cl:
        if return_cache:
            cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
                cfg.xlstm, chunk=_fit(S, cl)))
            return mlstm_parallel(p, x, cfg, return_cache=True, tp=tp)
        out, _ = mlstm_parallel(p, F.pad(x, (0, 0, 0, (-S) % cl)), cfg,
                                tp=tp)
        return out[:, :S], None
    nc = S // cl

    u, z = _up(p, x, tp)
    q, k, v, ig, fg = _mlstm_qkv_gates(p, u, cfg, (B, nc, cl), tp)
    nh = q.shape[-2]
    di = nh * hd
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
    h = rms_norm(h, p["norm"], cfg.rms_eps, tp) * silu(z)
    out = reduce_out(h @ p["out"], tp)
    if not return_cache:
        return out, None
    return out, {"C": gather_out(C, tp, 1), "n": gather_out(n, tp, 1),
                 "m": gather_out(m, tp, 1)}


def mlstm_decode(p, x, cfg, cache, tp=None):
    """One step. x: (B,1,d); cache: ``mlstm_cache_pd``'s tree, C, n and m
    updated IN PLACE (over ``tp`` the rank's heads, then every rank's
    gathered into it). Returns (out, cache)."""
    _, nh, hd = _mlstm_heads(cfg)
    B = x.shape[0]
    u, z = _up(p, x, tp)
    q, k, v, ig, fg = _mlstm_qkv_gates(p, u[:, 0], cfg, (B,), tp)
    sl = _heads(tp, nh)
    di = (sl.stop - sl.start) * hd
    C, n, m = cache["C"][:, sl], cache["n"][:, sl], cache["m"][:, sl]
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
    h = rms_norm(h, p["norm"], cfg.rms_eps, tp) * silu(z)
    if tp is not None:
        for key in "Cnm":
            cache[key].copy_(gather_out(cache[key][:, sl], tp, 1))
    return reduce_out(h @ p["out"], tp), cache


def mlstm_cache_pd(cfg, batch: int):
    di, nh, hd = _mlstm_heads(cfg)
    return {"C": PD((batch, nh, hd, hd), spec=("data",), init="zeros"),
            "n": PD((batch, nh, hd), spec=("data",), init="zeros"),
            "m": PD((batch, nh), spec=("data",), init="const",
                    scale=-1e30)}


# ---------------------------------------------------------------------------
# sLSTM


def slstm_pd(cfg):
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    df = int(cfg.xlstm.proj_factor_s * d)
    p = {}
    for g in GATES:
        p[f"w_{g}"] = dense_pd(d, d, spec=(None, "model"))
        p[f"r_{g}"] = PD((nh, hd, hd), scale=hd ** -0.5)
        p[f"b_{g}"] = (PD((d,), init="const", scale=3.0) if g == "f"
                       else PD((d,), init="zeros"))
    p["norm"] = PD((d,), init="ones")
    p["ffn_up"] = dense_pd(d, df, spec=(None, "model"))
    p["ffn_down"] = dense_pd(df, d, spec=("model", None),
                             scale=df ** -0.5 / math.sqrt(2 * cfg.n_layers))
    return p


def _slstm_inputs(p, x, tp=None):
    """The gates' input pre-activations, f32: x (..., d) -> (..., 4, d'),
    in ``GATES`` order; and their recurrent weights stacked, f32: (nh',
    hd, 4 · hd). Over ``tp`` d' and nh' are the rank's columns of d and
    its heads (the rank's columns of the input weights, its slices of the
    replicated biases and recurrent weights)."""
    sl = _heads(tp, p["r_i"].shape[0])
    dl = p["w_i"].shape[1]
    cols = _cols(tp, dl)
    g = _replicated(p, [f"{k}_{x}" for k in "br" for x in GATES], tp)
    w = torch.cat([p[f"w_{x}"].float() for x in GATES], dim=1)
    b = torch.cat([g[f"b_{x}"].float()[cols] for x in GATES])
    xg = (copy_in(x, tp).float() @ w + b).reshape(*x.shape[:-1], len(GATES),
                                                   dl)
    r = torch.stack([g[f"r_{x}"][sl].float() for x in GATES], dim=2)
    return xg, r.reshape(r.shape[0], r.shape[1], -1)


def _cols(tp, dl: int) -> slice:
    """A rank's ``dl`` columns of d over the model axis ``tp``."""
    c0 = 0 if tp is None else tp.index * dl
    return slice(c0, c0 + dl)


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


def _slstm_out(p, h, cfg, tp=None):
    """The norm over the whole d of the (whole) h, and the FFN: its up
    projection split by columns over ``tp``, its down one by rows."""
    h = rms_norm(h, p["norm"], cfg.rms_eps)
    return h + reduce_out(gelu(copy_in(h, tp) @ p["ffn_up"])
                          @ p["ffn_down"], tp)


def slstm_parallel(p, x, cfg, *, return_cache: bool = False, tp=None):
    """Sequential scan over time (sLSTM has a true recurrence). x: (B,S,d)
    -> ((B,S,d), cache | None); the cache holds the final c, n, h, m (B,
    d) f32. ``tp``: the model axis (the module's docstring)."""
    B, S, _ = x.shape
    xg, r = _slstm_inputs(p, x, tp)                        # (B,S,4,d')
    dl = xg.shape[-1]
    zeros = xg.new_zeros((B, dl))
    carry = (zeros, zeros, zeros, xg.new_full((B, dl), -1e30))
    hs = []
    for t in range(S):
        carry = _slstm_step(r, carry, xg[:, t])
        hs.append(carry[2])
    h = gather_out(torch.stack(hs, dim=1).to(x.dtype), tp)
    out = _slstm_out(p, h, cfg, tp)
    cache = ({k: gather_out(t, tp, 1) for k, t in zip("cnhm", carry)}
             if return_cache else None)
    return out, cache


def slstm_decode(p, x, cfg, cache, tp=None):
    """One step. x: (B,1,d); cache: ``slstm_cache_pd``'s tree, updated IN
    PLACE (over ``tp`` from the rank's columns, every rank's gathered
    into it). Returns (out, cache)."""
    xg, r = _slstm_inputs(p, x[:, 0], tp)                  # (B,4,d')
    cols = _cols(tp, xg.shape[-1])
    new = _slstm_step(r, tuple(cache[k][:, cols] for k in "cnhm"), xg)
    for k, t in zip("cnhm", new):
        cache[k].copy_(gather_out(t, tp, 1))
    return _slstm_out(p, cache["h"][:, None].to(x.dtype), cfg, tp), cache


def slstm_cache_pd(cfg, batch: int):
    d = cfg.d_model
    mk = lambda init, scale=0.0: PD((batch, d), spec=("data",), init=init,
                                    scale=scale)
    return {"c": mk("zeros"), "n": mk("zeros"), "h": mk("zeros"),
            "m": mk("const", -1e30)}


def block_kind(cfg, layer_idx: int) -> str:
    pat = cfg.xlstm.pattern
    return pat[layer_idx % len(pat)]
