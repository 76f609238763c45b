"""Attention: GQA (+QKV bias, ``qk_norm``, sliding window), cross-attention
(whisper: keys and values from the encoder's states), MLA, KV caches.

Train/prefill attention runs either the flash kernel (``cfg.flash_attention``:
``kernels/ops.flash_attention_bshd``, K5) or the chunked online-softmax
path below, which keeps the JAX package's chunking, block skipping and
bf16 roundings so both packages compute the same numbers. Decode is one
token against a (B, S_max, K, Dh) cache that the port updates in place.
MLA (DeepSeek-V2) decodes in the *absorbed* form against a cache of only
the 512-d latent and the shared rope key. Cross-attention decodes one
token against a read-only cache of the encoder's keys and values.

Under a mesh's model axis (``tp``, a ``launch.mesh.Axis``; ROADMAP §1 item
6.2) a rank holds H/M query heads and K/M kv heads, the columns of
``wq``/``wk``/``wv`` and their biases and the rows of ``wo`` that belong
to them, as the reference's specs place them: its q heads ``[r·H/M, …)``
read its own kv heads ``[r·K/M, …)`` (G = H/K), so attention, K5 and the
cache stay local, and ``wo``'s partial output is all-reduced
(``common.reduce_out``). The replicated ``qk_norm`` scales act on the
local heads only, so their gradients are summed over the axis
(``common.copy_in``). Where the columns cut a head (K < M, or H % M != 0:
ROADMAP §1 item 6.2c, the reference's ``pin`` false case, which it leaves
to GSPMD) the cut activations are gathered whole and each rank attends
the heads its columns need (``HeadSplit``). MLA splits its heads alike
(item 6.3) and keeps the latent whole on every rank (the MLA section).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import NEG
from repro_torch.models.common import PD, attention_mask, copy_in, \
    dense_pd, gather_in, reduce_out, rms_norm, rope


def _scale(dh: int, dtype: torch.dtype) -> float:
    """Dh^-0.5 rounded to ``dtype``, as a Python float: multiplying by it
    rounds as the JAX package's ``x * jnp.asarray(scale, x.dtype)`` does,
    without a host-to-device copy (which would wait for the device)."""
    return torch.tensor(dh ** -0.5, dtype=dtype).item()


def _attend(q, k, v, cfg, *, causal: bool, window: int = 0):
    """Dispatch: the flash kernel (cfg.flash_attention) or the chunked
    online-softmax path."""
    if cfg.flash_attention:
        from repro_torch.kernels.ops import flash_attention_bshd
        return flash_attention_bshd(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, q_offset=0, causal=causal,
                             window=window, chunk=cfg.attn_chunk)


# ---------------------------------------------------------------------------
# parameter descriptors


def gqa_pd(cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    dp = "data" if cfg.fsdp else None
    p = {
        "wq": dense_pd(d, H * hd, spec=(dp, "model")),
        "wk": dense_pd(d, K * hd, spec=(dp, "model")),
        "wv": dense_pd(d, K * hd, spec=(dp, "model")),
        "wo": dense_pd(H * hd, d, spec=("model", dp),
                       scale=(H * hd) ** -0.5
                       / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        p["bq"] = PD((H * hd,), spec=("model",), init="zeros")
        p["bk"] = PD((K * hd,), spec=("model",), init="zeros")
        p["bv"] = PD((K * hd,), spec=("model",), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = PD((hd,), init="ones")
        p["k_norm"] = PD((hd,), init="ones")
    return p


def mla_pd(cfg):
    """MLA's leaves, placed as the reference places them: ``wq``, ``wk_b``
    and ``wv_b`` split their columns (the heads) over ``model``, ``wo``
    its rows; ``wkv_a`` (the latent and the shared rope key, which every
    head reads) and ``ckv_norm`` whole on every model rank."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dp = "data" if cfg.fsdp else None
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wq": dense_pd(d, H * qd, spec=(dp, "model")),
        "wkv_a": dense_pd(d, m.kv_lora_rank + m.rope_head_dim,
                          spec=(dp, None)),
        "ckv_norm": PD((m.kv_lora_rank,), init="ones"),
        "wk_b": dense_pd(m.kv_lora_rank, H * m.nope_head_dim,
                         spec=(dp, "model")),
        "wv_b": dense_pd(m.kv_lora_rank, H * m.v_head_dim,
                         spec=(dp, "model")),
        "wo": dense_pd(H * m.v_head_dim, d, spec=("model", dp),
                       scale=(H * m.v_head_dim) ** -0.5
                       / math.sqrt(2 * cfg.n_layers)),
    }


# ---------------------------------------------------------------------------
# chunked online-softmax attention (parallel form)


def _fit(s: int, c: int) -> int:
    """Largest divisor of s that is <= c."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(q, k, v, *, q_offset: int, causal: bool,
                      window: int = 0, chunk: int = 1024):
    """q: (B,Sq,H,Dh) k: (B,Sk,K,Dh) v: (B,Sk,K,Dv) with H = K*G. Positions
    of q are q_offset + arange(Sq); k positions are arange(Sk). Returns
    (B,Sq,H,Dv) in q's dtype.

    As the JAX package computes it: q scaled in its own dtype, scores and
    the online softmax in f32 (products of the inputs are exact in f32),
    p rounded to v's dtype before PV, one key chunk at a time over only the
    chunks a query chunk can see; the mask is applied only to chunks that
    straddle the causal diagonal or the window's edge. One difference: the
    JAX package leaves a key chunk unmasked when it lies inside the window
    of the query chunk's first query, so with a window longer than the
    chunk its later queries attend past their window (ROADMAP §3, fault
    3.4); here a key chunk goes unmasked only inside the window of the
    chunk's last query, and so of every query."""
    B, Sq, H, Dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    cq, ck = _fit(Sq, chunk), _fit(Sk, chunk)
    nq, nk = Sq // cq, Sk // ck
    dev = q.device
    scale = _scale(Dh, q.dtype)
    qr = q.reshape(B, nq, cq, K, G, Dh)
    kr = k.reshape(B, nk, ck, K, Dh)
    vr = v.reshape(B, nk, ck, K, Dv)

    outs = []
    for i in range(nq):
        qi = (qr[:, i] * scale).float()
        qpos = q_offset + i * cq + torch.arange(cq, device=dev)
        hi = min(nk, -(-(q_offset + (i + 1) * cq) // ck)) if causal else nk
        lo = max(0, (q_offset + i * cq - window) // ck) if window else 0
        hi = max(hi, lo + 1)
        # chunks strictly below the diagonal and strictly inside the window
        # need no mask
        full_hi = min(hi, (q_offset + i * cq) // ck) if causal else hi
        full_lo = lo
        if window:
            first_inside = -(-(q_offset + (i + 1) * cq - window) // ck)
            full_lo = max(lo, max(first_inside, 0))
        full_lo = min(full_lo, full_hi)

        m = torch.full((B, K, G, cq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, K, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, cq, Dv), dtype=torch.float32, device=dev)
        for j in range(lo, hi):
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kr[:, j].float())
            if j < full_lo or j >= full_hi:
                kpos = j * ck + torch.arange(ck, device=dev)
                s = s.masked_fill(
                    ~attention_mask(qpos, kpos, causal, window), NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(v.dtype).float(), vr[:, j].float())
            m = m_new
        oi = acc / l.clamp_min(1e-30)[..., None]
        outs.append(oi.permute(0, 3, 1, 2, 4))         # (B,cq,K,G,Dv)
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0):
    """q: (B,1,H,Dh); caches: (B,Smax,K,Dh); pos: the new token's index (a
    Python int; its k/v must already be in the cache). Attends over cache
    rows ``(pos - window, pos]`` (all of ``[0, pos]`` without a window):
    the rows the JAX package's mask keeps, so the masked rows' zero weights
    are never computed. Returns (B,1,H*Dh) in q's dtype."""
    B, _, H, Dh = q.shape
    K = k_cache.shape[2]
    lo = max(0, pos - window + 1) if window else 0
    kc, vc = k_cache[:, lo:pos + 1], v_cache[:, lo:pos + 1]
    qh = q.reshape(B, K, H // K, Dh) * _scale(Dh, q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), kc.float())
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(vc.dtype).float(), vc.float())
    return o.reshape(B, 1, H * Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """How the model axis cuts a GQA layer's heads, seen from one rank.
    The rank holds ``w = H·Dh/M`` columns of ``wq`` (and rows of ``wo``)
    and ``K·Dh/M`` of ``wk``/``wv``. Where those hold whole heads (M
    divides H and K) the rank attends its own heads and nothing moves.
    Where they cut a head (the reference's ``pin`` false case: K < M, or
    H % M != 0) q (``q_whole``), or k and v (``kv_whole``), are gathered
    whole over the axis (``common.gather_in``), the rank attends the query
    heads ``[q_lo, q_hi)`` its columns of o fall in, against the kv heads
    they read (``kv_lo``, ``kv_hi``; ``expand``: one kv head a query head,
    where the grouping does not survive the cut), and keeps its ``w``
    columns of o from ``col`` on for the row-split ``wo``. With
    ``kv_whole`` the k and v caches hold every kv head on every rank."""
    q_whole: bool
    kv_whole: bool
    q_lo: int
    q_hi: int
    kv_lo: int
    kv_hi: int
    expand: Optional[Tuple[int, ...]]
    col: int
    w: int


@functools.lru_cache(maxsize=256)
def _head_split(H: int, K: int, hd: int, m: int, r: int) -> HeadSplit:
    if H % m == 0 and K % m == 0:
        return HeadSplit(False, False, r * H // m, (r + 1) * H // m,
                         r * K // m, (r + 1) * K // m, None, 0, H * hd // m)
    w = H * hd // m
    q_lo, q_hi = r * w // hd, -(-(r + 1) * w // hd)
    G = H // K
    kv_lo, kv_hi = q_lo // G, (q_hi - 1) // G + 1
    n = q_hi - q_lo
    grouped = q_lo % G == 0 and (n % G == 0 or n < G)
    expand = None if grouped else tuple(h // G - kv_lo
                                        for h in range(q_lo, q_hi))
    return HeadSplit(H % m != 0, True, q_lo, q_hi, kv_lo, kv_hi, expand,
                     r * w - q_lo * hd, w)


def head_split(cfg, tp=None) -> HeadSplit:
    """The ``HeadSplit`` of ``cfg``'s attention over the model axis ``tp``
    (no axis: every head, nothing gathered)."""
    m, r = (1, 0) if tp is None else (tp.size, tp.index)
    return _head_split(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                       m, r)


def _head(p, x, cfg, w: str, tp, whole: bool, lo: int, hi: int):
    """x's heads ``[lo, hi)`` through projection ``w`` ("q", "k" or "v"):
    projected, biased, gathered whole over the model axis ``tp`` where
    ``whole`` (the rank's columns cut a head) and, with ``qk_norm``, q's
    and k's heads RMS-normed (before rope, as the JAX package does)."""
    hd = cfg.resolved_head_dim
    y = x @ p[f"w{w}"]
    if cfg.qkv_bias:
        y = y + p[f"b{w}"]
    if whole:
        y = _split_heads(gather_in(y, tp), -1, hd)[..., lo:hi, :]
    else:
        y = _split_heads(y, hi - lo, hd)
    if cfg.qk_norm and w != "v":
        y = rms_norm(y, copy_in(p[f"{w}_norm"], tp), cfg.rms_eps)
    return y


def _qkv(p, x, cfg, kv_src=None, tp=None):
    """Heads of q (from x), k and v (from ``kv_src``, default x) over the
    model axis ``tp`` (``head_split``): q's the rank attends, k's and v's
    its own or, where its columns cut a head, all K; the inputs read
    through ``copy_in`` (once where ``kv_src`` is x itself)."""
    hs = head_split(cfg, tp)
    same = kv_src is None or kv_src is x
    x = copy_in(x, tp)
    kv_src = x if same else copy_in(kv_src, tp)
    kv = (0, cfg.n_kv_heads) if hs.kv_whole else (hs.kv_lo, hs.kv_hi)
    return (_head(p, x, cfg, "q", tp, hs.q_whole, hs.q_lo, hs.q_hi),
            _head(p, kv_src, cfg, "k", tp, hs.kv_whole, *kv),
            _head(p, kv_src, cfg, "v", tp, hs.kv_whole, *kv))


def _kv_heads(t, hs: HeadSplit):
    """The kv heads the rank's query heads read, of k, v or a cache
    ``t`` (..., K', Dh): itself where it holds the rank's own heads."""
    if not hs.kv_whole:
        return t
    t = t[..., hs.kv_lo:hs.kv_hi, :]
    return t if hs.expand is None else t[..., list(hs.expand), :]


def _out(o, p, hs: HeadSplit, tp):
    """The attended heads' output o (..., heads·Dh) through the rank's
    rows of ``wo``: its own columns of o, the partial sums all-reduced."""
    if hs.q_whole:
        o = o[..., hs.col:hs.col + hs.w]
    return reduce_out(o @ p["wo"], tp)


def gqa_parallel(p, x, positions, cfg, *, cache_len: int = 0,
                 cross_x=None, tp=None):
    """Train/prefill attention. Returns (out, cache|None); the cache holds
    k/v written into zero (B, cache_len, K, Dh) buffers when
    cache_len > 0 (over the model axis ``tp`` the rank's K/M, or all K
    where its columns cut a head: ``head_split``). ``cross_x``
    (B, Sk, d): the encoder's states, the source of the keys and values of
    a non-causal attention without rope (the whisper encoder passes its
    own input, the decoder the encoder's output)."""
    B, S = x.shape[:2]
    hs = head_split(cfg, tp)
    q, k, v = _qkv(p, x, cfg, kv_src=cross_x, tp=tp)
    if cfg.rope_theta and cross_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = _attend(q, _kv_heads(k, hs), _kv_heads(v, hs), cfg,
                causal=cross_x is None, window=cfg.sliding_window)
    out = _out(o.reshape(B, S, q.shape[2] * cfg.resolved_head_dim), p, hs,
               tp)
    cache = None
    if cache_len:
        Sk = k.shape[1]
        if cache_len < Sk:
            raise ValueError(f"cache_len {cache_len} < length {Sk}")
        kc = k.new_zeros((B, cache_len, *k.shape[2:]))
        vc = v.new_zeros((B, cache_len, *v.shape[2:]))
        kc[:, :Sk] = k
        vc[:, :Sk] = v
        cache = {"k": kc, "v": vc}
    return out, cache


def _check_pos(pos: int, cache_rows: int):
    if not 0 <= pos < cache_rows:
        raise ValueError(f"decode position {pos} outside the cache "
                         f"(length {cache_rows})")


def _gqa_decode_rows(p, x, pos: int, cfg, kc, vc, tp=None):
    """One token against one layer's (B, Smax, K, Dh) caches (the rank's
    K/M heads over the model axis ``tp``), its k and v written into row
    ``pos`` in place. Returns the block's output."""
    _check_pos(pos, kc.shape[1])
    B = x.shape[0]
    hs = head_split(cfg, tp)
    q, k, v = _qkv(p, x, cfg, tp=tp)
    if cfg.rope_theta:
        pp = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, pp, cfg.rope_theta)
        k = rope(k, pp, cfg.rope_theta)
    kc[:, pos] = k[:, 0]
    vc[:, pos] = v[:, 0]
    o = decode_attention(q, _kv_heads(kc[:, :pos + 1], hs),
                         _kv_heads(vc[:, :pos + 1], hs), pos,
                         window=cfg.sliding_window)
    return _out(o, p, hs, tp)


def gqa_decode(p, x, pos: int, cfg, cache, *, cross: bool = False,
               tp=None):
    """One-token decode. x: (B,1,d); pos: the token's index (Python int);
    cache: {'k','v'} (B,Smax,K,Dh), updated IN PLACE at row ``pos`` (the
    JAX package returns an updated copy) and returned. ``cross``: the
    cache holds the encoder's keys and values, read only; the token
    attends over all of its rows. ``tp``: the model axis."""
    if not cross:
        return _gqa_decode_rows(p, x, pos, cfg, cache["k"],
                                cache["v"], tp), cache
    hs = head_split(cfg, tp)
    q = _head(p, copy_in(x, tp), cfg, "q", tp, hs.q_whole, hs.q_lo, hs.q_hi)
    o = decode_attention(q, _kv_heads(cache["k"], hs),
                         _kv_heads(cache["v"], hs), cache["k"].shape[1] - 1)
    return _out(o, p, hs, tp), cache


def gqa_decode_inplace(p, x, pos: int, cfg, ck_all, cv_all, layer: int,
                       tp=None):
    """Unrolled-serving decode: ck_all/cv_all are the stacked
    (L,B,Smax,K,Dh) caches; writes the one new token of layer ``layer`` in
    place and attends over that layer's slice. Returns (out, ck_all,
    cv_all), the caches being the given ones."""
    out = _gqa_decode_rows(p, x, pos, cfg, ck_all[layer], cv_all[layer],
                           tp)
    return out, ck_all, cv_all


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2)
#
# Over the model axis ``tp`` (ROADMAP §1 item 6.3) a rank holds the columns
# of ``wq``, ``wk_b`` and ``wv_b`` of its H/M heads and the rows of ``wo``
# that read them, as ``mla_pd`` places them. Every rank computes the latent
# and the shared rope key whole from the replicated ``wkv_a`` and keeps
# the whole latent cache (the reference's ``P(dp, None, None)``); the
# heads' partial cotangents of the latent are summed over the axis
# (``copy_in`` on the latent, so the replicated leaves' gradients are every
# rank's alike), and ``wo``'s partial output is all-reduced: one
# all-reduce a block in a prefill and in a decode step.


def _mla_latent(p, x, positions, cfg):
    """x's latent (rms-normed) and its shared rope key, rope applied:
    (B, S, kv_lora_rank) and (B, S, rope_head_dim)."""
    m = cfg.mla
    B, S = x.shape[:2]
    kv_a = x @ p["wkv_a"]
    ckv = rms_norm(kv_a[..., :m.kv_lora_rank], p["ckv_norm"], cfg.rms_eps)
    krope = kv_a[..., m.kv_lora_rank:].reshape(B, S, 1, m.rope_head_dim)
    return ckv, rope(krope, positions, cfg.rope_theta)[:, :, 0]


def _mla_q(p, x, positions, cfg):
    """x's query heads (those of the rank's columns of ``wq``) split into
    the nope part and the rope part, rope applied: (B, S, H', nope_head_dim)
    and (B, S, H', rope_head_dim)."""
    m = cfg.mla
    B, S = x.shape[:2]
    q = (x @ p["wq"]).reshape(B, S, -1, m.nope_head_dim + m.rope_head_dim)
    return q[..., :m.nope_head_dim], rope(q[..., m.nope_head_dim:],
                                          positions, cfg.rope_theta)


def mla_parallel(p, x, positions, cfg, *, cache_len: int = 0, tp=None):
    """Train/prefill MLA: keys and values decompressed from the latent,
    the shared rope key broadcast to every head and folded in as extra head
    dims, so q and k are (B, S, H, nope + rope) and v (B, S, H, v_head_dim)
    through ``_attend`` (K5 with ``cfg.flash_attention``; over the model
    axis ``tp`` the rank's H/M heads). Returns (out, cache|None); the
    cache holds the whole latent and the rope key written into zero (B,
    cache_len, ·) buffers when cache_len > 0."""
    m = cfg.mla
    B, S = x.shape[:2]
    ckv, krope = _mla_latent(p, x, positions, cfg)
    q_nope, q_rope = _mla_q(p, copy_in(x, tp), positions, cfg)
    H = q_nope.shape[2]
    lat = copy_in(ckv, tp)
    k_nope = (lat @ p["wk_b"]).reshape(B, S, H, m.nope_head_dim)
    v = (lat @ p["wv_b"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, copy_in(krope, tp)[:, :, None].expand(
        B, S, H, m.rope_head_dim)], dim=-1)
    o = _attend(q, k, v, cfg, causal=True)
    out = reduce_out(o.reshape(B, S, H * m.v_head_dim) @ p["wo"], tp)
    cache = None
    if cache_len:
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        c = ckv.new_zeros((B, cache_len, m.kv_lora_rank))
        r = krope.new_zeros((B, cache_len, m.rope_head_dim))
        c[:, :S] = ckv
        r[:, :S] = krope
        cache = {"ckv": c, "krope": r}
    return out, cache


def _mla_decode_rows(p, x, pos: int, cfg, ckv_c, kr_c, tp=None):
    """The absorbed decode of one token against one layer's latent cache
    (B, Smax, kv_lora_rank) and rope keys (B, Smax, rope_head_dim), its own
    row written at ``pos`` in place. W^UK is folded into the query
    (``q_abs``, f32, then in the cache's dtype) and W^UV applied to the
    attended latent, with the JAX package's dtypes: scores and softmax in
    f32 over the rows ``[0, pos]`` (the rows its mask keeps), the scale
    (nope + rope)^-0.5 unrounded. Over the model axis ``tp`` the rank's
    H/M heads (``wk_b``'s and ``wv_b``'s columns read as (r, H/M, ·)), the
    whole latent row written on every rank, ``wo``'s partial output
    all-reduced. Returns the block's output."""
    m = cfg.mla
    _check_pos(pos, ckv_c.shape[1])
    B, r = x.shape[0], m.kv_lora_rank
    pp = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    ckv_new, kr_new = _mla_latent(p, x, pp, cfg)
    ckv_c[:, pos] = ckv_new[:, 0]
    kr_c[:, pos] = kr_new[:, 0]
    ckv, kr = ckv_c[:, :pos + 1].float(), kr_c[:, :pos + 1].float()
    q_nope, q_rope = _mla_q(p, x, pp, cfg)
    H = q_nope.shape[2]
    wk_b = p["wk_b"].reshape(r, H, m.nope_head_dim).float()
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), wk_b)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    s = (torch.einsum("bhr,bsr->bhs", q_abs.to(ckv_c.dtype).float(), ckv)
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), kr)) * scale
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", prob.to(ckv_c.dtype).float(), ckv)
    wv_b = p["wv_b"].reshape(r, H, m.v_head_dim).float()
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv_b)
    return reduce_out(o.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
                      @ p["wo"], tp)


def mla_decode(p, x, pos: int, cfg, cache, tp=None):
    """Absorbed-form MLA decode: scores against the cached latent directly;
    only (ckv, krope) are cached, DeepSeek-V2's KV-cache reduction. cache:
    {'ckv', 'krope'}, updated IN PLACE at row ``pos`` and returned.
    ``tp``: the model axis."""
    return _mla_decode_rows(p, x, pos, cfg, cache["ckv"],
                            cache["krope"], tp), cache


def mla_decode_inplace(p, x, pos: int, cfg, ckv_all, kr_all, layer: int,
                       tp=None):
    """Absorbed MLA decode against the stacked (L, B, Smax, ·) latent
    caches, layer ``layer``'s row ``pos`` written in place. Returns (out,
    ckv_all, kr_all), the caches being the given ones. ``tp``: the model
    axis."""
    out = _mla_decode_rows(p, x, pos, cfg, ckv_all[layer], kr_all[layer],
                           tp)
    return out, ckv_all, kr_all
