"""Attention: GQA (+QKV bias, sliding window) and its KV cache.

Train/prefill attention runs either the flash kernel (``cfg.flash_attention``:
``kernels/ops.flash_attention_bshd``, K5) or the chunked online-softmax
path below, which keeps the JAX package's chunking, block skipping and
bf16 roundings so both packages compute the same numbers. Decode is one
token against a (B, S_max, K, Dh) cache that the port updates in place.

Not ported yet (ROADMAP §1 item 10): MLA, ``qk_norm``, cross-attention.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import NEG
from repro_torch.models.common import PD, attention_mask, dense_pd, rope

NOT_PORTED = "is not ported to repro_torch yet (ROADMAP §1 item 10)"


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
    if cfg.qk_norm:
        raise NotImplementedError(f"qk_norm {NOT_PORTED}")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_pd(d, H * hd),
        "wk": dense_pd(d, K * hd),
        "wv": dense_pd(d, K * hd),
        "wo": dense_pd(H * hd, d, scale=(H * hd) ** -0.5
                       / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        p["bq"] = PD((H * hd,), init="zeros")
        p["bk"] = PD((K * hd,), init="zeros")
        p["bv"] = PD((K * hd,), init="zeros")
    return p


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
    straddle the causal diagonal or the window's edge."""
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
            first_inside = -(-(q_offset + i * cq + 1 - window) // ck)
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


def _qkv(p, x, cfg):
    hd = cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (_split_heads(q, cfg.n_heads, hd),
            _split_heads(k, cfg.n_kv_heads, hd),
            _split_heads(v, cfg.n_kv_heads, hd))


def gqa_parallel(p, x, positions, cfg, *, cache_len: int = 0,
                 cross_x=None):
    """Train/prefill attention. Returns (out, cache|None); the cache holds
    k/v written into zero (B, cache_len, K, Dh) buffers when
    cache_len > 0."""
    if cross_x is not None:
        raise NotImplementedError(f"cross-attention {NOT_PORTED}")
    B, S = x.shape[:2]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = _attend(q, k, v, cfg, causal=True, window=cfg.sliding_window)
    out = o.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim) @ p["wo"]
    cache = None
    if cache_len:
        if cache_len < S:
            raise ValueError(f"cache_len {cache_len} < prompt length {S}")
        kc = k.new_zeros((B, cache_len, *k.shape[2:]))
        vc = v.new_zeros((B, cache_len, *v.shape[2:]))
        kc[:, :S] = k
        vc[:, :S] = v
        cache = {"k": kc, "v": vc}
    return out, cache


def gqa_decode(p, x, pos: int, cfg, cache, *, cross: bool = False):
    """One-token decode. x: (B,1,d); pos: the token's index (Python int);
    cache: {'k','v'} (B,Smax,K,Dh), updated IN PLACE at row ``pos`` (the
    JAX package returns an updated copy) and returned."""
    if cross:
        raise NotImplementedError(f"cross-attention {NOT_PORTED}")
    kc, vc = cache["k"], cache["v"]
    if not 0 <= pos < kc.shape[1]:
        raise ValueError(f"decode position {pos} outside the cache "
                         f"(length {kc.shape[1]})")
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope_theta:
        pp = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, pp, cfg.rope_theta)
        k = rope(k, pp, cfg.rope_theta)
    kc[:, pos] = k[:, 0]
    vc[:, pos] = v[:, 0]
    o = decode_attention(q, kc, vc, pos, window=cfg.sliding_window)
    return o @ p["wo"], cache
