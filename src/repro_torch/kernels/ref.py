"""Plain PyTorch versions of the port's kernels.

Each kernel wrapper runs these for a tensor that lies on the
CPU, and ``chip_smoke.py`` and the GPU tests hold each kernel against them
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.bucketing import CHUNK
from repro_torch.models.common import attention_mask


def batched_sumsq(flat, seg_ids, n_tensors: int):
    """flat: (n_chunks*CHUNK,) ; seg_ids: (n_chunks,) integer.
    Returns (n_tensors,) f32 sum of squares per segment; chunks whose id
    lies outside [0, n_tensors) are dropped, as ``segment_sum`` does."""
    x = flat.reshape(-1, CHUNK).float()
    per_chunk = (x * x).sum(dim=-1)
    seg = seg_ids.long()
    keep = (seg >= 0) & (seg < n_tensors)
    out = torch.zeros(n_tensors, dtype=torch.float32, device=flat.device)
    return out.index_add_(0, seg[keep], per_chunk[keep])


def batched_sumsq_multi(rows, seg_ids, n_tensors: int):
    """rows: R sequences of packed buffers; seg_ids: the segment map of a
    row's concatenated chunks. Returns (R, n_tensors) f32: ``batched_sumsq``
    of each row's buffers concatenated."""
    return torch.stack([batched_sumsq(torch.cat(list(row)), seg_ids,
                                      n_tensors) for row in rows])


def lars_packed_update(p, g, m, trust, seg_ids, *, lr, momentum, wd):
    """Flat packed LARS step. p/g/m: (n_chunks*CHUNK,) f32 (g may be
    bf16); trust: (n_tensors,) f32; seg_ids: (n_chunks,) integer; ``lr`` a
    float or 0-d tensor. Returns new (p, m), with the reference's
    association ``m2 = momentum*m + (lr*t)*g``."""
    t = trust[seg_ids.long()].repeat_interleave(CHUNK)
    if isinstance(lr, torch.Tensor):
        lr = lr.to(device=p.device, dtype=torch.float32)
    g = g.float() + wd * p
    m2 = momentum * m + (lr * t) * g
    return p - m2, m2


def lars_packed_update_multi(p_shards, g_shards, m_shards, trust, seg_ids,
                             *, lr, momentum, wd):
    """``lars_packed_update`` of each bucket's shards, in place: bucket b
    takes its span of ``seg_ids``, the segment map over the buckets'
    chunks concatenated. Returns ``(p_shards, m_shards)`` as tuples of the
    buffers given, updated."""
    lo = 0
    for p, g, m in zip(p_shards, g_shards, m_shards):
        hi = lo + p.numel() // CHUNK
        p2, m2 = lars_packed_update(p, g, m, trust, seg_ids[lo:hi], lr=lr,
                                    momentum=momentum, wd=wd)
        p.copy_(p2)
        m.copy_(m2)
        lo = hi
    return tuple(p_shards), tuple(m_shards)


def ring_add_step(recv, chunks, k: int):
    """The ring reduce-scatter's fold: ``recv + chunks[k]`` in recv's
    dtype (PyTorch adds bf16 in f32 and rounds once)."""
    return recv + chunks[k]


def smoothed_xent_rows(logits, labels, *, smoothing: float):
    """Per-row label-smoothed NLL ``lse - ((1-ε)·x_y + ε·mean(x))``, no
    masking or averaging. logits: (T, V) f32 or bf16, upcast to f32;
    labels: (T,) integer. Returns (T,) f32. A label outside [0, V) (IGNORE)
    takes no target logit, as the kernel's column test gives."""
    x = logits.float()
    V = x.shape[-1]
    lab = labels.long()
    hit = (lab >= 0) & (lab < V)
    tgt = torch.gather(x, -1, torch.where(hit, lab, 0)[:, None])[:, 0]
    tgt = torch.where(hit, tgt, 0.0)
    return torch.logsumexp(x, dim=-1) - ((1.0 - smoothing) * tgt
                                         + smoothing * x.mean(dim=-1))


#: the masked-score fill of the TPU kernel and of the chunked path: finite,
#: so a row that has seen only masked keys never computes inf - inf
NEG = -1e30


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    n_q_heads: int = None, n_kv_heads: int = None):
    """q: (B·H, Sq, Dk); k: (B·K, Sk, Dk); v: (B·K, Sk, Dv). Returns
    (B·H, Sq, Dv) in q's dtype: a plain masked softmax in f32 with q scaled
    by Dk^-0.5, key and query positions both from 0, mask ``kpos <= qpos``
    (causal) and ``kpos > qpos - window`` (window > 0), query row-block
    ``bh`` reading kv head ``(bh // H)·K + (bh % H) // G``."""
    BH, Sq, Dk = q.shape
    BK, Sk, Dv = v.shape
    H = n_q_heads or BH
    K = n_kv_heads or BK
    G = H // K
    if BH % H or (BH // H) * K != BK or H % K:
        raise ValueError(f"flash_attention: BH {BH}, BK {BK} do not fit "
                         f"H {H}, K {K}")
    bh = torch.arange(BH, device=q.device)
    kv = (bh // H) * K + (bh % H) // G
    s = torch.einsum("bqd,bkd->bqk", q.float() * Dk ** -0.5,
                     k.float()[kv])
    if causal or window:
        s = s.masked_fill(~attention_mask(torch.arange(Sq, device=q.device),
                                          torch.arange(Sk, device=q.device),
                                          causal, window), NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()[kv])
    return (o / l.clamp_min(1e-30)).to(q.dtype)
