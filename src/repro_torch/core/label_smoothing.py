"""Label-smoothed cross entropy (paper §III-A.2).

Loss = (1-ε)·NLL(target) + ε·mean_v(NLL(v)), from logsumexp. Labels equal
to ``IGNORE`` are masked out.
"""
from __future__ import annotations

import torch

IGNORE = -1


def smoothed_xent(logits, labels, *, smoothing: float = 0.1):
    """logits: (..., V); labels: (...) integer (IGNORE = masked).
    Returns (mean loss, n_valid)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    mean_all = logits.mean(dim=-1)
    nll = lse - ((1.0 - smoothing) * tgt + smoothing * mean_all)
    n_valid = valid.sum()
    loss = torch.where(valid, nll, 0.0).sum() / n_valid.clamp(min=1)
    return loss, n_valid


def top1_accuracy(logits, labels):
    valid = labels != IGNORE
    pred = torch.argmax(logits, dim=-1)
    hit = valid & (pred == labels)
    return hit.sum() / valid.sum().clamp(min=1)
