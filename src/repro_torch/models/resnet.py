"""ResNet-50 (He et al. 2016), the paper's own architecture, in PyTorch.

A port of ``repro.models.resnet`` that keeps its public layouts: images are
NHWC, weights HWIO, parameters and BN statistics nested dicts at the JAX
package's paths. Inside, activations run as NCHW tensors in the
channels-last memory format (a free view of NHWC), and each HWIO weight is
permuted to OIHW in the forward, so autograd hands the gradient back in the
masters' HWIO layout.

BatchNorm follows the paper's §III-A.2: batch statistics are per process
(no cross-replica sync) and the moving averages use a tunable momentum. It
is written out by hand to match the reference exactly: normalise in f32
from the bf16 activations with the *biased* batch variance, and update the
running stats as ``m·old + (1−m)·batch`` with that same biased variance
(``nn.BatchNorm2d`` keeps the unbiased one).

``resnet_forward(..., mesh=)`` is the reference's forward over a mesh, as
its ``comm='xla'`` step runs it (ROADMAP §1 item 6.2b): each rank holds
the rows of its data index, and the statistics span the data axes' global
batch. With ``cfg.sync_bn`` they take the reference's cross-replica form
(per-rank mean m and variance v, then the data axes' mean of m and of
v + m·m, less the square of the first), on a one-rank mesh too; without
it, GSPMD's (the global mean, then the global mean of the squared
deviations). Either way the sums are ``all_sum``s, whose backward sums
the cotangents over the same ranks, and the new running statistics are
the same on every rank. Without a mesh (the explicit schedules, as the
reference passes none there) they are the process's own, whatever
``sync_bn`` says.

Convolutions pad "SAME" as XLA does, which is asymmetric for strided
convolutions: the stem's 7×7/2 pads (2, 3), a 3×3/2 pads (0, 1).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import PD, all_sum

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))  # (blocks, base width)


def _conv_pd(kh, kw, cin, cout):
    fan_in = kh * kw * cin
    return PD((kh, kw, cin, cout), scale=(2.0 / fan_in) ** 0.5)


def _bn_pd(c):
    return {"scale": PD((c,), init="ones"), "bias": PD((c,), init="zeros")}


def _bn_state_pd(c):
    return {"mean": PD((c,), init="zeros"),
            "var": PD((c,), init="ones")}


def resnet_pd(cfg) -> Tuple[dict, dict]:
    """Returns (params descriptors, bn-state descriptors)."""
    w = cfg.width
    params = {"stem": {"conv": _conv_pd(7, 7, 3, w), "bn": _bn_pd(w)}}
    state = {"stem": {"bn": _bn_state_pd(w)}}
    cin = w
    for si, (blocks, base) in enumerate(STAGES):
        base = base * w // 64
        for bi in range(blocks):
            cout = base * 4
            name = f"s{si}b{bi}"
            blk = {
                "conv1": _conv_pd(1, 1, cin, base), "bn1": _bn_pd(base),
                "conv2": _conv_pd(3, 3, base, base), "bn2": _bn_pd(base),
                "conv3": _conv_pd(1, 1, base, cout), "bn3": _bn_pd(cout),
            }
            st = {"bn1": _bn_state_pd(base), "bn2": _bn_state_pd(base),
                  "bn3": _bn_state_pd(cout)}
            if bi == 0:
                blk["proj"] = _conv_pd(1, 1, cin, cout)
                blk["bn_proj"] = _bn_pd(cout)
                st["bn_proj"] = _bn_state_pd(cout)
            params[name] = blk
            state[name] = st
            cin = cout
    params["head"] = {
        "w": PD((cin, cfg.n_classes), scale=cin ** -0.5),
        "b": PD((cfg.n_classes,), init="zeros"),
    }
    return params, state


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def to_nchw(x):
    """NHWC -> NCHW view in the channels-last memory format (no copy)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(x, w, stride=1):
    """x: (B,C,H,W) channels-last; w: HWIO. "SAME" padding."""
    kh, kw = w.shape[0], w.shape[1]
    (ht, hb), (wl, wr) = (same_pad(x.shape[2], kh, stride),
                          same_pad(x.shape[3], kw, stride))
    if ht == hb and wl == wr:
        pad = (ht, wl)
    else:
        x = F.pad(x, (wl, wr, ht, hb))
        pad = 0
    w = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=pad)


def _bn(x, p, st, *, train: bool, momentum: float, eps=1e-5, dp=None,
        sync: bool = False):
    """x: (B,C,H,W). Returns (y in x's dtype, new running stats). ``dp``:
    the data axes (``launch.mesh.Axis``) the batch is split over, None
    without a mesh; ``sync``: the cross-replica form (module docstring)."""
    xf = x.float()
    dims, c = (0, 2, 3), (1, -1, 1, 1)
    if train:
        # two passes, as jnp.var: mean, then the mean of squared deviations
        if dp is None:
            mean = xf.mean(dims)
            d = xf - mean.view(c)
            var = (d * d).mean(dims)
        elif sync:
            m = xf.mean(dims)
            dl = xf - m.view(c)
            v = (dl * dl).mean(dims)
            both = all_sum(torch.stack([m, v + m * m]), dp) \
                / math.prod(a.size for a in dp)
            mean, var = both[0], both[1] - both[0] * both[0]
            d = xf - mean.view(c)
        else:
            n = xf.numel() // xf.shape[1] * math.prod(a.size for a in dp)
            mean = all_sum(xf.sum(dims), dp) / n
            d = xf - mean.view(c)
            var = all_sum((d * d).sum(dims), dp) / n
        with torch.no_grad():
            new_st = {
                "mean": momentum * st["mean"] + (1 - momentum) * mean,
                "var": momentum * st["var"] + (1 - momentum) * var,
            }
    else:
        mean, var = st["mean"], st["var"]
        d = xf - mean.view(c)
        new_st = st
    y = d * torch.rsqrt(var + eps).view(c)
    y = y * p["scale"].float().view(c) + p["bias"].float().view(c)
    return y.to(x.dtype), new_st


def _maxpool(x):
    """3×3/2 max-pool, "SAME" padded with -inf as ``reduce_window`` does."""
    (ht, hb), (wl, wr) = same_pad(x.shape[2], 3, 2), same_pad(x.shape[3], 3, 2)
    x = F.pad(x, (wl, wr, ht, hb), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def resnet_forward(params, bn_state, cfg, images, *, train: bool,
                   mesh=None):
    """images: (B,H,W,3), the rank's rows over ``mesh``'s data axes.
    Returns (logits f32, new_bn_state); ``mesh``: the module's
    docstring."""
    # f32 products and convolutions run in full f32, as in the JAX package;
    # TF32 (PyTorch's default for cuDNN convolutions) keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mom = cfg.bn_momentum
    bn = functools.partial(
        _bn, train=train, momentum=mom, sync=cfg.sync_bn,
        dp=None if mesh is None else
        [a for a in mesh.axes if a.name != "model"])
    x = to_nchw(images.to(torch.bfloat16))
    new_state = {}

    x = _conv(x, params["stem"]["conv"], stride=2)
    x, st = bn(x, params["stem"]["bn"], bn_state["stem"]["bn"])
    new_state["stem"] = {"bn": st}
    x = _maxpool(F.relu(x))

    for si, (blocks, _) in enumerate(STAGES):
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            p, st_in = params[name], bn_state[name]
            stride = 2 if (bi == 0 and si > 0) else 1
            sts = {}
            h = _conv(x, p["conv1"])
            h, sts["bn1"] = bn(h, p["bn1"], st_in["bn1"])
            h = _conv(F.relu(h), p["conv2"], stride=stride)
            h, sts["bn2"] = bn(h, p["bn2"], st_in["bn2"])
            h = _conv(F.relu(h), p["conv3"])
            h, sts["bn3"] = bn(h, p["bn3"], st_in["bn3"])
            if "proj" in p:
                sc = _conv(x, p["proj"], stride=stride)
                sc, sts["bn_proj"] = bn(sc, p["bn_proj"], st_in["bn_proj"])
            else:
                sc = x
            x = F.relu(h + sc)
            new_state[name] = sts

    # the pooled bf16 activations meet the head in f32 (bf16 weights are
    # promoted), as jnp's type promotion does in the reference
    x = x.mean((2, 3)).float()
    logits = x @ params["head"]["w"].float() + params["head"]["b"].float()
    return logits, new_state
