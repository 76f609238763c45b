"""Parameter descriptors and the LM's shared numerics.

Parameters are described abstractly first (``PD``: shape, dtype,
initializer, placement) and materialized by ``repro_torch.core.pinit`` —
the basis of the paper's §III-B.1 broadcast-free initialization: every
process derives the same per-leaf seed from the tree path and a shared
seed.

A descriptor's ``spec`` is the JAX package's PartitionSpec written as a
tuple: per dim an axis name, a tuple of names or None, missing trailing
dims None. The port splits a leaf over the mesh's ``model`` axis only
(ROADMAP §1 item 6.2): a ``P(dp, "model")`` column split, a ``P("model",
dp)`` row split. A rank ``(d, m)`` of a ``(data, model)`` mesh holds the
m-th of M equal slices of each split leaf (``local_slice``) and every
replicated leaf whole.

Under a model axis the dense blocks run Megatron-style, as the reference's
GSPMD program computes them on that placement: a column-split matmul
reads its input through ``copy_in`` (forward identity, backward
all-reduce over ``model``), a row-split one's partial output goes through
``reduce_out`` (forward all-reduce, backward identity), and an output that
every model rank needs whole (the d-split embedding, the vocab-split
logits) is gathered by ``gather_out``, whose backward keeps the rank's
own slice: every model rank computes the same loss from the gathered
tensor, so its gradient there is the same on each, and summing it (as
``torch.distributed.nn``'s gather would, by a reduce-scatter) would
multiply it by M; an activation gathered whole into computation that
differs between the ranks (attention heads a rank's columns cut) goes
through ``gather_in``, whose backward does sum. A sum that every rank
of an axis needs whole and whose every term feeds each rank's loss (the
norm over a split d_inner,
the BatchNorm statistics over the data axes) goes through ``all_sum``,
whose backward sums the cotangents over the same ranks. The MoE layer's
experts (ROADMAP §1 item 6.3) move tokens to the rank that holds their
expert and back with ``all_to_all``, whose backward is the inverse
exchange; its output, cut over the sequence, comes back whole through
``gather_out(..., dim=1)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class PD:
    """Abstract parameter descriptor (a tree leaf)."""
    shape: Tuple[int, ...]
    spec: Tuple[Any, ...] = ()       # the PartitionSpec, as a tuple
    init: str = "normal"             # normal | zeros | ones | const
    scale: float = 0.02
    dtype: torch.dtype = torch.float32


def pd_stack(tree, n: int):
    """Add a leading layer dim of size n to every descriptor (the stacked
    layers of an LM, which the port walks with a Python loop); the new dim
    is not split."""
    return tree_map(lambda pd: dataclasses.replace(
        pd, shape=(n, *pd.shape), spec=(None, *pd.spec)), tree)


def dense_pd(d_in: int, d_out: int, *, spec=(),
             scale: Optional[float] = None) -> PD:
    if scale is None:
        scale = d_in ** -0.5
    return PD((d_in, d_out), spec=tuple(spec), init="normal", scale=scale)


# ---------------------------------------------------------------------------
# the model axis (ROADMAP §1 item 6.2)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a part the port refuses, naming its ROADMAP item."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP §1 item {item})")


def uneven_split(what: str, m: int) -> NotImplementedError:
    """The error of a split leaf whose dim ``m`` model ranks do not
    divide: the reference cannot place such a leaf either (its
    ``pinit.materialize`` raises jax's ValueError that the dimension
    should be divisible by ``m``), so no port item covers it."""
    return NotImplementedError(
        f"{what} over model={m}: an uneven split of a leaf, which the "
        f"reference cannot place either (its pinit.materialize raises "
        f"ValueError: the dimension should be divisible by {m})")


def dp_axes(mesh) -> tuple:
    """The names of every mesh axis that carries the batch (all but
    'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def model_axis(mesh):
    """The mesh's ``model`` axis (a ``launch.mesh.Axis``) where it spans
    more than one rank, else None (no mesh, no such axis, or size 1)."""
    if mesh is None or "model" not in mesh.axis_names:
        return None
    a = mesh.axis("model")
    return a if a.size > 1 else None


def local_slice(pd: PD, axis) -> Tuple[Optional[int], int, int]:
    """(dim, start, length) of this rank's slice of a leaf split over the
    model ``axis`` (the dim whose spec entry names ``model``); (None, 0, 0)
    for a replicated leaf or no axis."""
    d = next((d for d, e in enumerate(pd.spec)
              if "model" in (e if isinstance(e, tuple) else (e,))), None)
    if axis is None or d is None:
        return None, 0, 0
    n = pd.shape[d]
    if n % axis.size:
        raise uneven_split(f"a dim of {n}", axis.size)
    k = n // axis.size
    return d, axis.index * k, k


def local_shape(pd: PD, axis) -> Tuple[int, ...]:
    """A rank's shape of the leaf ``pd`` over the model ``axis``."""
    d, _, k = local_slice(pd, axis)
    return tuple(pd.shape) if d is None else \
        (*pd.shape[:d], k, *pd.shape[d + 1:])


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        return _gather_last(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width,
                         ctx.width).contiguous(), None, None, None, None)


class _GatherIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.index, ctx.width = group, index, x.shape[-1]
        return _gather_last(x, group, size)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return (g.narrow(-1, ctx.index * ctx.width, ctx.width).contiguous(),
                None, None, None)


def _gather_last(x, group, size, dim=-1):
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, split_dim, concat_dim):
        ctx.args = (group, size, concat_dim, split_dim)
        return _all_to_all(x, group, size, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def _all_to_all(x, group, size, split_dim, concat_dim):
    """x's ``split_dim`` cut into ``size`` blocks, block r sent to rank r;
    the blocks received concatenated along ``concat_dim`` in the order of
    the ranks that sent them (``jax.lax.all_to_all(..., tiled=True)``).
    One ``all_to_all_single`` on a contiguous buffer, block-major."""
    s = x.shape
    n = s[split_dim] // size
    send = x.reshape(*s[:split_dim], size, n, *s[split_dim + 1:]) \
        .movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[r]: rank r's block, x's shape with split_dim cut to n
    shape = list(s)
    shape[split_dim] = n
    shape[concat_dim] *= size
    return recv.movedim(0, concat_dim).reshape(shape)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        y = x.clone(memory_format=torch.contiguous_format)
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def all_sum(x, axes):
    """x summed over every rank of ``axes`` (``launch.mesh.Axis``es; those
    no group spans are skipped), the result the same on each; backward: the
    cotangents summed over the same ranks, since each rank's loss reads
    the sum. Without autograd the sum is taken in a copy."""
    groups = tuple(a.group for a in axes if a is not None
                   and a.group is not None)
    if not groups:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllSum.apply(x, groups)
    y = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(y, group=g)
    return y


def copy_in(x, axis):
    """x, replicated over the model ``axis``, into a column-split region:
    the identity forward, the partial gradients all-reduced backward."""
    if axis is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyIn.apply(x, axis.group)


def reduce_out(x, axis):
    """A row-split matmul's partial output summed over the model
    ``axis`` (backward: the identity). Without autograd the sum is taken
    in place."""
    if axis is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceOut.apply(x, axis.group)
    dist.all_reduce(x, group=axis.group)
    return x


def gather_out(x, axis, dim: int = -1):
    """The model ``axis``'s slices of x's ``dim`` (by default the last; a
    cache's heads, the MoE layer's sequence chunks), concatenated in rank
    order; backward: the rank's own slice of the gradient."""
    if axis is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherOut.apply(x, axis.group, axis.size, axis.index, dim)
    return _gather_last(x, axis.group, axis.size, dim)


def all_to_all(x, axis, split_dim: int, concat_dim: int):
    """``jax.lax.all_to_all(x, 'model', split_dim, concat_dim,
    tiled=True)`` over the model ``axis``: x's ``split_dim`` cut into M
    blocks, block r sent to rank r, the M blocks received concatenated
    along ``concat_dim`` in rank order. Backward: the inverse exchange
    (the two dims swapped). None: x itself."""
    if axis is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, axis.group, axis.size, split_dim,
                               concat_dim)
    return _all_to_all(x, axis.group, axis.size, split_dim, concat_dim)


class _CountedOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def counted_once(x, axis):
    """x, computed whole and alike on every rank of the model ``axis``
    from inputs read through ``copy_in`` (whose backward sums the ranks'
    cotangents): the identity forward, the cotangent divided by M
    backward, so that the sum over the ranks counts x's gradient once."""
    if axis is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CountedOnce.apply(x, axis.size)


def gather_in(x, axis):
    """The model ``axis``'s slices of x's last dim, concatenated in rank
    order, into computation that differs between the ranks (attention on
    the heads a rank's columns need, where its column slice of q, k or v
    cuts a head); backward: the cotangents summed over the axis, then the
    rank's own slice (every rank's loss term may read every slice)."""
    if axis is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherIn.apply(x, axis.group, axis.size, axis.index)
    return _gather_last(x, axis.group, axis.size)


# ---------------------------------------------------------------------------
# numerics (the JAX package's rounding: f32 inside, back to x's dtype)


def rms_norm(x, scale, eps: float = 1e-6, tp=None):
    """RMSNorm over the last dim in f32. ``tp``: that dim (and ``scale``)
    is split over this model axis: the rank's sum of squares is summed
    over it (``all_sum``) before the mean over the whole dim."""
    dt = x.dtype
    x = x.float()
    if tp is None:
        ms = x.square().mean(dim=-1, keepdim=True)
    else:
        ms = all_sum(x.square().sum(dim=-1, keepdim=True), (tp,)) \
            / (x.shape[-1] * tp.size)
    x = x * torch.rsqrt(ms + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm as the JAX package computes it: in f32, the mean and then
    the variance of the centred values (two passes), ``rsqrt(var + eps)``,
    scale and bias in f32, back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it, ``logaddexp(x,
    0)``: max(x, 0) + log1p(exp(-|x|)), one rounding to x's dtype after
    each operation (``torch.nn.functional.softplus`` returns x itself
    above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x):
    """log(sigmoid(x)) as ``jax.nn.log_sigmoid`` computes it:
    -softplus(-x)."""
    return -softplus(-x)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split (not interleaved) rotation with f32
    angles. x: (..., S, H, Dh); positions: (..., S) integers."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs      # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]              # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask_block(qpos, kpos, window: int = 0):
    """(Q, K) boolean mask (True = attend) for absolute positions."""
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def attention_mask(qpos, kpos, causal: bool, window: int = 0):
    """(Q, K) boolean mask (True = attend) of a causal and/or windowed
    (window > 0) attention at absolute positions."""
    if causal:
        return causal_mask_block(qpos, kpos, window)
    return kpos[None, :] > (qpos[:, None] - window)
