"""Train state: fp32 master params + momentum (the paper's mixed-precision
scheme keeps the update in fp32), BN statistics for the conv family, and
on the sharded rungs the packed momentum shards and (zero1, zero3) the
persistent fp32 master shards.

The step counter is a host integer: the schedule and the data are
functions of it, and keeping it off the device spares a sync per step.

Sharded layouts: ``init_packed_momentum``, ``init_packed_shards`` and
``full_params_from_shards`` work on the reference's GLOBAL layout (one
``(n_shards * c,)`` buffer per bucket, rank-major: row r holds the chunk
rank r owns), so they match it bit for bit. A rank keeps only its own row
(``local_shards``) in ``TrainState.shards`` and ``TrainState.mom``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import bucketing, lars, pinit
from repro_torch.kernels.backend import resolve_device
from repro_torch.tree import tree_flatten


class TrainState(NamedTuple):
    step: int
    params: Any          # fp32 master tree; ZeRO-1: the gathered forward
                         # copy (with gather='ahead' one update behind);
                         # ZeRO-2: the masters; ZeRO-3: None
    mom: Any             # fp32 momentum tree (lamb: {'m', 'v', 'count'});
                         # sharded: this rank's packed bucket shards
    bn_state: Any = None  # resnet only
    shards: Any = None   # ZeRO-1/3: this rank's fp32 master shards, one
                         # flat buffer per bucket; the authoritative
                         # masters (ZeRO-2: None)


def init_packed_momentum(plan, n_shards: int = 1, *, device=None):
    """ZeRO-1 sharded momentum in the global layout: one zero fp32
    ``(n_shards * bucketing.shard_elems,)`` buffer per bucket."""
    return tuple(torch.zeros(n_shards * bucketing.shard_elems(s, n_shards),
                             dtype=torch.float32, device=device)
                 for s in plan.bucket_sizes)


def init_packed_shards(params, plan, n_shards: int = 1):
    """ZeRO-1 persistent master shards in the global layout: the fp32
    params packed into the bucket plan and each bucket rotated into the
    rank-major sharded layout (``bucketing.rotate_to_shards``)."""
    bufs = bucketing.pack(params, plan, dtype=torch.float32)
    return tuple(bucketing.rotate_to_shards(b, n_shards) for b in bufs)


def full_params_from_shards(shards, plan, n_shards: int = 1):
    """The full fp32 master param tree from the global shard buffers: the
    exact inverse of ``init_packed_shards``, in buffers of its own. With
    gather-ahead this, not ``state.params``, is the authoritative read of
    a sharded state."""
    bufs = [bucketing.unrotate_shards(b, n_shards)[:plan.bucket_sizes[i]]
            .clone() for i, b in enumerate(shards)]   # no view of shards
    return bucketing.unpack(bufs, plan, dtype=torch.float32)


def local_shards(bufs, n_shards: int, index: int):
    """Rank ``index``'s row of each global sharded buffer, as buffers of
    its own (``TrainState.shards`` / ``mom`` on the sharded path)."""
    return tuple(b.reshape(n_shards, -1)[index].clone() for b in bufs)


def host_snapshot(state: TrainState) -> TrainState:
    """A copy of the whole state that shares no memory with it (dicts,
    tuples and lists of tensors cloned; ``None`` and host scalars as they
    are): what the guard's rollback ring keeps (``train/guard.py``). The
    sharded step updates shards and momentum in place, so a snapshot is
    never a view. The copies stay on the state's device: a device clone
    of the full-width zero1 state takes ~2.6 ms on an H100
    (``chip_smoke.py``)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(copy(v) for v in x)
        return x
    return TrainState(*(copy(f) for f in state))


def restore_snapshot(snapshot: TrainState) -> TrainState:
    """A state to train on from a snapshot, in tensors of its own, so the
    snapshot survives the in-place update of the next step (a second trip
    can roll back to it again)."""
    return host_snapshot(snapshot)


def _local_shard_writer(plan, n_shards: int, index: int, device):
    """Rank ``index``'s rows of ``init_packed_shards`` built leaf by leaf,
    with no global buffer: (the zero shards, ``write(path, leaf)``, which
    copies the leaf's elements that fall in this rank's row of each of its
    buckets). Row ``index`` holds chunk ``(index + 1) % n_shards`` of the
    padded bucket (``bucketing.rotate_to_shards``). Leaves write disjoint
    elements, so ``write`` may run from several threads."""
    sizes = bucketing.shard_sizes(plan, n_shards)
    shards = tuple(torch.zeros(c, dtype=torch.float32, device=device)
                   for c in sizes)
    k = (index + 1) % n_shards
    slots = {}
    for slot in plan.slots:
        slots.setdefault(slot.path, []).append(slot)

    def write(path, leaf):
        flat = leaf.reshape(-1)
        for slot in slots[path]:
            c = sizes[slot.bucket]
            lo = max(slot.offset, k * c)
            hi = min(slot.offset + slot.size, (k + 1) * c)
            if lo < hi:
                at = slot.elem_offset - slot.offset
                shards[slot.bucket][lo - k * c:hi - k * c].copy_(
                    flat[at + lo:at + hi])
    return shards, write


def gather_rows(buf: torch.Tensor, axis) -> torch.Tensor:
    """This rank's row of a sharded buffer -> the global ``(n * c,)``
    buffer, rows in the order of ``axis`` (``launch.mesh.Axis``, the shard
    axis). ``axis`` None or of size 1: the buffer itself."""
    if axis is None or axis.size == 1:
        return buf
    import torch.distributed as dist
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf.contiguous(), group=axis.group)
    return torch.cat(parts)


def init_state(model, seed: int = 0, *, device=None, opt_kind: str = "lars",
               sharded_plan=None, n_shards: int = 1, mesh=None,
               materialize_params: bool = True,
               shard_params: bool = True) -> TrainState:
    """State on ``device`` (default: the card). ``sharded_plan`` (a
    ``BucketPlan``, typically ``train_step.bucket_plan``) switches the
    momentum to the packed sharded layout of the sharded rungs and adds
    the persistent master shards; each rank keeps the row of its position
    on the mesh's shard axis (0 without a ``mesh``). As the reference's:
    ``materialize_params=False`` (the ZeRO-3 state) drops the full params
    once the shards are packed; ``shard_params=False`` (the ZeRO-2 state)
    keeps the replicated params as the masters and packs only the
    momentum. ``sharded_state_kwargs(train_step)`` gives what a step
    needs. The shards and momentum are this rank's rows alone, made
    without the global buffers; the ZeRO-3 state draws each leaf on the
    host and keeps only its rows (``_local_shard_writer``), so no full
    fp32 tree is ever on the device: zamba2-7b's is 27 GB. Without a
    ``sharded_plan``, a ``mesh`` with a model axis makes the params and
    momentum of the ``comm='xla'`` step over it: a rank's shards by the
    leaves' specs (``pinit.materialize(..., mesh=)``)."""
    device = resolve_device(device)
    if not materialize_params and (sharded_plan is None or not shard_params):
        raise ValueError("materialize_params=False (ZeRO-3) needs a "
                         "sharded_plan with shard_params=True")
    shards = None
    if sharded_plan is not None:
        index = 0
        if mesh is not None:
            from repro_torch.comm.schedules import shard_axis
            index = shard_axis(mesh.axes).index
        mom = tuple(torch.zeros(c, dtype=torch.float32, device=device)
                    for c in bucketing.shard_sizes(sharded_plan, n_shards))
        if shard_params:
            shards, write = _local_shard_writer(sharded_plan, n_shards,
                                                index, device)
            if not materialize_params:
                pinit.materialize(model.param_pd, seed, "cpu", sink=write)
    params = (pinit.materialize(model.param_pd, seed, device,
                                mesh=mesh if sharded_plan is None else None)
              if materialize_params else None)
    if shards is not None and params is not None:
        for path, leaf in tree_flatten(params):
            write(path, leaf)
    if sharded_plan is None:
        mom = lars.init_momentum(params, opt_kind)
    bn = None
    if model.bn_state_pd is not None:
        bn = pinit.materialize(model.bn_state_pd, seed, device)
    return TrainState(0, params, mom, bn, shards)


def sharded_state_kwargs(train_step) -> dict:
    """The ``init_state`` keywords of the state ``train_step`` takes (the
    reference's CLI spells the same choice out): the packed layout for a
    sharded rung, no params for zero3, no master shards for zero2."""
    sharding = getattr(train_step, "sharding", "replicated")
    if sharding == "replicated":
        # the comm='xla' step over a mesh: a rank's shards by spec
        mesh = getattr(train_step, "mesh", None)
        return ({"mesh": mesh} if mesh is not None
                and getattr(train_step, "comm", None) == "xla" else {})
    return dict(sharded_plan=train_step.bucket_plan,
                n_shards=train_step.n_shards, mesh=train_step.mesh,
                materialize_params=sharding != "zero3",
                shard_params=sharding != "zero2")
