"""Elastic n→m resharded resume (a port of ``repro.train.elastic``).

A sharded run persists its fp32 masters and momentum as per-bucket
buffers in the device-major rotated layout
(``bucketing.rotate_to_shards``), whose shapes depend on the shard count
n, so a checkpoint written on n ranks does not ``checkpoint.load`` into an
m-rank template. The CommPlan committed beside the payload pins the exact
packing layout, and the reshard goes through the exact round trip

    old shards --unrotate(n)--> packed buckets --unpack--> fp32 tree
               --pack--> packed buckets --rotate(m)--> new shards

Every hop is a pure relayout in fp32 (slice, reshape, concat, zero pad), so
the masters land bit-exact; the padding tail of every bucket carries zero
momentum by construction, so the momentum round-trips bit-exact too. The
two plans need not share bucket boundaries.

The relayout works on the GLOBAL buffers (as the checkpoint holds them);
with a ``mesh``, each rank then keeps its row of the result.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bucketing
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import (TrainState, full_params_from_shards,
                                     init_packed_momentum,
                                     init_packed_shards, init_state,
                                     local_shards)
from repro_torch.tree import tree_unflatten


class ElasticResumeError(ckpt.CheckpointError):
    """Elastic resume preconditions not met (actionable message)."""


def _tensor(b) -> torch.Tensor:
    return b if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.array(b, np.float32))


def reshard_buffers(bufs: Sequence, old_plan: bucketing.BucketPlan,
                    old_n: int, new_plan: bucketing.BucketPlan,
                    new_n: int) -> List[torch.Tensor]:
    """Per-bucket global device-major buffers (tensors or numpy arrays)
    under ``(old_plan, old_n)`` -> the same values laid out for
    ``(new_plan, new_n)``, in new tensors. Exact in fp32 (no arithmetic).
    The plans may differ in bucket boundaries; they must describe the same
    tensor set (same packing order)."""
    if len(bufs) != old_plan.n_buckets:
        raise ElasticResumeError(
            f"{len(bufs)} shard buffers for a {old_plan.n_buckets}-bucket "
            f"plan — checkpoint and CommPlan disagree")
    for b, buf in enumerate(bufs):
        want = old_n * bucketing.shard_elems(old_plan.bucket_sizes[b],
                                             old_n)
        if tuple(buf.shape) != (want,):
            raise ElasticResumeError(
                f"bucket {b} shard buffer has shape {tuple(buf.shape)}, "
                f"expected ({want},) for n_shards={old_n} — wrong "
                f"n_shards/plan for this checkpoint")
    tree = full_params_from_shards([_tensor(b) for b in bufs], old_plan,
                                   old_n)
    return list(init_packed_shards(tree, new_plan, new_n))


def load_resharded(ckpt_dir: str, template: TrainState,
                   new_plan: bucketing.BucketPlan, new_n_shards: int, *,
                   tag: Optional[str] = None, old_comm_plan=None,
                   mesh=None) -> TrainState:
    """Restore a sharded checkpoint onto a different shard count (and
    possibly different bucket boundaries), in new tensors on the
    template's device.

    ``template`` is a fresh state of the NEW layout (``make_template``, or
    ``init_state(..., sharded_plan=new_plan, n_shards=new_n_shards,
    mesh=mesh)``): with ``mesh`` its buffers are this rank's rows, without
    one the global buffers. Its params tree doubles as the path source for
    rebuilding the OLD plan from the committed CommPlan. fp32 masters and
    momentum restore bit-exact; the ``params`` forward copy is rebuilt from
    the masters. A non-sharded checkpoint falls back to a plain
    ``checkpoint.load``."""
    meta, data, saved_plan = ckpt.load_arrays(ckpt_dir, tag=tag)
    if not meta.get("sharded"):
        if template.shards is not None:
            raise ElasticResumeError(
                "checkpoint is non-sharded but the resume template carries "
                "ZeRO shards — resume with sharding='replicated', or "
                "re-checkpoint from a sharded run")
        return ckpt.load(template, ckpt_dir, tag=tag, mesh=mesh)
    if template.shards is None:
        raise ElasticResumeError(
            "sharded checkpoint needs a sharded resume template: "
            "init_state(..., sharded_plan=train_step.bucket_plan, "
            "n_shards=train_step.n_shards)")
    comm_plan = old_comm_plan if old_comm_plan is not None else saved_plan
    if comm_plan is None:
        raise ElasticResumeError(
            f"checkpoint in {ckpt_dir!r} carries no CommPlan, so the old "
            f"packing layout (bucket boundaries, shard count) is unknown — "
            f"elastic resume needs checkpoints saved with comm_plan=... "
            f"(train loop default since the elastic layer)")
    axis = ckpt._shard_axis(mesh)
    if axis is not None and axis.size != new_n_shards:
        raise ElasticResumeError(
            f"the mesh's shard axis {axis.name!r} has {axis.size} ranks, "
            f"the resume asks for {new_n_shards} shards")
    # the old plan needs only the template's paths and shapes (a ZeRO-3
    # template has no params: the new plan's slots carry them)
    tmpl_tree = template.params
    if tmpl_tree is None:
        first = {s.path: s for s in new_plan.slots if s.elem_offset == 0}
        tmpl_tree = tree_unflatten(new_plan.paths,
                                   [first[p] for p in new_plan.paths])
    old_plan = comm_plan.bucket_plan(tmpl_tree)
    device = template.shards[0].device

    def relayout(prefix):
        keys = [f"{prefix}|{i}" for i in range(old_plan.n_buckets)]
        missing = [k for k in keys if k not in data]
        if missing:
            raise ElasticResumeError(
                f"checkpoint lacks {missing} although its CommPlan "
                f"declares {old_plan.n_buckets} buckets — payload/plan "
                f"mismatch")
        return reshard_buffers([_tensor(data[k]).to(device) for k in keys],
                               old_plan, comm_plan.n_shards, new_plan,
                               new_n_shards)

    shards, mom = relayout("shards"), relayout("mom")
    # the forward copy from the masters (a gather-ahead step gathers from
    # the shards anyway); ZeRO-3 keeps none
    params = (full_params_from_shards(shards, new_plan, new_n_shards)
              if template.params is not None else None)
    if axis is not None:
        shards = local_shards(shards, new_n_shards, axis.index)
        mom = local_shards(mom, new_n_shards, axis.index)
    _check_like(template.shards, shards, "shards", new_n_shards)
    _check_like(template.mom, mom, "mom", new_n_shards)
    bn = ckpt._restore("bn", template.bn_state, data)
    return TrainState(int(meta["step"]), params, tuple(mom), bn,
                      tuple(shards))


def _check_like(want, got, name, n_shards):
    want_shapes = [tuple(w.shape) for w in want]
    got_shapes = [tuple(g.shape) for g in got]
    if want_shapes != got_shapes:
        raise ElasticResumeError(
            f"resharded {name} buffers {got_shapes} do not match the "
            f"template layout {want_shapes} (n_shards={n_shards}) — the "
            f"new train step's bucket plan differs from the one the "
            f"template was initialized with")


def make_template(model, new_plan: bucketing.BucketPlan,
                  new_n_shards: int, *, seed: int = 0, mesh=None,
                  opt_kind: str = "lars", materialize_params: bool = True,
                  device=None) -> TrainState:
    """A fresh sharded state of the new layout, what
    :func:`load_resharded` wants as ``template``: this rank's rows with a
    ``mesh`` (on its device), the global buffers without one (on
    ``device``). ``materialize_params=False`` builds the ZeRO-3 form
    (params None)."""
    if mesh is not None:
        return init_state(model, seed, device=mesh.device, opt_kind=opt_kind,
                          sharded_plan=new_plan, n_shards=new_n_shards,
                          mesh=mesh, materialize_params=materialize_params)
    s = init_state(model, seed, device=device, opt_kind=opt_kind)
    shards = init_packed_shards(s.params, new_plan, new_n_shards)
    return TrainState(
        0, s.params if materialize_params else None,
        init_packed_momentum(new_plan, new_n_shards,
                             device=shards[0].device),
        s.bn_state, shards)
