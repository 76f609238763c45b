"""Explicit data-parallel gradient reduction (paper §III-C), a port of
``repro.core.ddp``.

Gradients are packed into the bucket plan's several-MB flat buffers, in
backward-completion order (static layer groups, §III-C.2), and one
collective runs per bucket: the named schedule of ``repro_torch.comm``
(``psum``, ``ring``, ``hierarchical``, ``2d_torus``, ``dbtree``;
``bucketed`` is an alias of ``psum``). ``naive``, the baseline the paper
attacks, is one all-reduce per tensor in the wire dtype, no buckets.

Two places to run them: ``allreduce_grads`` / ``reduce_scatter_grads`` run after
the whole backward (``CommConfig.overlap=False``), while
``wrap_params_for_overlap`` plants them *inside* the backward (the
default): each bucket group's params pass through one
``torch.autograd.Function`` identity whose backward packs the group's
cotangents and runs the collective as soon as they exist. Each identity
is made where the forward first reads one of its group's leaves (the
wrapped tree is a ``tree.LazyTree``), so that autograd, which runs the
ready node made last first, runs it then and not after the whole
backward. This works with ``torch.autograd.grad`` over leaves (a
post-accumulate-grad hook would not fire there). Every rank must build the same graph, so that the
backward runs the collectives in the same order everywhere.

``axes`` are the mesh's ``launch.mesh.Axis`` objects (every axis is data
parallel). The sharded rungs (zero1, zero2, zero3) stop each bucket's
collective at the reduce-scatter and gather the params back
(``all_gather_params``, or per group inside the forward for ZeRO-3,
``jit_gather_params``).

A tensor larger than a bucket is split into spans across several
buckets (the LM's stacked ``(layers, ...)`` weights and its embedding: at
4 MB, 222 spans over 14 leaves). Its leaf passes through each span's
group identity in turn; on the replicated path the spans write their
reduced values into one f32 copy of the leaf's cotangent a backward
(``_split_span_out``), not a copy of the whole leaf each. The gradient of
a stacked leaf is whole only when the backward ends, so its buckets' (and
the tied embedding's) collectives fire after it, as the reference's do.

``wrap_params_for_probe``, ``mark_forward_start`` and
``mark_backward_start`` are the measurement twins of the overlap wrap:
the capture points of ``comm.autotune.measure_backward_profile``.

``tracer`` (``obs.trace.Tracer``) stamps each bucket's collective as the
reference's probes name it: ``ar[b<i>]`` (all-reduce), ``rs[b<i>]``
(reduce-scatter), ``ag[b<i>]`` (param all-gather) and, under zero3,
``ag[g<i>]`` (a group's just-in-time gather). ``None`` stamps nothing.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.comm import primitives as prim
from repro_torch.core import bucketing
from repro_torch.obs.trace import mark
from repro_torch.tree import LazyTree, tree_flatten, tree_map, \
    tree_unflatten


def allreduce_grads(grads, *, strategy: str, axes: Sequence,
                    plan: "bucketing.BucketPlan",
                    comm_dtype=torch.bfloat16, use_kernel: bool = False,
                    tracer=None):
    """Reduce-mean gradients over the data-parallel axes after the
    backward. ``comm_dtype`` is the wire dtype (paper §IV: bf16);
    ``use_kernel`` runs the ring folds through K3. Returns fp32
    gradients."""
    n = prim.axes_size(axes)
    if strategy == "naive":
        # a contiguous buffer of its own per tensor: psum reduces in place
        return tree_map(lambda g: prim.psum(
            g.to(comm_dtype, memory_format=torch.contiguous_format,
                 copy=True), tuple(axes)).float() / n, grads)
    from repro_torch.comm import get_schedule
    schedule = get_schedule(strategy)
    out = []
    for b, buf in enumerate(bucketing.pack(grads, plan, dtype=comm_dtype)):
        mark(tracer, f"ar[b{b}]", "B", [buf], bucket=b)
        out.append(schedule(buf, tuple(axes), use_kernel=use_kernel))
        mark(tracer, f"ar[b{b}]", "E", [out[-1]], bucket=b)
    red = bucketing.unpack(out, plan, dtype=torch.float32)
    return tree_map(lambda g: g / n, red)


class _BucketIdentity(torch.autograd.Function):
    """Identity over one bucket group's leaves (plus, on the sharded path,
    a zero-valued gradient sink) whose backward runs the group's
    collective. ``spec`` holds the group's static arguments."""

    @staticmethod
    def forward(ctx, spec, *args):
        ctx.spec = spec
        return args[:-1] if spec["sink"] else args

    @staticmethod
    def backward(ctx, *gs):
        spec = ctx.spec
        slots, axes = spec["slots"], spec["axes"]
        tracer, gi = spec["tracer"], spec["gi"]
        n = prim.axes_size(axes)
        name = f"{'rs' if spec['sink'] else 'ar'}[b{gi}]"
        mark(tracer, name, "B", gs, bucket=gi)
        buf = bucketing.pack_group(gs, slots, dtype=spec["comm_dtype"])
        if spec["sink"]:
            # reduce-scatter: the reduced-mean fp32 local shard is the
            # sink's gradient; a leaf's cotangent ends (None: no zero-filled
            # copy of a stacked leaf) only in the group of its FINAL span
            # (earlier groups of a split tensor still need the raw gradient
            # to pack their own span)
            shard = spec["fn"](buf, axes, use_kernel=spec["use_kernel"])
            shard = shard.float() / n
            mark(tracer, name, "E", [shard], bucket=gi)
            outs = tuple(None if fin else g
                         for g, fin in zip(gs, spec["finals"]))
            return (None,) + outs + (shard,)
        buf = spec["fn"](buf, axes, use_kernel=spec["use_kernel"])
        mark(tracer, name, "E", [buf], bucket=gi)
        pieces = bucketing.unpack_group(buf, slots, dtype=torch.float32)
        outs = []
        for slot, g, piece, fin in zip(slots, gs, pieces, spec["finals"]):
            if piece.shape == g.shape:          # slot covers the whole leaf
                outs.append(piece / n)
                continue
            # split span: write the reduced span into the leaf's f32
            # cotangent; its other spans belong to other groups, whose
            # identities (chained) reduce them in turn
            outs.append(_split_span_out(spec["owned"], slot, g, piece / n,
                                        fin))
        return (None,) + tuple(outs)


def _split_span_out(owned: dict, slot, g, reduced, final: bool):
    """The cotangent a split leaf's span hands on: ``g`` with the span's
    reduced values written in. The leaf's first span copies its raw f32
    cotangent ONCE into a buffer of its own (``owned``, one per wrap and
    leaf); the later spans' identities receive that buffer back from
    autograd (each chained identity is the only consumer of the next one's
    output) and write their spans into it in place, so a leaf of k spans
    costs one copy, not k. A ``g`` that is not the owned buffer (another
    consumer's gradient was added to it) is copied again, as the first
    span's is; the values are the same either way."""
    key = (slot.path, slot.shape)
    flat = owned.pop(key, None)
    if flat is None or g.data_ptr() != flat.data_ptr() \
            or g.dtype != torch.float32:
        flat = g.float().reshape(-1).clone()
    flat[slot.elem_offset:slot.elem_offset + slot.size] = reduced
    if not final:
        owned[key] = flat
    return flat.view(g.shape)


def _wrap_param_groups(params, plan: "bucketing.BucketPlan", make_spec,
                       extras=None, apply=None):
    """Route each bucket group's leaves through its identity, made when the
    forward first reads one of the group's leaves (a ``tree.LazyTree``).
    Slot i describes leaf ``n-1-slot_tensor_ids[i]`` (the plan walks
    reverse flatten order; a split tensor's spans map to one leaf). A leaf
    in several groups is CHAINED through their identities, applied in
    DECREASING group order so the backward fires them in bucket order;
    so the unit made on a first read is every group connected to the
    leaf's through shared leaves. ``apply(spec, args)`` replaces the
    collective identity (the probe's).

    Autograd runs the ready node of the highest sequence number first, so
    an identity made before the forward (the oldest node of the graph)
    would run only after the whole backward; made where the forward first
    uses its group, it runs as soon as its group's cotangents exist."""
    flat = tree_flatten(params)
    leaves = [x for _, x in flat]
    n_leaves = len(leaves)
    if n_leaves != plan.n_tensors:
        raise ValueError(f"tree has {n_leaves} leaves, plan "
                         f"{plan.n_tensors} tensors")
    leaf_idx = {id(slot): n_leaves - 1 - t
                for t, slot in zip(plan.slot_tensor_ids, plan.slots)}
    group_leaves = [[leaf_idx[id(s)] for s in group]
                    for group in plan.groups]
    unit_of = _units(group_leaves, n_leaves)
    made = {}

    def make(j):
        if j not in made:
            cur = {}
            for gi in sorted(unit_of[j], reverse=True):
                idxs = group_leaves[gi]
                args = [cur.get(i, leaves[i]) for i in idxs]
                if extras is not None:
                    args.append(extras[gi])
                spec = make_spec(gi, plan.groups[gi])
                outs = (_BucketIdentity.apply(spec, *args) if apply is None
                        else apply(spec, args))
                cur.update(zip(idxs, outs))
            made.update(cur)
        return made.pop(j, leaves[j])

    return LazyTree([p for p, _ in flat], make)


def _units(group_leaves, n_leaves: int):
    """Leaf index -> the group indices of its unit: the run of groups
    chained to its own through shared leaves. A split tensor's spans lie
    in consecutive buckets, so a unit is a run of consecutive groups, each
    sharing a leaf with the one before it."""
    units = []
    for gi, idxs in enumerate(group_leaves):
        if gi and set(idxs) & set(group_leaves[gi - 1]):
            units[-1].append(gi)
        else:
            units.append([gi])
    unit_of = [()] * n_leaves
    for unit in units:
        for gi in unit:
            for j in group_leaves[gi]:
                unit_of[j] = tuple(unit)
    return unit_of


def make_shard_sinks(plan: "bucketing.BucketPlan", n_shards: int, *,
                     device=None):
    """Zero-valued gradient sinks for the in-backward reduce-scatter: one
    fp32 ``(bucketing.shard_elems,)`` leaf per bucket, requiring grad.
    Differentiating a ``wrap_params_for_overlap(..., shard_sinks=sinks)``
    -wrapped loss with respect to them yields the per-bucket reduced-mean
    fp32 local gradient shards."""
    return tuple(torch.zeros(c, dtype=torch.float32, device=device,
                             requires_grad=True)
                 for c in bucketing.shard_sizes(plan, n_shards))


def wrap_params_for_overlap(params, plan: "bucketing.BucketPlan", *,
                            strategy: str, axes: Sequence,
                            comm_dtype=torch.bfloat16,
                            use_kernel: bool = False, shard_sinks=None,
                            tracer=None):
    """Overlap-aware bucket scheduling (paper §III-C.2): ``params`` with
    each bucket group's leaves routed through an identity whose backward
    performs that bucket's collective. Differentiating a loss of the
    wrapped params yields already reduced-mean fp32 gradients, each
    bucket's collective started the moment its group's cotangents exist.

    ``shard_sinks`` (from ``make_shard_sinks``) switches each group's
    collective to the schedule's reduce-scatter-terminal form (ZeRO-1):
    the backward hands back only this rank's reduced-mean fp32 shard, as
    the gradient of the matching sink; the params themselves need not
    require grad. No full reduced gradient ever exists."""
    axes = tuple(axes)
    if shard_sinks is not None:
        from repro_torch.comm import get_reduce_scatter
        rs = get_reduce_scatter(strategy)
        final_map = {id(s): fin for s, fin in zip(plan.slots,
                                                  plan.slot_is_final_span)}

        def shard_spec(gi, group):
            return {"slots": group, "axes": axes, "fn": rs, "sink": True,
                    "comm_dtype": comm_dtype, "use_kernel": use_kernel,
                    "finals": tuple(final_map[id(s)] for s in group),
                    "tracer": tracer, "gi": gi}

        return _wrap_param_groups(params, plan, shard_spec,
                                  extras=shard_sinks)
    from repro_torch.comm import get_schedule
    schedule = get_schedule(strategy)
    final_map = {id(s): fin for s, fin in zip(plan.slots,
                                              plan.slot_is_final_span)}
    owned = {}      # split leaf -> its f32 cotangent buffer, this backward
    return _wrap_param_groups(
        params, plan,
        lambda gi, group: {"slots": group, "axes": axes, "fn": schedule,
                           "sink": False, "comm_dtype": comm_dtype,
                           "use_kernel": use_kernel, "tracer": tracer,
                           "gi": gi, "owned": owned,
                           "finals": tuple(final_map[id(s)]
                                           for s in group)})


# --------------------------------------------------------------------------
# ZeRO-1 sharded-update path

def reduce_scatter_grads(grads, *, strategy: str, axes: Sequence,
                         plan: "bucketing.BucketPlan",
                         comm_dtype=torch.bfloat16, use_kernel: bool = False,
                         tracer=None):
    """POST-backward scatter (``CommConfig.overlap=False``): pack the
    gradients into the bucket plan and stop each bucket's collective at
    the reduce-scatter. Returns one fp32 reduced-MEAN shard per bucket,
    this rank's contiguous CHUNK-aligned slice (``shard_index`` layout)."""
    from repro_torch.comm import get_reduce_scatter
    rs = get_reduce_scatter(strategy)
    n = prim.axes_size(axes)
    out = []
    for b, buf in enumerate(bucketing.pack(grads, plan, dtype=comm_dtype)):
        mark(tracer, f"rs[b{b}]", "B", [buf], bucket=b)
        out.append(rs(buf, tuple(axes), use_kernel=use_kernel).float() / n)
        mark(tracer, f"rs[b{b}]", "E", [out[-1]], bucket=b)
    return out


def all_gather_params(param_shards, plan: "bucketing.BucketPlan", *,
                      shard_axis, wire_dtype=torch.bfloat16, tracer=None):
    """Gather phase: cast each fp32 master shard to the wire dtype once,
    ring all-gather along the shard axis, and unpack into the full fp32
    param tree (one collective per bucket)."""
    # a copy even where the wire dtype is the masters' (f32 wire, one
    # rank): the update writes the shards in place, and the gathered
    # forward copy must not follow it
    bufs = []
    for b, shard in enumerate(param_shards):
        wire = shard.to(wire_dtype, copy=True)
        mark(tracer, f"ag[b{b}]", "B", [wire], bucket=b)
        bufs.append(prim.ring_all_gather(wire, shard_axis,
                                         plan.bucket_sizes[b]))
        mark(tracer, f"ag[b{b}]", "E", [bufs[-1]], bucket=b)
    return bucketing.unpack(bufs, plan, dtype=torch.float32)


def gather_ahead_params(shards, plan: "bucketing.BucketPlan", *,
                        shard_axis, wire_dtype=torch.bfloat16, tracer=None):
    """Gather-AHEAD: rebuild this step's forward params from the persistent
    master shards (``TrainState.shards``, updated by the previous step) at
    the START of the step. Same collectives as ``all_gather_params``; only
    when it runs differs. The fp32 masters never round-trip through the
    wire dtype: only this forward copy is quantised."""
    return all_gather_params(shards, plan, shard_axis=shard_axis,
                             wire_dtype=wire_dtype, tracer=tracer)


def jit_gather_params(shards, plan: "bucketing.BucketPlan", *, shard_axis,
                      wire_dtype=torch.bfloat16, dtype=torch.float32,
                      tracer=None):
    """ZeRO-3's gather: the forward's param tree rebuilt from the master
    shards group by group (one ring all-gather a bucket group, each
    unpacked into its own leaves at once), called INSIDE the step's
    differentiated function, so that no full replica lives in the state.
    Leaves in ``dtype`` (fp32, as the reference's; the step passes the
    compute dtype where the wire carries exactly it). A split tensor's
    spans are copied into one buffer of the whole leaf as they arrive."""
    n = plan.n_tensors
    tid = {id(s): t for t, s in zip(plan.slot_tensor_ids, plan.slots)}
    leaves = [None] * n
    for gi, group in enumerate(plan.groups):
        wire = shards[gi].to(wire_dtype, copy=True)
        mark(tracer, f"ag[g{gi}]", "B", [wire], bucket=gi)
        buf = prim.ring_all_gather(wire, shard_axis, plan.bucket_sizes[gi])
        mark(tracer, f"ag[g{gi}]", "E", [buf], bucket=gi)
        for slot, v in zip(group, bucketing.unpack_group(buf, group,
                                                         dtype=dtype)):
            j = n - 1 - tid[id(slot)]     # packing walks reverse flatten
            if v.shape == slot.shape:     # unsplit: already reshaped
                leaves[j] = v
                continue
            if leaves[j] is None:
                leaves[j] = v.new_empty(slot.shape)
            leaves[j].view(-1)[slot.elem_offset:
                               slot.elem_offset + slot.size] = v
    return tree_unflatten(plan.paths, leaves)


# --------------------------------------------------------------------------
# backward-profile probes (``comm.autotune.measure_backward_profile``)

class _ProbeIdentity(torch.autograd.Function):
    """Identity over one bucket group's leaves whose backward calls
    ``probe(gi)`` once the group's cotangents exist, and passes them on."""

    @staticmethod
    def forward(ctx, probe, gi, *leaves):
        ctx.probe, ctx.gi = probe, gi
        return leaves

    @staticmethod
    def backward(ctx, *gs):
        ctx.probe(ctx.gi)
        return (None, None) + gs


class _LossProbe(torch.autograd.Function):
    """Identity on the scalar loss whose backward calls ``probe(idx)``
    first: the loss's cotangent is the first value a backward makes."""

    @staticmethod
    def forward(ctx, probe, idx, loss):
        ctx.probe, ctx.idx = probe, idx
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, ct):
        ctx.probe(ctx.idx)
        return None, None, ct


def wrap_params_for_probe(params, plan: "bucketing.BucketPlan", probe):
    """Measurement twin of ``wrap_params_for_overlap``: the same per-group
    identities, but the backward calls ``probe(group_index)`` the moment
    the group's cotangents exist and passes them on unchanged: the capture
    points of the measured backward profile. No collectives. ``probe`` is
    called on the host in the order the backward queues work; on the card
    it should record a CUDA event on the current stream (what
    ``measure_backward_profile`` does), not read a host clock, which would
    time the launch queue."""
    return _wrap_param_groups(params, plan,
                              lambda gi, group: gi,
                              apply=lambda gi, args: _ProbeIdentity.apply(
                                  probe, gi, *args))


def mark_backward_start(loss, probe, idx: int = -1):
    """Identity on the scalar loss that calls ``probe(idx)`` when the
    backward begins."""
    return _LossProbe.apply(probe, idx, loss)


def mark_forward_start(params, probe, idx: int = -2):
    """Calls ``probe(idx)`` now, where the forward is about to be queued,
    and returns ``params``. Paired with :func:`mark_backward_start`, the
    gap between the two stamps is the measured forward time."""
    if tree_flatten(params):
        probe(idx)
    return params
