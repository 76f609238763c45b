"""Alpha-beta wall-time models of the collective schedules (a port of
``repro.comm.cost``, the same names and arithmetic).

Each message on a link costs ``alpha + bytes / bw`` (latency + serialized
payload); a schedule is a serialized sequence of phases, each a set of
messages on one link class. The constants are the card's, measured
(``launch/hw.py``): every function that reads one takes it through
``links=`` (the per-axis links) or ``hw=`` (a ``launch.hw.Hardware``:
HBM bytes/s), defaulting to ``launch.hw.H100``. On one host the ``pod``
axis rides the same NVLink as ``data``; a slower inter-host link, which
is where hierarchical and 2d_torus win, is not measured here.

Bucketing multiplies the per-phase message count by ``n_buckets`` (alpha
term) while the total wire bytes are unchanged: the paper §III-C.1
trade-off (fewer messages against overlap granularity) made predictable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.launch import hw as hw_mod


@dataclasses.dataclass(frozen=True)
class Link:
    alpha: float            # per-message latency, seconds
    bw: float               # bytes/second per device


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    messages: int           # serialized messages per bucket
    wire_bytes: float       # bytes per device per bucket
    link: Link

    def time_s(self, n_buckets: int) -> float:
        return n_buckets * (self.messages * self.link.alpha
                            + self.wire_bytes / self.link.bw)


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    schedule: str
    time_s: float
    n_messages: int         # total messages (all buckets)
    wire_bytes: float       # total bytes/device on the wire
    phases: Tuple[Phase, ...]


def default_links(axes: Sequence[str],
                  hw: Optional[hw_mod.Hardware] = None) -> Dict[str, Link]:
    """Per axis, its link: ``pod`` the inter-pod one, every other axis the
    card-to-card one, from ``hw`` (default ``launch.hw.H100``)."""
    hw = hw or hw_mod.H100
    return {a: (Link(hw.pod_alpha, hw.pod_bw) if a == "pod"
                else Link(hw.link_alpha, hw.link_bw)) for a in axes}


def _slowest(links: Sequence[Link]) -> Link:
    return min(links, key=lambda l: l.bw)


def predict(schedule: str, axes: Sequence[str], sizes: Sequence[int],
            payload_bytes: float, *, n_buckets: int = 1,
            links: Optional[Dict[str, Link]] = None) -> CostBreakdown:
    """Predicted wall time of one all-reduce of ``payload_bytes`` (total,
    pre-bucketing) over mesh axes ``axes`` with per-axis ``sizes``."""
    assert len(axes) == len(sizes)
    links = links or default_links(axes)
    B = payload_bytes / n_buckets            # per-bucket payload
    ph = []

    def ring_ar(tag, bytes_in, n, link):
        if n > 1:
            ph.append(Phase(f"ring-ar[{tag}]", 2 * (n - 1),
                            2 * bytes_in * (n - 1) / n, link))

    if schedule in ("psum", "bucketed"):
        d = 1
        for s in sizes:
            d *= s
        if d > 1:
            ring_ar("fused", B, d, _slowest([links[a] for a in axes]))
    elif schedule == "ring":
        for a, n in zip(reversed(axes), reversed(sizes)):
            ring_ar(a, B, n, links[a])
    elif schedule == "dbtree":
        # two mirrored binomial trees, each carrying B/2: the critical path
        # is ceil(log2 n) levels of one B/2 message up (reduce) and the
        # same back down (broadcast) — alpha scales with log n, not n
        for a, n in zip(reversed(axes), reversed(sizes)):
            if n > 1:
                depth = (n - 1).bit_length()
                ph.append(Phase(f"tree-reduce[{a}]", depth,
                                depth * B / 2, links[a]))
                ph.append(Phase(f"tree-bcast[{a}]", depth,
                                depth * B / 2, links[a]))
    elif schedule in ("hierarchical", "2d_torus"):
        # scatter axis: innermost non-trivial (schedules.shard_axis) — a
        # trailing size-1 axis must not collapse the hierarchy
        intra, n = shard_axis_size(axes, sizes)
        shard = B / max(n, 1)
        if n > 1:
            ph.append(Phase(f"ring-rs[{intra}]", n - 1,
                            B * (n - 1) / n, links[intra]))
        outer = [(a, s) for a, s in zip(axes, sizes) if a != intra]
        if schedule == "hierarchical":
            p = 1
            for _, s in outer:
                p *= s
            if p > 1:
                ring_ar("pods-fused", shard, p,
                        _slowest([links[a] for a, _ in outer]))
        else:
            for a, s in reversed(outer):
                ring_ar(a, shard, s, links[a])
        if n > 1:
            ph.append(Phase(f"ring-ag[{intra}]", n - 1,
                            B * (n - 1) / n, links[intra]))
    else:
        raise KeyError(f"no cost model for schedule {schedule!r}")

    return CostBreakdown(
        schedule=schedule,
        time_s=sum(p.time_s(n_buckets) for p in ph),
        n_messages=sum(p.messages for p in ph) * n_buckets,
        wire_bytes=sum(p.wire_bytes for p in ph) * n_buckets,
        phases=tuple(ph),
    )


# --------------------------------------------------------------------------
# ZeRO-1 sharded-update accounting: RS(g) + AG(p) vs AR(g)  (docs/comm.md)

def shard_axis_size(axes: Sequence[str], sizes: Sequence[int]):
    """(axis, size) the sharded-update path scatters over: the innermost
    non-trivial axis — mirrors ``schedules.shard_axis``."""
    for a, s in zip(reversed(tuple(axes)), reversed(tuple(sizes))):
        if s > 1:
            return a, s
    return tuple(axes)[-1], tuple(sizes)[-1]


def predict_reduce_scatter(schedule: str, axes: Sequence[str],
                           sizes: Sequence[int], payload_bytes: float, *,
                           n_buckets: int = 1,
                           links: Optional[Dict[str, Link]] = None) -> CostBreakdown:
    """Predicted wall time of the schedule's reduce-scatter-terminal form
    (``registry.get_reduce_scatter``): ring/2d_torus/hierarchical stop at
    their native scatter (half the shard-axis wire bytes of the full
    all-reduce); psum/dbtree reduce-then-slice, so their cost equals the
    full all-reduce — the slice is free."""
    assert len(axes) == len(sizes)
    links = links or default_links(axes)
    if schedule in ("psum", "bucketed", "dbtree"):
        r = predict(schedule, axes, sizes, payload_bytes,
                    n_buckets=n_buckets, links=links)
        return dataclasses.replace(r, schedule=f"{r.schedule}+slice")
    if schedule not in ("ring", "hierarchical", "2d_torus"):
        raise KeyError(f"no reduce-scatter cost model for {schedule!r}")
    B = payload_bytes / n_buckets
    intra, n = shard_axis_size(axes, sizes)
    shard = B / max(n, 1)
    ph = []
    if n > 1:
        ph.append(Phase(f"ring-rs[{intra}]", n - 1, B * (n - 1) / n,
                        links[intra]))
    outer = [(a, s) for a, s in zip(axes, sizes) if a != intra and s > 1]
    if schedule == "hierarchical":
        p = 1
        for _, s in outer:
            p *= s
        if p > 1:
            ph.append(Phase("ring-ar[pods-fused]", 2 * (p - 1),
                            2 * shard * (p - 1) / p,
                            _slowest([links[a] for a, _ in outer])))
    else:   # ring / 2d_torus: explicit shard ring per remaining axis
        for a, s in reversed(outer):
            ph.append(Phase(f"ring-ar[{a}]", 2 * (s - 1),
                            2 * shard * (s - 1) / s, links[a]))
    return CostBreakdown(
        schedule=f"{schedule}-rs",
        time_s=sum(p.time_s(n_buckets) for p in ph),
        n_messages=sum(p.messages for p in ph) * n_buckets,
        wire_bytes=sum(p.wire_bytes for p in ph) * n_buckets,
        phases=tuple(ph),
    )


def predict_all_gather(axes: Sequence[str], sizes: Sequence[int],
                       payload_bytes: float, *, n_buckets: int = 1,
                       links: Optional[Dict[str, Link]] = None) -> CostBreakdown:
    """Ring all-gather of ``payload_bytes`` (the full buffer size, e.g. the
    bf16 params) along the shard axis — the gather phase every sharded
    update pays, regardless of which schedule ran the scatter. Shards are
    already identical across the other axes, so only the shard-axis ring
    moves bytes. Where this lands on the step timeline is the gather_ahead
    knob: issued at the start of the next forward
    (``ddp.gather_ahead_params``) it hides behind forward compute, issued
    at step end it is fully exposed — ``autotune.simulate`` prices both."""
    links = links or default_links(axes)
    intra, n = shard_axis_size(axes, sizes)
    ph = []
    if n > 1:
        ph.append(Phase(f"ring-ag[{intra}]", n - 1,
                        payload_bytes / n_buckets * (n - 1) / n,
                        links[intra]))
    return CostBreakdown(
        schedule="all-gather",
        time_s=sum(p.time_s(n_buckets) for p in ph),
        n_messages=sum(p.messages for p in ph) * n_buckets,
        wire_bytes=sum(p.wire_bytes for p in ph) * n_buckets,
        phases=tuple(ph),
    )


def lars_update_time_s(n_elems: int, n_shards: int = 1, *,
                       hw: Optional[hw_mod.Hardware] = None) -> float:
    """Memory-bound model of the packed fp32 optimizer step: read p/g/m +
    write p/m = 5 fp32 streams over this device's 1/n_shards slice at HBM
    bandwidth (``hw.hbm_bw``). The n_shards=1 case prices the replicated
    update every device redundantly runs on the all-reduce path."""
    hw = hw or hw_mod.H100
    return 5 * 4 * (n_elems / max(n_shards, 1)) / hw.hbm_bw


@dataclasses.dataclass(frozen=True)
class ParamMemory:
    """Analytic peak *extra* param bytes beyond the persistent fp32 shard
    state every sharded policy keeps (optimizer params + momentum, 1/n
    each). 'Extra' is what the sharding level actually changes:

    * replicated — the full fp32 replica IS the state; extra = 0 by
      construction here (it pays 4N persistently instead of 8N/n).
    * zero1 — a persistent full fp32 forward/backward replica (4N) held
      across the step, plus the full wire-dtype gather image at the
      gather-ahead moment (``all_gather_params`` keeps every bucket buffer
      live until the single tree unpack): wire_bytes x the SHARD-PADDED
      bucket elems (each bucket zero-pads to ``n_shards x shard_elems``
      before it rides the ring — a ragged bucket really allocates the
      padded image, which the pre-fix accounting under-counted).
    * zero2 — the replicated fp32 params are themselves the masters (4N
      persistent, never quantized), plus the step-end fp32 all-gather
      image (4 x padded elems): gradients + optimizer state live 1/n but
      the forward keeps full params — no re-gather in the forward.
    * zero3 — no replica: at the peak instant only one group is in flight
      (its wire-dtype bucket buffer plus its unpacked fp32 span pieces),
      freed before the next group's compute retires — O(largest bucket
      group), not O(N), with leaf splitting capping the group term near
      the bucket budget. Assumes span-streaming consumers; an
      assembled-tensor consumer retains a split leaf's earlier spans
      until it is whole (``param_memory(streaming_spans=False)``).
    """
    sharding: str
    persistent_bytes: int   # full-replica bytes held across the step
    transient_bytes: int    # gather scratch live at the peak instant

    @property
    def peak_bytes(self) -> int:
        return self.persistent_bytes + self.transient_bytes


def padded_bucket_elems(plan, n_shards: int):
    """Per-bucket elems of the SHARDED wire layout: each bucket zero-pads
    to ``n_shards * bucketing.shard_elems`` (CHUNK-aligned per shard)
    before the scatter/gather rings run — the buffer that is actually
    allocated, strictly >= ``plan.bucket_sizes`` on ragged layouts."""
    from repro_torch.core import bucketing
    n = max(int(n_shards), 1)
    return tuple(n * bucketing.shard_elems(int(b), n)
                 for b in plan.bucket_sizes)


def _zero3_live_elems(plan, *, streaming_spans: bool = True):
    """Per-bucket fp32 param elems live at that bucket's gather.

    ``streaming_spans=True`` (the accounting default): a split tensor's
    span pieces are consumed with their group and freed, so live[b] is
    exactly ``plan.group_elems[b]`` — the bound leaf splitting exists to
    deliver, and the one the (n-1)/n CI bar is held against. It is
    attainable when split tensors are consumed slice-wise in gather
    order — the stacked-layer transformer leaves the bar targets, where
    a scan reads one layer slice per step and never needs the whole
    stack resident.

    ``streaming_spans=False`` prices the assembled-tensor consumer
    (``ddp.jit_gather_params`` assembles span pieces into the full
    leaf before the layer reads it): when bucket b's group materializes,
    a split tensor continuing into b has its higher-bucket spans already
    gathered — the forward walks groups in reverse packing order — and
    every piece persists until the tensor is whole, so the peak cannot
    drop below 4 bytes x the widest leaf no matter the bucket budget.

    Both forms reduce to ``plan.group_elems`` on unsplit plans."""
    live = [int(g) for g in plan.group_elems]
    if streaming_spans:
        return tuple(live)
    for spans in getattr(plan, "tensor_slots", ()):
        if len(spans) < 2:
            continue
        # spans ordered by ascending bucket; gather order is descending
        suffix = 0
        for s in reversed(spans):
            live[s.bucket] += suffix
            suffix += s.size
    return tuple(live)


def param_memory(plan, n_shards: int, *, sharding: str,
                 wire_dtype_bytes: int = 2,
                 streaming_spans: bool = True) -> ParamMemory:
    """Peak extra param bytes for one sharding level under the committed
    ``BucketPlan``. ``plan`` needs ``bucket_sizes``/``group_elems``
    (padded wire elems / unpadded group elems). The ZeRO-3 bound is the
    tentpole claim: O(N) -> O(N/n) + O(largest bucket group) — leaf
    splitting caps the group term near the bucket budget.
    ``streaming_spans=False`` switches the ZeRO-3 bound to the
    assembled-tensor consumer (see ``_zero3_live_elems``): split leaves
    then retain their earlier spans and the floor is the widest leaf."""
    if sharding == "replicated":
        return ParamMemory("replicated", 0, 0)
    padded = padded_bucket_elems(plan, n_shards)
    n_unpadded = int(sum(plan.group_elems))
    if sharding == "zero1":
        return ParamMemory("zero1", 4 * n_unpadded,
                           wire_dtype_bytes * int(sum(padded)))
    if sharding == "zero2":
        # fp32 on the step-end gather wire: the replicated params ARE the
        # masters and must stay exact (docs/comm.md §ZeRO-2)
        return ParamMemory("zero2", 4 * n_unpadded, 4 * int(sum(padded)))
    assert sharding == "zero3", sharding
    live = _zero3_live_elems(plan, streaming_spans=streaming_spans)
    peak = max((wire_dtype_bytes * b + 4 * g
                for b, g in zip(padded, live)),
               default=0)
    return ParamMemory("zero3", 0, int(peak))


def param_memory_reduction(plan, n_shards: int, *,
                           wire_dtype_bytes: int = 2,
                           sharding: str = "zero3") -> float:
    """Fractional peak-param-memory reduction of ``sharding`` vs zero1 —
    the CI-asserted row. The acceptance bar it is held against is (n-1)/n:
    at the equivalence-matrix shard count (n=8) on resnet50, and — with
    leaf splitting — at n=16 on the stacked-leaf transformer configs
    (``comm.zero3_param_mem_split``). ~0.91 for ResNet-50 at
    bucket_mb=1.0 with a bf16 wire."""
    z1 = param_memory(plan, n_shards, sharding="zero1",
                      wire_dtype_bytes=wire_dtype_bytes).peak_bytes
    zx = param_memory(plan, n_shards, sharding=sharding,
                      wire_dtype_bytes=wire_dtype_bytes).peak_bytes
    return 1.0 - zx / z1 if z1 else 0.0


def predict_table(axes: Sequence[str], sizes: Sequence[int],
                  payload_bytes: float, *, n_buckets: int = 1,
                  links: Optional[Dict[str, Link]] = None):
    """One CostBreakdown per registered schedule, fastest first. A schedule
    registered without a cost model here is skipped (it still trains)."""
    from repro_torch.comm.registry import available
    rows = []
    for s in available():
        try:
            rows.append(predict(s, axes, sizes, payload_bytes,
                                n_buckets=n_buckets, links=links))
        except KeyError:
            pass
    return sorted(rows, key=lambda r: r.time_s)
