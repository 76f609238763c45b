"""Predicted-vs-measured drift monitor (a port of ``repro.obs.drift``).

The comm layer *predicts* every bucket collective's wall time
(``comm/cost.py``, with the card's measured constants, ``launch/hw.py``)
and, with an ``obs.trace.Tracer`` attached, *measures* the same spans per
step (CUDA events on the card). This module closes the loop: for each
traced bucket span (``rs[bi]``/``ar[bi]``/``ag[bi]``/``ag[gi]``) it looks
up the ``CommPlan``'s predicted duration and scores the relative error,
per bucket and aggregated per schedule, then emits the result as
``obs.drift.*`` metric rows.

Semantics of the number: ``rel_err = measured/predicted - 1`` per span;
the per-schedule aggregate is ``sum(measured)/sum(predicted) - 1`` over
the bucket comm spans (volume-weighted, so one tiny-bucket outlier can't
dominate). A span measures from the moment its collective is queued to
the moment it is done on the card, so a span that waits behind the
backward's compute (the stacked LM leaves whose gradients all complete at
the end of the backward) reads longer than its wire time: the row is a
trend, not a duration match.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.comm import cost
from repro_torch.comm.plan import CommPlan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import Span, Tracer

#: span-name prefixes the monitor scores (the bucket comm spans)
COMM_KINDS = ("rs", "ar", "ag")


@dataclasses.dataclass(frozen=True)
class Drift:
    """One span's predicted-vs-measured comparison."""
    name: str                # span name, e.g. 'rs[b0]'
    kind: str                # 'rs' | 'ar' | 'ag'
    predicted_s: float
    measured_s: float

    @property
    def rel_err(self) -> float:
        if self.predicted_s <= 0:
            return float("inf") if self.measured_s > 0 else 0.0
        return self.measured_s / self.predicted_s - 1.0


def predicted_span_times(plan: CommPlan, *,
                         links: Optional[Dict[str, cost.Link]] = None
                         ) -> Dict[str, float]:
    """The CommPlan's predicted per-bucket comm-span durations, keyed by
    the tracer's span names. ``sharding='zero1'`` plans predict the
    RS-terminal form per bucket plus the step-boundary param all-gather
    (``ag[bi]``, param bytes on the wire dtype); ``sharding='zero3'``
    predicts the same RS plus the just-in-time per-GROUP forward gather
    (``ag[gi]`` — with ``gather='per_group'`` the remat re-gather fires
    the same span name in the backward, so its measured [min B, max E]
    window covers both passes and the row is a trend, not a duration
    match); replicated plans predict the full all-reduce (``ar[bi]``).
    Exactly the spans ``core/ddp.py`` plants."""
    out: Dict[str, float] = {}
    axes, sizes = plan.mesh_axes, plan.mesh_sizes
    for b, elems in enumerate(plan.bucket_sizes):
        payload = elems * plan.wire_dtype_bytes
        if plan.sharding == "zero3":
            out[f"rs[b{b}]"] = cost.predict_reduce_scatter(
                plan.schedule, axes, sizes, payload, links=links).time_s
            out[f"ag[g{b}]"] = cost.predict_all_gather(
                axes, sizes, payload, links=links).time_s
        elif plan.shard_update:
            out[f"rs[b{b}]"] = cost.predict_reduce_scatter(
                plan.schedule, axes, sizes, payload, links=links).time_s
            out[f"ag[b{b}]"] = cost.predict_all_gather(
                axes, sizes, payload, links=links).time_s
        else:
            out[f"ar[b{b}]"] = cost.predict(
                plan.schedule, axes, sizes, payload, links=links).time_s
    return out


def span_kind(name: str) -> Optional[str]:
    for k in COMM_KINDS:
        if name.startswith(f"{k}["):
            return k
    return None


def measured_span_times(source, *, skip_steps: int = 1
                        ) -> Dict[str, float]:
    """Median measured duration per span name across the traced steps.
    ``source`` is a :class:`Tracer`, an iterable of :class:`Span`, or an
    already-reduced ``{span_name: seconds}`` dict (a cross-process form).
    ``skip_steps`` drops the first traced steps (the warm-up: allocator
    growth and first-call costs, not the timeline)."""
    if isinstance(source, dict):
        return {n: float(s) for n, s in sorted(source.items())
                if span_kind(n) is not None}
    if isinstance(source, Tracer):
        spans: Iterable[Span] = source.spans()
    else:
        spans = tuple(source)
    steps = sorted({s.step for s in spans if s.step >= 0})
    keep = set(steps[skip_steps:]) if len(steps) > skip_steps else set(steps)
    by_name: Dict[str, list] = {}
    for s in spans:
        if s.step in keep and span_kind(s.name) is not None:
            by_name.setdefault(s.name, []).append(s.dur_s)
    return {n: float(np.median(ds)) for n, ds in sorted(by_name.items())}


def compute(source, plan: CommPlan, *,
            links: Optional[Dict[str, cost.Link]] = None,
            skip_steps: int = 1) -> Tuple[Drift, ...]:
    """Score every traced bucket comm span against the plan's prediction.
    Spans the plan doesn't predict (or predicted spans never traced —
    e.g. ``ag`` with gather-ahead off and zero steps) are skipped, not
    errors."""
    predicted = predicted_span_times(plan, links=links)
    measured = measured_span_times(source, skip_steps=skip_steps)
    out = []
    for name, meas in measured.items():
        if name in predicted:
            out.append(Drift(name=name, kind=span_kind(name),
                             predicted_s=predicted[name], measured_s=meas))
    return tuple(out)


def aggregate(drifts: Iterable[Drift]) -> float:
    """Volume-weighted per-schedule relative error:
    ``sum(measured)/sum(predicted) - 1`` over the bucket comm spans."""
    drifts = tuple(drifts)
    pred = sum(d.predicted_s for d in drifts)
    meas = sum(d.measured_s for d in drifts)
    if pred <= 0:
        return float("inf") if meas > 0 else 0.0
    return meas / pred - 1.0


def emit(drifts: Iterable[Drift], plan: CommPlan, *,
         registry: Optional[obs_metrics.Registry] = None) -> float:
    """Publish the drift rows: one ``obs.drift.span`` event per scored
    span and one ``obs.drift.<schedule>.rel_err`` gauge with the
    aggregate. Returns the aggregate."""
    reg = registry or obs_metrics.default_registry()
    where = "repro_torch/obs/drift.py"
    drifts = tuple(drifts)
    for d in drifts:
        reg.event("obs.drift.span",
                  {"span": d.name, "kind": d.kind,
                   "predicted_us": round(d.predicted_s * 1e6, 3),
                   "measured_us": round(d.measured_s * 1e6, 3),
                   "rel_err": round(d.rel_err, 4),
                   "schedule": plan.schedule}, where=where)
    agg = aggregate(drifts)
    reg.gauge(f"obs.drift.{plan.schedule}.rel_err", round(agg, 4),
              where=where)
    return agg
