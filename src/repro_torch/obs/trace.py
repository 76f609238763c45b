"""Step-timeline tracer (a port of ``repro.obs.trace``): spans of the
step's phases and of each bucket's collective, stamped in the order the
host queues work.

* :func:`mark` stamps one begin or end of a span. On the card it records a
  ``torch.cuda.Event(enable_timing=True)`` on the current stream, so the
  stamp is the moment the device reaches that point of the queue; on the
  CPU it takes a ``time.perf_counter`` stamp (the work before it has run).
  ``tracer=None`` is a no-op that records nothing. The train step plants
  ``forward``, ``backward`` and ``update``; ``core/ddp.py`` plants
  ``ar[b<i>]``, ``rs[b<i>]`` and ``ag[b<i>]`` per bucket and ``ag[g<i>]``
  per group under zero3, as the reference's probes are named.
* :class:`Tracer` collects the stamps. The training loop owns the step
  windows: ``begin_step()`` before the step, ``end_step(step)`` after it.
  ``end_step`` synchronises the card and turns each event into a host time
  through ``elapsed_time`` from the window's begin event, so every span
  lies inside its step window; each (name, cat) becomes one span
  [min(begin), max(end)]. Stamps left by an abandoned step (the watchdog's
  worker thread runs on) are dropped at the next ``begin_step``.
* ``host_span`` and ``instant`` record host work outside the step
  (checkpoint commits, watchdog and guard events).

Export: :func:`chrome_trace` / :func:`export_chrome` write the Chrome
Trace Event JSON (``chrome://tracing`` / Perfetto: ``ph: "X"`` events in
microseconds); :func:`spans_from_chrome` reads it back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: span category -> Chrome-trace tid (one named row per category)
CATEGORY_TIDS = {"step": 0, "compute": 1, "comm": 2, "host": 3}


@dataclasses.dataclass(frozen=True)
class Span:
    """One assembled timeline span. Times are ``time.perf_counter``
    seconds; ``step=-1`` marks host events outside any step window."""
    name: str
    cat: str                 # 'step' | 'compute' | 'comm' | 'host'
    t0: float
    t1: float
    step: int = -1
    args: Tuple[Tuple[str, object], ...] = ()

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    def arg(self, key: str, default=None):
        return dict(self.args).get(key, default)


class Tracer:
    """Collects stamps and assembles them into per-step spans.
    Thread-safe: the watchdog's worker thread runs the step."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        # (name, cat, phase, stamp, args); stamp: host seconds or an event
        self._pending: List[tuple] = []
        self._begin: Optional[Tuple[float, object]] = None
        #: (step, spans) per traced step, in completion order
        self.steps: List[Tuple[int, Tuple[Span, ...]]] = []
        #: host-side spans and instants outside the step windows
        self.extra: List[Span] = []

    def stamp(self, name: str, phase: str, device=None, *, cat: str = "comm",
              **args) -> None:
        """Record one begin (``'B'``) or end (``'E'``) of span ``name``:
        an event on ``device``'s current stream for a CUDA device, else the
        host clock."""
        if device is not None and device.type == "cuda":
            import torch
            t = torch.cuda.Event(enable_timing=True)
            t.record(torch.cuda.current_stream(device))
        else:
            t = self._clock()
        with self._lock:
            self._pending.append((name, cat, phase, t,
                                  tuple(sorted(args.items()))))

    # ------------------------------------------------------ step windows

    def begin_step(self) -> None:
        """Open a step window. The host time is read before the begin
        event is recorded, on an idle card, so no event maps before it."""
        t0, ev = self._clock(), None
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        with self._lock:
            self._pending = []
            self._begin = (t0, ev)

    def end_step(self, step: int) -> None:
        """Close the window: synchronise the card, map the window's events
        to host times, fold them into spans, file them under ``step``."""
        import torch
        with self._lock:
            begin, self._begin = self._begin, None
            evs, self._pending = self._pending, []
        if begin is None:
            return
        t0, ev0 = begin
        if ev0 is not None:
            torch.cuda.synchronize()
        t1 = self._clock()
        rows = [("step", "step", "B", t0, ()), ("step", "step", "E", t1, ())]
        for name, cat, phase, t, args in evs:
            if not isinstance(t, (int, float)):
                if ev0 is None:          # an event outside a card window
                    continue
                t = t0 + ev0.elapsed_time(t) / 1e3
            rows.append((name, cat, phase, t, args))
        self.steps.append((int(step), _assemble(rows, int(step))))

    def abort_step(self) -> None:
        """Discard the open window (watchdog timeout: the step's stamps are
        meaningless and may still trickle in from the abandoned step)."""
        with self._lock:
            self._pending = []
            self._begin = None

    # --------------------------------------------------------- host-side

    def instant(self, name: str, *, cat: str = "host",
                step: Optional[int] = None, **args) -> None:
        """Zero-duration host event (watchdog timeout/restore, guard
        recovery, preemption), a tick on the host row."""
        t = self._clock()
        with self._lock:
            self.extra.append(Span(name, cat, t, t,
                                   -1 if step is None else int(step),
                                   tuple(sorted(args.items()))))

    @contextlib.contextmanager
    def host_span(self, name: str, *, cat: str = "host",
                  step: Optional[int] = None, **args):
        """Wall-clock span around host work (a checkpoint commit)."""
        t0 = self._clock()
        try:
            yield
        finally:
            with self._lock:
                self.extra.append(Span(name, cat, t0, self._clock(),
                                       -1 if step is None else int(step),
                                       tuple(sorted(args.items()))))

    # ----------------------------------------------------------- queries

    def spans(self, step: Optional[int] = None) -> Tuple[Span, ...]:
        """All assembled spans (steps + extra), optionally one step's."""
        out: List[Span] = []
        for s, spans in self.steps:
            if step is None or s == step:
                out.extend(spans)
        out.extend(e for e in self.extra
                   if step is None or e.step == step)
        return tuple(sorted(out, key=lambda sp: (sp.t0, sp.name)))


def _assemble(evs, step: int) -> Tuple[Span, ...]:
    """Stamps -> spans: per (name, cat), [min(B), max(E)]. A name with only
    begins (or only ends) still yields a zero-width span rather than
    vanishing."""
    groups: Dict[Tuple[str, str], Dict[str, list]] = {}
    for name, cat, phase, t, args in evs:
        g = groups.setdefault((name, cat), {"B": [], "E": [], "args": args})
        g[phase].append(t)
        if args:
            g["args"] = args
    spans = []
    for (name, cat), g in groups.items():
        t0 = min(g["B"]) if g["B"] else min(g["E"])
        t1 = max(g["E"]) if g["E"] else max(g["B"])
        spans.append(Span(name, cat, t0, max(t0, t1), step, g["args"]))
    return tuple(sorted(spans, key=lambda sp: (sp.t0, sp.name)))


# --------------------------------------------------------------- probes

def mark(tracer: Optional[Tracer], name: str, phase: str, deps: Sequence,
         *, cat: str = "comm", **args) -> None:
    """Stamp one phase of span ``name`` at this point of the queue, on the
    device of the first tensor in ``deps`` (the reference's probe
    dependencies; here they only choose the device). No-op when
    ``tracer`` is None."""
    if tracer is None:
        return
    device = next((d.device for d in deps if hasattr(d, "device")), None)
    tracer.stamp(name, phase, device, cat=cat, **args)


def span_deps(tracer: Optional[Tracer], name: str, begin_deps, end_deps,
              *, cat: str = "comm", **args) -> None:
    """Begin + end stamps in one call (both phases share name/cat/args)."""
    mark(tracer, name, "B", begin_deps, cat=cat, **args)
    mark(tracer, name, "E", end_deps, cat=cat, **args)


# ------------------------------------------------------- Chrome export

def chrome_trace(tracer: Tracer) -> dict:
    """Chrome Trace Event Format object: one ``ph:"X"`` complete event per
    span (microseconds), per-category named rows via thread_name
    metadata."""
    events = []
    for cat, tid in sorted(CATEGORY_TIDS.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": cat}})
    for span in tracer.spans():
        events.append({
            "name": span.name, "cat": span.cat, "ph": "X",
            "ts": span.t0 * 1e6, "dur": span.dur_s * 1e6,
            "pid": 0, "tid": CATEGORY_TIDS.get(span.cat, 9),
            "args": {"step": span.step, **dict(span.args)},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome(tracer: Tracer, path: str) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f, indent=1)
    return path


def validate_chrome(obj: dict) -> None:
    """Schema floor for the export: raises ``ValueError`` on anything
    chrome://tracing would choke on."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    if not isinstance(obj["traceEvents"], list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for k in ("ph", "name", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"traceEvents[{i}] missing {k!r}")
        if ev["ph"] == "X":
            for k in ("ts", "dur"):
                if not isinstance(ev.get(k), (int, float)):
                    raise ValueError(
                        f"traceEvents[{i}].{k} must be a number")
            if ev["dur"] < 0:
                raise ValueError(f"traceEvents[{i}].dur is negative")


def load_chrome(path: str) -> dict:
    with open(path) as f:
        obj = json.load(f)
    validate_chrome(obj)
    return obj


def spans_from_chrome(obj: dict) -> Tuple[Span, ...]:
    """Rebuild :class:`Span` records from an exported trace."""
    spans = []
    for ev in obj["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        step = int(args.pop("step", -1))
        spans.append(Span(ev["name"], ev.get("cat", "host"),
                          ev["ts"] / 1e6, (ev["ts"] + ev["dur"]) / 1e6,
                          step, tuple(sorted(args.items()))))
    return tuple(sorted(spans, key=lambda sp: (sp.step, sp.t0, sp.name)))
