"""Structured metrics registry with pluggable sinks (a port of
``repro.obs.metrics``).

* :class:`StdoutSink` — the paper's Appendix-1 ``:::MLPv0.5.0`` line, in
  the JAX package's exact format (``flush=True``); ``where`` names the
  port's module.
* :class:`JsonlSink` — one JSON object per line, flushed per event (the
  ``launch.train --metrics out.jsonl`` artifact).
* :class:`MemorySink` — in-memory capture for tests and checks.

Three event kinds: ``event`` (a tagged occurrence with an optional value:
the MLPerf tag stream), ``counter`` (the emitted value is the running
total, e.g. ``obs.guard.skip_total``) and ``gauge`` (a point-in-time
measurement, e.g. ``obs.guard.gnorm``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, List, Optional, Tuple

#: tag-stream version prefix — the paper's Appendix-1 MLPerf log format
MLPERF_VERSION = "MLPv0.5.0"

KINDS = ("event", "counter", "gauge")


@dataclasses.dataclass(frozen=True)
class Event:
    """One emitted metric row. ``value`` must be JSON-serializable."""
    name: str
    kind: str = "event"             # one of KINDS
    value: Any = None
    ts: float = 0.0                 # unix seconds (time.time)
    where: str = "repro_torch"      # source tag
    step: Optional[int] = None


class Sink:
    """Sink interface: receives every :class:`Event` the registry emits."""

    def emit(self, ev: Event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StdoutSink(Sink):
    """``:::MLPv0.5.0 repro <ts:.9f> (<where>) <tag>[: <value>]``, printed
    with ``flush=True`` (unbuffered even under a SIGKILL fault)."""

    def emit(self, ev: Event) -> None:
        suffix = "" if ev.value is None else f": {ev.value}"
        print(f":::{MLPERF_VERSION} repro {ev.ts:.9f} ({ev.where}) "
              f"{ev.name}{suffix}", flush=True)


class JsonlSink(Sink):
    """One JSON object per line, flushed per event, so a killed process
    keeps every fully written row. Closed by ``Registry.remove_sink``."""

    def __init__(self, path: str):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)   # line-buffered
        self._lock = threading.Lock()

    def emit(self, ev: Event) -> None:
        row = {"name": ev.name, "kind": ev.kind, "value": ev.value,
               "ts": ev.ts, "where": ev.where}
        if ev.step is not None:
            row["step"] = ev.step
        line = json.dumps(row, sort_keys=True, default=str)
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class MemorySink(Sink):
    """Keeps every event in order."""

    def __init__(self):
        self.events: List[Event] = []

    def emit(self, ev: Event) -> None:
        self.events.append(ev)

    def find(self, name: str) -> List[Event]:
        return [e for e in self.events if e.name == name]


class Registry:
    """Fan-out point: every ``event``/``counter``/``gauge`` call builds one
    :class:`Event` and hands it to every attached sink. Thread-safe: the
    watchdog's worker thread and the SIGTERM handler log through it."""

    def __init__(self, sinks: Tuple[Sink, ...] = ()):
        self._sinks: List[Sink] = list(sinks)
        self._counters = {}
        self._lock = threading.Lock()

    def add_sink(self, sink: Sink) -> Sink:
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: Sink) -> None:
        """Detach ``sink`` and close it."""
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
        sink.close()

    @contextlib.contextmanager
    def use_sink(self, sink: Sink):
        """Attach ``sink`` for the scope of the with-block, then detach and
        close it."""
        self.add_sink(sink)
        try:
            yield sink
        finally:
            self.remove_sink(sink)

    def _emit(self, name: str, kind: str, value, where: str,
              step: Optional[int]) -> Event:
        ev = Event(name=name, kind=kind, value=value, ts=time.time(),
                   where=where, step=step)
        with self._lock:
            sinks = tuple(self._sinks)
        for s in sinks:
            s.emit(ev)
        return ev

    def event(self, name: str, value=None, *, where: str = "repro_torch",
              step: Optional[int] = None) -> Event:
        return self._emit(name, "event", value, where, step)

    def counter(self, name: str, inc: int = 1, *, where: str = "repro_torch",
                step: Optional[int] = None) -> int:
        """Accumulate and emit the running total (the emitted value)."""
        with self._lock:
            total = self._counters.get(name, 0) + inc
            self._counters[name] = total
        self._emit(name, "counter", total, where, step)
        return total

    def gauge(self, name: str, value: float, *, where: str = "repro_torch",
              step: Optional[int] = None) -> Event:
        return self._emit(name, "gauge", value, where, step)


_DEFAULT = Registry((StdoutSink(),))


def default_registry() -> Registry:
    """The process-wide registry the loop, the faults and the launcher log
    through; born with one :class:`StdoutSink` so the tag stream is on by
    default."""
    return _DEFAULT


def event(name: str, value=None, *, where: str = "repro_torch",
          step: Optional[int] = None) -> Event:
    return _DEFAULT.event(name, value, where=where, step=step)


def counter(name: str, inc: int = 1, *, where: str = "repro_torch",
            step: Optional[int] = None) -> int:
    return _DEFAULT.counter(name, inc, where=where, step=step)


def gauge(name: str, value: float, *, where: str = "repro_torch",
          step: Optional[int] = None) -> Event:
    return _DEFAULT.gauge(name, value, where=where, step=step)
