"""Structured metrics registry with pluggable sinks (a port of
``repro.obs.metrics``).

* :class:`StdoutSink` — the paper's Appendix-1 ``:::MLPv0.5.0`` line, in
  the JAX package's exact format (``flush=True``); ``where`` names the
  port's module.
* :class:`MemorySink` — in-memory capture for tests and checks.

The JSONL sink, counters and gauges of the observability stack are ROADMAP
§1 item 8.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, List, Optional, Tuple

#: tag-stream version prefix — the paper's Appendix-1 MLPerf log format
MLPERF_VERSION = "MLPv0.5.0"


@dataclasses.dataclass(frozen=True)
class Event:
    """One emitted metric row. ``value`` must be JSON-serializable."""
    name: str
    kind: str = "event"
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
    with ``flush=True``."""

    def emit(self, ev: Event) -> None:
        suffix = "" if ev.value is None else f": {ev.value}"
        print(f":::{MLPERF_VERSION} repro {ev.ts:.9f} ({ev.where}) "
              f"{ev.name}{suffix}", flush=True)


class MemorySink(Sink):
    """Keeps every event in order."""

    def __init__(self):
        self.events: List[Event] = []

    def emit(self, ev: Event) -> None:
        self.events.append(ev)

    def find(self, name: str) -> List[Event]:
        return [e for e in self.events if e.name == name]


class Registry:
    """Fan-out point: every ``event`` call builds one :class:`Event` and
    hands it to every attached sink. Thread-safe."""

    def __init__(self, sinks: Tuple[Sink, ...] = ()):
        self._sinks: List[Sink] = list(sinks)
        self._lock = threading.Lock()

    def add_sink(self, sink: Sink) -> Sink:
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: Sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    @contextlib.contextmanager
    def use_sink(self, sink: Sink):
        """Attach ``sink`` for the scope of the with-block, then detach and
        close it."""
        self.add_sink(sink)
        try:
            yield sink
        finally:
            self.remove_sink(sink)
            sink.close()

    def event(self, name: str, value=None, *, where: str = "repro_torch",
              step: Optional[int] = None) -> Event:
        ev = Event(name=name, kind="event", value=value, ts=time.time(),
                   where=where, step=step)
        with self._lock:
            sinks = tuple(self._sinks)
        for s in sinks:
            s.emit(ev)
        return ev


_DEFAULT = Registry((StdoutSink(),))


def default_registry() -> Registry:
    """The process-wide registry the loop logs through; born with one
    :class:`StdoutSink` so the tag stream is on by default."""
    return _DEFAULT


def event(name: str, value=None, *, where: str = "repro_torch",
          step: Optional[int] = None) -> Event:
    return _DEFAULT.event(name, value, where=where, step=step)
