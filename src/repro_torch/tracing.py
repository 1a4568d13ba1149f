"""Spans and counters of the program's own layers, kept in memory.

    from repro_torch import tracing

    tracing.enable()
    ...                                  # prune, count, serve
    snap = tracing.snapshot(reset=True)  # {"spans", "counters", "clock"}
    tracing.disable()

Off (the default), `span()` and `read()` are one module-level bool check
that returns the shared no-op `OFF`: no clock read, no profiler range,
nothing kept. On, a span keeps (name, start_ns, end_ns, span_id,
parent_id, trace_id, attrs) and opens a `torch.profiler.record_function`
range of the same name.

Stamps are Unix-epoch ns, the clock the profiler stamps its events with:
`perf_counter_ns()` plus an offset that `enable()` takes once. A span
opened with none open is a root and starts a trace ("<name>/<span_id>");
the spans inside it carry its trace id. `read(site)` wraps one existing
device-to-host read: a `host.read` span with attribute `site`, counted on
`host.read/<site>`. The recorder adds no sync and no read of its own; it
serves the program's one host thread.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional

import torch

# every span name the program emits
NAMES = (
    "pipeline.prune", "prune.lcc", "prune.nlcc", "prune.tds", "lcc.sweep",
    "host.read", "tds.join", "count.join",
    "batch.init", "batch.lcc", "batch.nlcc", "batch.tds",
    "serve.queue", "serve.batch", "engine.stage",
)
READ = "host.read"

_on = False
_offset_ns = 0
_next_id = 1
_spans: List[tuple] = []
_counters: Dict[str, int] = {}
_open: List["_Span"] = []


class _Off:
    """The shared span of the recorder when it is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def at(self, start: Optional[float] = None,
           end: Optional[float] = None) -> None:
        pass


OFF = _Off()


def _now() -> int:
    return time.perf_counter_ns() + _offset_ns


def _new_id() -> int:
    global _next_id
    _next_id += 1
    return _next_id - 1


class _Span:
    __slots__ = ("name", "attrs", "start", "end", "span_id", "parent_id",
                 "trace_id", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end = None

    def __enter__(self):
        self.span_id = _new_id()
        if _open:
            self.parent_id, self.trace_id = _open[-1].span_id, _open[-1].trace_id
        else:
            self.parent_id, self.trace_id = None, f"{self.name}/{self.span_id}"
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        _open.append(self)
        self.start = _now()
        return self

    def at(self, start: Optional[float] = None,
           end: Optional[float] = None) -> None:
        """Take the span's start and end from the caller's own
        `time.perf_counter()` reads, so that a phase whose seconds the
        program keeps anyway is timed once."""
        if start is not None:
            self.start = round(start * 1e9) + _offset_ns
        if end is not None:
            self.end = round(end * 1e9) + _offset_ns

    def __exit__(self, *exc):
        if self.end is None:
            self.end = _now()
        _open.remove(self)
        self._range.__exit__(*exc)
        _spans.append((self.name, self.start, self.end, self.span_id,
                       self.parent_id, self.trace_id, self.attrs))
        return False


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn the recorder on, and pin its clock to the Unix epoch."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str, **attrs):
    """A context manager: a span of `name` while the recorder is on."""
    return _Span(name, attrs) if _on else OFF


def traced(name: str):
    """Run the decorated function inside a span of `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def read(site: str):
    """A `host.read` span around an existing device-to-host read at
    `site`, counted on `host.read/<site>`."""
    if not _on:
        return OFF
    count(f"{READ}/{site}")
    return _Span(READ, {"site": site})


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while the recorder is on."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def stamp() -> Optional[int]:
    """Now on the recorder's clock, or None while it is off."""
    return _now() if _on else None


def record(name: str, start_ns: int, end_ns: int, trace_id: str,
           **attrs) -> None:
    """Keep a span between two `stamp()`s taken in different calls (a
    query's wait in the serving queue): no parent, no profiler range."""
    if _on:
        _spans.append((name, start_ns, end_ns, _new_id(), None, trace_id,
                       attrs))


def snapshot(reset: bool = False) -> dict:
    """The closed spans and the counters so far; `reset=True` clears them."""
    spans = [{"name": s[0], "start_ns": s[1], "end_ns": s[2],
              "span_id": s[3], "parent_id": s[4], "trace_id": s[5],
              "attrs": dict(s[6])} for s in _spans]
    out = {"spans": spans, "counters": dict(_counters), "clock": "unix_ns"}
    if reset:
        _spans.clear()
        _counters.clear()
    return out
