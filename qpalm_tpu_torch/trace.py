"""Spans and counters at the layer boundaries of the port, kept in memory.

    trace.enable()
    ...                                  # the program runs
    rec = trace.drain()                  # rec.spans, rec.counters
    trace.disable()

A span is one interval of work on one thread: its name, start and end in
`time.time_ns()` (the clock `torch.profiler` stamps device events with,
so spans and device operations line up), the span that encloses it on the
same thread, the thread's identifier and a request id.  A span with no
request id given inherits its parent's; a span with neither starts a new
request.  Work done for a request on another thread (the batch pipeline's
rescue) names the request id it serves.  A counter is a named integer.

Tracing is off until `enable()`.  Off, `span()` tests one flag and returns
a shared object that does nothing: no clock is read and nothing is
allocated.  Spans mark layer boundaries and pieces of work of a
millisecond or more (a rescued lane's C solve), never a per-element or
per-launch loop.  Recording is safe from several threads.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

_on = False
_lock = threading.Lock()
_spans: list = []
_counters: dict = {}
# next() of an itertools.count is atomic under the interpreter lock
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    start: int               # time.time_ns()
    end: int
    id: int
    parent: Optional[int]    # the enclosing span's id on the same thread
    thread: int              # threading.get_ident()
    request: int


class Record(NamedTuple):
    spans: list              # Span, in the order they ended
    counters: dict           # name -> int


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "request", "id", "parent", "start")

    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else None
        if self.request is None:
            self.request = (stack[-1].request if stack
                            else next(_request_ids))
        self.id = next(_span_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        span = Span(self.name, self.start, end, self.id, self.parent,
                    threading.get_ident(), self.request)
        with _lock:
            _spans.append(span)
        return False


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until `drain()`."""
    global _on
    _on = False


def is_on() -> bool:
    """Whether spans and counters are being recorded: a caller whose count
    costs work (a read from the device) computes it only then."""
    return _on


def new_request() -> Optional[int]:
    """A fresh request id to hand to the spans of one request on several
    threads (None while tracing is off)."""
    return next(_request_ids) if _on else None


def span(name: str, request: Optional[int] = None):
    """A context manager timing its block as a span `name` (see the
    module's docstring for `request`)."""
    if not _on:
        return _OFF
    return _Open(name, request)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def drain() -> Record:
    """Everything recorded so far; the recorder is left empty."""
    with _lock:
        rec = Record(list(_spans), dict(_counters))
        _spans.clear()
        _counters.clear()
    return rec


def self_ns(span: Span, spans) -> int:
    """`span`'s duration less the part of it its child spans (those of
    `spans` whose parent it is) cover, each instant counted once."""
    kids = sorted((max(s.start, span.start), min(s.end, span.end))
                  for s in spans if s.parent == span.id)
    covered, edge = 0, span.start
    for s0, s1 in kids:
        s0 = max(s0, edge)
        if s1 > s0:
            covered += s1 - s0
            edge = s1
    return span.end - span.start - covered
