"""Spans and counters of the port's own layers, kept in memory: the one
recorder of the process, which every layer reports into and the operator
reads (serve.py's GET /stats, utils/logging.py::trace).

    with span("serve.png"): ...                      # a layer's interval
    record("serve.queue_wait", t0_ns, t1_ns, at=a)   # one whose start was taken earlier
    count("text_cache.hit")                           # an integer counter
    gauge("graph.pool_bytes", n)                      # the latest value of a quantity

A span holds its name, its host start and end (`time.perf_counter_ns()`),
the index of its parent (the innermost span open on the same thread, or the
position `at` names: `here()` taken on another thread), the thread, a
request id (a span opened with `new_request=True` takes a fresh one, and the
spans under it inherit it) and its attrs. While the recorder is on, a span
also opens a `torch.profiler.record_function` range of its name, so under a
profiler it lies on the device trace's clock, and the device work launched
inside it can be told apart by the trace's correlation ids.

Counters always count: an integer add at a layer boundary costs nothing
beside the layer. Spans are kept only while the recorder is on
(`enable()`, `disable()`), at most `MAX_SPANS` of them; one past the bound
counts as dropped. `reset()` forgets the spans, the dropped count and the
counters (gauges describe the present and stay); `snapshot()` returns all
four.

Off, a span site costs the test of one module-level boolean and returns a
shared no-op context: no span object, no `record_function`, no CUDA event,
no synchronize. On, a span takes the host clock only and never
synchronizes; the device side comes from a profiler trace. No span opens
inside a CUDA stream capture: one captured once and replayed a thousand
times would lie.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch

MAX_SPANS = 100_000

_on = False
_cuda = False  # whether to ask if the current stream is capturing (a CPU build cannot)
_lock = threading.Lock()
_spans: list = []
_dropped = 0
_counters: dict = {}
_gauges: dict = {}
_local = threading.local()
_request_ids = itertools.count(1)


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int  # 0 while the span is open
    parent: int  # index of the enclosing span, -1 at the top
    thread: int
    request: int  # 0 outside any request
    attrs: dict


class _Null:
    """The context a span site gets while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _where(at: Optional[tuple]) -> tuple:
    """(parent index, request id) for a span opened here, or under `at`."""
    if at is not None:
        return at
    stack = _stack()
    return stack[-1] if stack else (-1, 0)


def _append(s: Span) -> tuple:
    """(the buffer s went into, its index there), index -1 when dropped."""
    global _dropped
    with _lock:
        if len(_spans) >= MAX_SPANS:
            _dropped += 1
            return _spans, -1
        _spans.append(s)
        return _spans, len(_spans) - 1


class _Open:
    __slots__ = ("name", "at", "new_request", "attrs", "buf", "index", "range")

    def __init__(self, name: str, at, new_request: bool, attrs: dict):
        self.name, self.at, self.new_request, self.attrs = name, at, new_request, attrs

    def __enter__(self):
        parent, request = _where(self.at)
        if self.new_request:
            request = next(_request_ids)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        s = Span(self.name, time.perf_counter_ns(), 0, parent, threading.get_ident(), request, self.attrs)
        self.buf, self.index = _append(s)
        _stack().append((self.index, request))
        return s

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        if self.index >= 0:  # a reset since the start left this span in a buffer no one reads
            self.buf[self.index].end_ns = end
        self.range.__exit__(*exc)
        return False


def span(name: str, *, at: Optional[tuple] = None, new_request: bool = False, **attrs):
    """A context manager recording `name` over its body (see the module
    docstring); `at` is a `here()` from the thread the work came from."""
    if not _on:
        return _NULL
    if _cuda and torch.cuda.is_current_stream_capturing():
        return _NULL
    return _Open(name, at, new_request, attrs)


def here() -> Optional[tuple]:
    """(index, request id) of the innermost span open on this thread, to
    hand to `span` or `record` on another thread; None while off."""
    if not _on:
        return None
    return _where(None)


def record(name: str, start_ns: int, end_ns: int, *, at: Optional[tuple] = None, **attrs) -> None:
    """A span whose start was taken earlier, e.g. a queued job's wait."""
    if not _on:
        return
    parent, request = _where(at)
    _append(Span(name, int(start_ns), int(end_ns), parent, threading.get_ident(), request, attrs))


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def gauge(name: str, value) -> None:
    _gauges[name] = value


def enable() -> None:
    global _on, _cuda
    _cuda = torch.cuda.is_available()
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    global _spans, _dropped
    with _lock:
        _spans, _dropped = [], 0
        _counters.clear()


def snapshot() -> dict:
    """{"spans": [Span], "counters": {name: int}, "gauges": {name: value},
    "dropped": int}: copies, except that a span still open gets its end
    later."""
    with _lock:
        return {"spans": list(_spans), "counters": dict(_counters), "gauges": dict(_gauges), "dropped": _dropped}
